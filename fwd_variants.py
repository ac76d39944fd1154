#!/usr/bin/env python3
"""Removal variants of the DSTD-GC forward bodies and of the block-sparse
kernels, for a split of a kernel's time by phase.

    python3 fwd_variants.py OUT_ROOT [--tree DIR] [--only NAME,...]

Copies the port (``dstdgcn_tpu_torch/``) of ``--tree`` (default: this
checkout) into ``OUT_ROOT/<variant>/`` once per variant and removes one
phase from its CUDA sources by a text substitution that must match
exactly once (the script fails otherwise, so a variant never silently
times the unchanged code).  Time each tree with ``bwd_profile.py --tree
OUT_ROOT/<variant> --chain`` (or ``--sparse``) in one chip call beside
the tree it came from; the difference of two times is the removed
phase's.

Variants of the chain kernels (``csrc/dstd_chain.cu``, both dtypes):
``nospatial_mma`` and ``notemporal_mma`` skip that op's tensor-core body
(``dstd_fwd::op_mma``) in every layer of the whole-encoder kernel
(``chain_kernel<*, true, *>``), ``nospatial_mma_chain`` and
``notemporal_mma_chain`` in every layer of the chain kernel
(``chain_kernel<*, false, *>``); the op's output buffer is then left as it
was.  Variants change what the kernel computes: their errors mean
nothing, only their times.

Variants of the block-sparse kernels (``csrc/block_sparse.cu``; each
changes the code of the kernels ``SPARSE_KERNELS`` names for it and of no
other, by the sections of ``SPARSE_SECTIONS``).  Of the fused SDDMM + SpMM
kernel (``sddmm_spmm_kernel``): ``notanh_sp``, the score is ``w[r] * (q -
k)``, no ``tanhf``; ``noscore_sp``, the score tile is a constant (no score
is formed); ``noproduct_sp``, no products of the score tile with the x
tile.  Of the SpMM (``spmm_kernel``): ``noproduct_spmm``, the tiles are
loaded, split and synced but not multiplied (one read of each tile a
thread keeps its stores live); ``noload_spmm``, the products run on tiles
that are never reloaded (the loads of later steps sit behind a condition
that never holds at run time, ``C < 0``, so the compiler keeps the tiles'
memory).  Of the SDDMM (``sddmm_kernel``): ``notanh_sddmm``, the score is
``w[r] * (q - k)``, no ``tanhf``.  And the accuracy fault of the 3xTF32
product that the SpMM and the fused kernel share (``tc::product``):
``tf32x1_sp`` runs each product as one TF32 product (big x big) without
the two correction products, the fault phase 8 and the card tests should
refuse in both kernels.

An accuracy fault of the float32 forward body on 3xTF32: ``tf32x1`` runs
the product of ``dstd_mma::Tf32x3Mma::mma_bits`` (``csrc/dstd_mma.cuh``;
the float32 encoder's and chain's) without its two correction products
(a.small x big, a.big x small): one TF32 product, about 2^-11 relative,
the fault the float32 checks must refuse.
"""

import argparse
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# the op calls in chain_kernel (the tensor-core body of both dtypes), each
# named by its store: the encoder's epilogue or the chain's plain store
_MMA_SPATIAL = """dstd_fwd::op_mma<true, MmaOf<Rnd>, true>(
          sa, bytes, n, t0, tn, c.ts, nblk,
          LayerStore<true>"""
_MMA_TEMPORAL = """dstd_fwd::op_mma<false, MmaOf<Rnd>, true>(
          ta, bytes, n, w0, wn, c.tt, nblk,
          LayerStore<false>"""
_MMA_SPATIAL_CHAIN = """dstd_fwd::op_mma<true, MmaOf<Rnd>, true>(
          sa, bytes, n, t0, tn, c.ts, nblk,
          dstd_fwd::PairStore{c.mid"""
_MMA_TEMPORAL_CHAIN = """dstd_fwd::op_mma<false, MmaOf<Rnd>, true>(
          ta, bytes, n, w0, wn, c.tt, nblk,
          dstd_fwd::PairStore{out"""
# the forward's 3xTF32 product from fragment registers
_TF32X3 = """    mma_tf32(d, a.small, big);
    mma_tf32(d, a.big, small);
    mma_tf32(d, a.big, big);"""
# the fused sparse kernel's phases and its 3xTF32 product
_SP_TANH = "tanhf(qr[i * R + ru[u]] - kv[u])"
_SP_SCORE = "if (src >= 0 && w0 < nrows) {"
_SP_PRODUCT = "if (live) products(acc, sb, ss, "
_SP_TF32X3 = """  dstd_mma::mma_tf32(d, as, bb);
  dstd_mma::mma_tf32(d, ab, bs);
  dstd_mma::mma_tf32(d, ab, bb);"""
# the SpMM's products and its loads of later steps; the SDDMM's tanh
_SPMM_PRODUCT = "if (live) products(acc, big, rest, xt);"
_SPMM_READ = ("if (live) acc[0][0][0] += big[threadIdx.x] + rest[threadIdx.x] "
              "+ xt[threadIdx.x];")
_SPMM_LOADS = "if (s + kStages - 1 < hi)"
_SDDMM_TANH = "tanhf(qr[i] - kc[u])"
_MMA = "dstdgcn_tpu_torch/csrc/dstd_mma.cuh"
_CHAIN = "dstdgcn_tpu_torch/csrc/dstd_chain.cu"
_SPARSE = "dstdgcn_tpu_torch/csrc/block_sparse.cu"
#: the sections of block_sparse.cu in order, each from its marker to the
#: next one's (exclusive; the last to ``SPARSE_END``), with the kernels
#: that run its code; the text outside them is run by no kernel
SPARSE_SECTIONS = (
    ("namespace tc {", ("spmm_kernel", "sddmm_spmm_kernel")),
    ("namespace spmm {", ("spmm_kernel",)),
    ("namespace sddmm {", ("sddmm_kernel",)),
    ("namespace fused {", ("sddmm_spmm_kernel",)),
)
SPARSE_END = "bool grid_ok("


def _skip(call):
    """A call statement that never runs."""
    return "if (false) " + call


#: variant -> [(file, text, replacement)]
VARIANTS = {
    "nospatial_mma": [(_CHAIN, _MMA_SPATIAL, _skip(_MMA_SPATIAL))],
    "notemporal_mma": [(_CHAIN, _MMA_TEMPORAL, _skip(_MMA_TEMPORAL))],
    "nospatial_mma_chain": [(_CHAIN, _MMA_SPATIAL_CHAIN,
                             _skip(_MMA_SPATIAL_CHAIN))],
    "notemporal_mma_chain": [(_CHAIN, _MMA_TEMPORAL_CHAIN,
                              _skip(_MMA_TEMPORAL_CHAIN))],
    "tf32x1": [(_MMA, _TF32X3, _TF32X3.split("\n")[-1])],
    "notanh_sp": [(_SPARSE, _SP_TANH, _SP_TANH.replace("tanhf(", "("))],
    "noscore_sp": [(_SPARSE, _SP_SCORE, "if (false) {")],
    "noproduct_sp": [(_SPARSE, _SP_PRODUCT,
                      _SP_PRODUCT.replace("if (live)", "if (false)"))],
    "tf32x1_sp": [(_SPARSE, _SP_TF32X3, _SP_TF32X3.split("\n")[-1])],
    "noproduct_spmm": [(_SPARSE, _SPMM_PRODUCT, _SPMM_READ)],
    "noload_spmm": [(_SPARSE, _SPMM_LOADS, "if (C < 0)")],
    "notanh_sddmm": [(_SPARSE, _SDDMM_TANH,
                      _SDDMM_TANH.replace("tanhf(", "("))],
}
#: the variants of the block-sparse kernels and the kernels each changes
SPARSE_KERNELS = {
    "notanh_sp": ("sddmm_spmm_kernel",),
    "noscore_sp": ("sddmm_spmm_kernel",),
    "noproduct_sp": ("sddmm_spmm_kernel",),
    "tf32x1_sp": ("spmm_kernel", "sddmm_spmm_kernel"),
    "noproduct_spmm": ("spmm_kernel",),
    "noload_spmm": ("spmm_kernel",),
    "notanh_sddmm": ("sddmm_kernel",),
}


def make(tree, out_root, name):
    """OUT_ROOT/name/dstdgcn_tpu_torch: the tree's port with the variant's
    substitutions applied (each must match exactly once)."""
    dst = os.path.join(out_root, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "dstdgcn_tpu_torch"),
                    os.path.join(dst, "dstdgcn_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(dst, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {rel} holds the text to replace "
                             f"{text.count(old)} times, not once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--only", default=",".join(VARIANTS))
    args = ap.parse_args()
    for name in args.only.split(","):
        print(make(os.path.abspath(args.tree), args.out_root, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
