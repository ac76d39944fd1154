#!/usr/bin/env python3
"""Removal variants of the DSTD-GC forward bodies, for a split of a
kernel's time by phase.

    python3 fwd_variants.py OUT_ROOT [--tree DIR] [--only NAME,...]

Copies the port (``dstdgcn_tpu_torch/``) of ``--tree`` (default: this
checkout) into ``OUT_ROOT/<variant>/`` once per variant and removes one
phase from its CUDA sources by a text substitution that must match
exactly once (the script fails otherwise, so a variant never silently
times the unchanged code).  Time each tree with ``bwd_profile.py --tree
OUT_ROOT/<variant> --forward`` (or ``--chain``) in one chip call beside
the tree it came from; the difference of two times is the removed phase's.

Variants of the CUDA-core op body ``dstd::spatial_op``
(``csrc/dstd_common.cuh``), the spatial body of the float32 chain kernel
``dstd_chain_f32`` (and of the float32 spatial kernel, the float32
encoder and the bf16 chain before their tensor-core redesigns):

- ``notanh``: the score is q - k, no ``tanhf``;
- ``nomix``: one add per score instead of the mixing FMAs of the tile;
- ``noadj``: no adjacency loop (scores, mixing, affine);
- ``nofeat``: no feature projection;
- ``noagg``: no aggregation;
- ``qkonly``: the last three removed (staging, q/k, syncs remain).

The same six of the CUDA-core temporal body ``dstd::temporal_op`` (the
temporal body of the float32 chain kernel ``dstd_chain_f32``, and of the
float32 temporal kernel, the float32 encoder and the bf16 chain before
their tensor-core redesigns), named with a ``_t``: ``notanh_t``, ``nomix_t``,
``noadj_t``, ``nofeat_t``, ``noagg_t``, ``qkonly_t``.

Variants of the whole-encoder kernel (``csrc/dstd_chain.cu``, the encoder
instantiations ``chain_kernel<*, true, *>``, both dtypes):
``nospatial_mma`` and ``notemporal_mma`` skip that op's tensor-core body
(``dstd_fwd::op_mma``) in every layer (its output buffer is then left as
it was).  Variants change what the kernel computes: their errors mean
nothing, only their times.

An accuracy fault of the float32 forward body on 3xTF32: ``tf32x1`` runs
the product of ``dstd_mma::Tf32x3Mma::mma_bits`` (``csrc/dstd_mma.cuh``;
the float32 encoder's, and the float32 one-op forward kernels' in a tree
where they run 3xTF32) without its two correction products (a.small x
big, a.big x small): one TF32 product, about 2^-11 relative, the fault
the float32 checks must refuse.
"""

import argparse
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_TANH = "const float sc = tanhf(qr[s * V] - kr[s * V]);"
_MIX = """        const float sc = tanhf(qr[s * V] - kr[s * V]);
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 m = wm[s * (TP / 4) + q];
          if (4 * q + 0 < TILE) acc[4 * q + 0] = fmaf(sc, m.x, acc[4 * q + 0]);
          if (4 * q + 1 < TILE) acc[4 * q + 1] = fmaf(sc, m.y, acc[4 * q + 1]);
          if (4 * q + 2 < TILE) acc[4 * q + 2] = fmaf(sc, m.z, acc[4 * q + 2]);
          if (4 * q + 3 < TILE) acc[4 * q + 3] = fmaf(sc, m.w, acc[4 * q + 3]);
        }"""
_ADJ = "for (int p = threadIdx.x; tn > 0 && p < K * VV; p += blockDim.x) {"
_FEAT = """  project_features(
      a, xn, xf, rows, TILE * V * Co,"""
_AGG4 = """    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int row = i / C4, c4 = i - row * C4;
      const int tt = row / V, av = row - tt * V;"""
_AGG1 = """    for (int i = threadIdx.x; i < rows * Co; i += blockDim.x) {
      const int row = i / Co, c = i - row * Co;
      const int tt = row / V, av = row - tt * V;"""
# the same phases of the CUDA-core temporal body dstd::temporal_op
_TANH_T = "const float sc = tanhf(qr[v * T] - kr[v * T]);"
_MIX_T = _MIX.replace("qr[s * V] - kr[s * V]", "qr[v * T] - kr[v * T]") \
    .replace("wm[s * (TP / 4) + q]", "wm[v * (TP / 4) + q]")
_ADJ_T = "for (int p = threadIdx.x; wn > 0 && p < K * TT; p += blockDim.x) {"
_FEAT_T = """  project_features(
      a, xn, xf, rows, T * TILE * Co,"""
_AGG4_T = """    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int row = i / C4, c4 = i - row * C4;
      const int at = row / wn, j = row - at * wn;"""
_AGG1_T = """    for (int i = threadIdx.x; i < rows * Co; i += blockDim.x) {
      const int row = i / Co, c = i - row * Co;
      const int at = row / wn, j = row - at * wn;"""
# the encoder's op calls in chain_kernel (the tensor-core body of both
# dtypes)
_MMA_SPATIAL = "dstd_fwd::op_mma<true, MmaOf<Rnd>, true>("
_MMA_TEMPORAL = "dstd_fwd::op_mma<false, MmaOf<Rnd>, true>("
# the forward's 3xTF32 product from fragment registers
_TF32X3 = """    mma_tf32(d, a.small, big);
    mma_tf32(d, a.big, small);
    mma_tf32(d, a.big, big);"""
_COMMON = "dstdgcn_tpu_torch/csrc/dstd_common.cuh"
_MMA = "dstdgcn_tpu_torch/csrc/dstd_mma.cuh"
_CHAIN = "dstdgcn_tpu_torch/csrc/dstd_chain.cu"


def _off(loop):
    """A for loop whose condition is made false."""
    head, _, rest = loop.partition("; ")
    return f"{head}; false && {rest}"


_REMOVE = {
    "noadj": [(_COMMON, _ADJ, _off(_ADJ))],
    "nofeat": [(_COMMON, _FEAT, "  if (false)\n" + _FEAT)],
    "noagg": [(_COMMON, _AGG4, _off(_AGG4)),
              (_COMMON, _AGG1, _off(_AGG1))],
    "noadj_t": [(_COMMON, _ADJ_T, _off(_ADJ_T))],
    "nofeat_t": [(_COMMON, _FEAT_T, "  if (false)\n" + _FEAT_T)],
    "noagg_t": [(_COMMON, _AGG4_T, _off(_AGG4_T)),
                (_COMMON, _AGG1_T, _off(_AGG1_T))],
}
#: variant -> [(file, text, replacement)]
VARIANTS = {
    "notanh": [(_COMMON, _TANH, _TANH.replace("tanhf(", "("))],
    "nomix": [(_COMMON, _MIX, _MIX.split("\n")[0] + "\n        acc[0] += sc;")],
    **_REMOVE,
    "qkonly": [edit for name in ("noadj", "nofeat", "noagg")
               for edit in _REMOVE[name]],
    "notanh_t": [(_COMMON, _TANH_T, _TANH_T.replace("tanhf(", "("))],
    "nomix_t": [(_COMMON, _MIX_T,
                 _MIX_T.split("\n")[0] + "\n        acc[0] += sc;")],
    "qkonly_t": [edit for name in ("noadj_t", "nofeat_t", "noagg_t")
                 for edit in _REMOVE[name]],
    "nospatial_mma": [(_CHAIN, _MMA_SPATIAL, "if (false) " + _MMA_SPATIAL)],
    "notemporal_mma": [(_CHAIN, _MMA_TEMPORAL,
                        "if (false) " + _MMA_TEMPORAL)],
    "tf32x1": [(_MMA, _TF32X3, _TF32X3.split("\n")[-1])],
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
