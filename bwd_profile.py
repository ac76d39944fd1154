#!/usr/bin/env python3
"""Per-launch profile of the DSTD-GC backward (and, with ``--forward``,
forward) kernels on one NVIDIA GPU, for the A/B of kernel versions.

    python3 bwd_profile.py OUT_DIR [--tree DIR] [--label L]
                           [--modes temporal,spatial] [--dtype D]
                           [--tile K] [--forward]
                           [--chain [encoder|chain] [--layers L]
                                    [--tile K]]
                           [--sparse]
                           [--chain-grad [--draws D | --card-seeds]
                                         [--fault F]]
                           [--autograd-draws D [--fault F]]
                           [--cases MODE [--fault F]] [--build-only]

For the kernels of the port in ``--tree`` (default: this checkout; another
checkout's kernels are built in its own tree): the registers and spills of
every backward function (``nvcc -Xptxas -v``), its tensor-core ``HMMA``
count and instructions and its ``LDSM`` and ``LDS`` counts (``cuobjdump
-sass``), and for each op of
``--modes`` at its training slice's batch and at each (Ci, Co) of its 7
calls, both aggregations: with ``--dtype bfloat16`` (the default) the bf16
kernels of ``synthetic_h36m_tpu_train`` (N = 128), with ``--dtype
float32`` the float32 kernels of ``synthetic_h36m_train`` (N = 32); T = 35,
V = 22, or ``--shape T,V`` (CMU's 35,25, 3DPW's 40,23).  Per call: the
gradients against the plain backward of the same contract (the worst
gradient's distance over max(|plain|, 1), as ``chip_smoke.py`` phase 3
holds it: ``BF16_TOL`` at bf16, beside the
bf16-versus-float32 gap; ``TOL`` at float32), each gradient's and the
plain version's distance to the plain version in float64, whether two
calls give the same bits, and (the model's aggregation, right) the
profiler's device ms of each of the call's four launches.  The last line
per op sums the times over the 7 calls of one backward.  ``--tile`` sets
the backward's tile (default: the wrapper's).  Nothing is asserted: a
variant that computes something else still reports its times, with ``ok``
false.

With ``--forward`` the same for the forward kernels
(``dstd_{spatial,temporal}_{bf16,f32}``, one launch a call): the ptxas and
``HMMA`` lines of the forward functions and of the chain kernels
(``dstd_chain``, which share their tensor-core body), and per (Ci, Co)
and aggregation the kernel's float32 output (``FusedOp.launch``) against
the plain contract (``ops/dstd.py::kernel_spatial`` / ``kernel_temporal``
with the dtype; over the peak |plain float32 output|, as phase 3 holds
it), the kernel's and the plain contract's distance to the contract's
float64 run (``kernel_plain_vs_f64``), whether two calls give the same
bits, the device ms (agg right, on the x of the model's path: bf16 at
bf16) and, at bf16, the device ms of the casts around a call in the model
(``x.float()`` of a bf16 x, which a wrapper that reads x as float32 pays,
and the output's cast to bf16); the last line per op sums the 7 calls.

With ``--chain`` the whole-encoder kernel (``dstd_encoder_chain``, at
bf16 ``dstd_encoder_chain_bf16``) instead, or with ``--chain chain`` the
chain kernel (``dstd_chain``, ``dstd_chain_bf16``), one launch a call at
the fused slice's batch (N = 128 at bf16, 32 at float32) over
``--layers`` layers (default 5; seeded layers and x, the card tests'
``_chain_layers``), T = 35, V = 22, C = 64, both aggregations: the ptxas
and ``HMMA`` lines of the chain library, the error against its plain
version (``_encoder_oracle`` / ``_chain_oracle`` with the dtype) over the
peak |plain float32 output| beside the bf16-versus-float32 gap, whether
two calls give the same bits, and (agg right) the device ms of a call and
its bound.  ``--tile K`` launches it at tile K (a cluster of ceil(max(T,
V) / K) blocks, at most 8) instead of the wrapper's tile, and each line
gives the tile and its shared memory per block.

With ``--sparse`` the three block-sparse kernels (``block_spmm``,
``block_sddmm``, ``block_sddmm_spmm``: ``csrc/block_sparse.cu``) at the
large graph of ``chip_smoke.py::large_graph`` (N = 4, V = 4096, R = 4, C =
128, block 128): the ptxas and ``HMMA`` lines of the library, the
graph's active blocks per block row, and per kernel the error against its
plain version (max |kernel - plain| over max(|plain|, 1), as phase 8
holds it, within ``SPARSE_TOL``), whether two calls give the same bits,
the first 16 hex digits of the SHA-256 of its output's bytes (the SDDMM's
active blocks only: two trees whose kernel computes the same bits give
the same digest), the device ms of a call under the profiler and its bound
(``chip_smoke.py::sparse_cost``).  Beside another ``--tree`` in one call:
a removal variant of ``fwd_variants.py`` (``*_sp``) gives a phase's time.

With ``--cases MODE[:TILE]`` it runs instead the card tests' tile cases of
that op at the dtype (``tests/test_torch_cuda.py::TILE_CASES``, at one
tile if given, on the same inputs, through the card tests' own
``_tile_case``): per case each checked output's distance to the plain
contract, its and the plain version's distance to the float64 run of the
contract, its ratio by F4's rule (``_f4_ratio``) and, for a bf16 case at
a profile shape past F4's rule, by the flip-row rule (``_flip_rows``;
past 1 is refused), and whether the card test holds it.  ``--fault
dx_joint0`` zeroes the backward kernel's dx at joint 0 after each call,
``--fault dx_1pc`` scales it by 1.01, ``dx_05pc`` by 1.005, ``dx_bf16``
rounds it to bf16 once more (a lost-precision fault, at most 0.39% of
each element), ``out_joint0``, ``out_1pc``, ``out_05pc`` and
``out_bf16`` do the same to the forward
kernel's output (only that pass then runs, at either dtype): a broken
kernel the card test must refuse.  ``--cases
encoder`` runs the card tests' bf16 encoder-chain cases the same way
(``test_bf16_chain_kernels_match_plain`` at the encoder,
``ENCODER_EDGES``, through ``_bf16_chain_case``, held by
``chip_smoke.chain_held``), ``--cases chain`` those of ``dstd_chain``; an
``out_*`` fault applied to the kernel's output, ``f32_chain`` the float32
kernel called in the bf16 one's place (an error the size of the gap).

With ``--chain-grad`` the float32 chain-gradient card test
(``test_chain_gradient_replays_the_op_kernels``, through its
``_chain_grad_case``) over ``--draws`` seeded draws (seeds 1000, 1001,
...; with ``--card-seeds`` the card test's ``CHAIN_GRAD_SEEDS``), both
aggregations, for three gradient paths: the kernels; the same with the
plain forward ops (``ops/dstd.py``) in place of the forward kernels; the
same with the plain backward (``ops/dstd_bwd.py``) in place of the
backward kernels.  Per draw and path: the worst gradient's distance to
the plain float32 chain and to the plain chain's float64 run, the plain
chain's own distance to that run and the farthest of the rounded plain
chains' (``chip_smoke.rounded_chain``; each over 1e-4 max(|.|, 1): past 1
is past the bound), whether the rule of two orders (``_held`` over the
plain run on the card only, the rule before F7's repair) and the card
test's rule (``_held`` over the plain run and the rounded runs) hold
every gradient, and (the kernels) whether a second call gives the same
bits; the last line counts the draws past the bound and past each rule.
``--fault out_1pc`` or ``out_joint0`` alters the forward kernels' output
(both ops) after each call, and only the kernels' path runs: a broken
forward the rule must refuse (an accuracy fault: ``--tree`` a
``fwd_variants.py`` tree, ``tf32x1``).

With ``--autograd-draws D`` the bf16 autograd card test
(``test_bf16_autograd_through_the_kernels``, through its
``_bf16_autograd_case``) runs D times for each op in one process, on
the cotangents of seeds 0 .. D - 1; the last line per op counts the runs
that failed under the card test's rule (x's gradient by ``_held``) and
under the rule before F6's repair (x's gradient within ``BF16_TOL``),
and gives the first failures' numbers.  ``--fault dx_1pc`` or
``dx_joint0`` alters the backward kernel's dx: every draw must fail.

Writes ``OUT_DIR/bwd_profile_<label>.jsonl`` (one line per check, one per
op's sum) and prints the same lines.  ``--build-only`` builds the
profiled libraries and stops (to build several trees in parallel before
timing them one after another).
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))


def _zero_joint0(t):
    t = t.clone()
    t[:, :, 0, :] = 0
    return t


def _to_bf16(t):
    return t.bfloat16().float()


#: deliberate faults of ``--cases --fault``: how the backward kernel's dx
#: (``dx_*``) or the forward kernel's output (``out_*``) is altered after
#: each call
FAULTS = {"dx_joint0": _zero_joint0, "dx_1pc": lambda t: t * 1.01,
          "dx_05pc": lambda t: t * 1.005, "dx_bf16": _to_bf16,
          "out_joint0": _zero_joint0, "out_1pc": lambda t: t * 1.01,
          "out_05pc": lambda t: t * 1.005, "out_bf16": _to_bf16}
#: the bf16 chain cases' fault that is not an alteration of the output:
#: the float32 kernel in the bf16 one's place
F32_CHAIN = "f32_chain"


def shared_loads(cs, path):
    """{kernel: [LDSM, LDS]}: the ldmatrix and the plain shared-memory load
    instructions of each function in the SASS of the library at ``path``
    (``cuobjdump -sass``)."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += bool(re.search(r"\bLDSM\b", line))
            counts[name][1] += bool(re.search(r"\bLDS\b", line))
    return dict(zip(cs.demangle(list(counts)), counts.values()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--modes", default="temporal,spatial")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--shape", default=None,
                    help="T,V of the backward calls (default: H36M's)")
    ap.add_argument("--fault", default=None,
                    choices=tuple(FAULTS) + (F32_CHAIN,))
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--chain", nargs="?", const="encoder", default=None,
                    choices=("encoder", "chain"))
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--chain-grad", action="store_true")
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--card-seeds", action="store_true")
    ap.add_argument("--autograd-draws", type=int, default=0)
    ap.add_argument("--sparse", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    modes = args.modes.split(",")
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # the card tests import it: this checkout's, not the tree's
    sys.modules["chip_smoke"] = cs

    import numpy as np
    import torch
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import dstdgcn_tpu_torch
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.kernels import build, fused
    from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd
    from dstdgcn_tpu_torch.utils.config import resolve
    cs.check(os.path.dirname(dstdgcn_tpu_torch.__file__).startswith(tree),
             f"the port came from {dstdgcn_tpu_torch.__file__}, not {tree}")
    # the forward mode lists the chain kernels' SASS too: they share the
    # forward body of csrc/dstd_fwd_mma.cuh
    if args.sparse:
        libs = ["block_sparse"]
    elif args.chain or args.cases in ("encoder", "chain"):
        libs = ["dstd_chain"]
    elif args.autograd_draws:
        libs = ["dstd_spatial", "dstd_temporal", "dstd_spatial_bwd",
                "dstd_temporal_bwd"]
    elif args.chain_grad:
        libs = ["dstd_chain", "dstd_spatial", "dstd_temporal",
                "dstd_spatial_bwd", "dstd_temporal_bwd"]
    elif args.forward or (args.fault or "").startswith("out_"):
        libs = [f"dstd_{mode}" for mode in modes] + ["dstd_chain"]
    else:
        libs = [f"dstd_{mode}_bwd" for mode in modes]
    secs = build.build_all(libs)
    print(f"{label}: the port of {tree}; build {secs}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    logs = {name: build.build_log(name) for name in libs}
    for name, log in logs.items():
        if log:
            with open(os.path.join(args.out_dir,
                                   f"build_{label}_{name}.log"), "w") as f:
                f.write(log)
    if args.build_only:
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.nvidia_smi())
    out = open(os.path.join(args.out_dir, f"bwd_profile_{label}.jsonl"), "w")

    def emit(kind, line):
        line = dict(tree=label, kind=kind, **line)
        out.write(json.dumps(line) + "\n")
        print(f"{kind} " + json.dumps(line), flush=True)

    for name in libs:
        sass = cs.sass_mma(build.library(name)._name)
        lds = shared_loads(cs, build.library(name)._name)
        for kernel, regs, stores, loads in cs.ptxas_usage(logs[name]):
            emit("ptxas", dict(kernel=kernel, registers=regs,
                               spill=[stores, loads],
                               hmma=sass.get(kernel, [None, None]),
                               ldsm_lds=lds.get(kernel, [None, None])))

    if args.sparse:
        run_sparse(torch, np, cs, emit)
        out.close()
        print(cs.nvidia_smi())
        return 0
    if args.cases:
        run_cases(torch, fused, args.cases,
                  None if args.dtype == "float32" else torch.bfloat16,
                  args.fault, emit)
        out.close()
        return 0

    if args.autograd_draws:
        run_autograd_draws(torch, fused, args.autograd_draws, args.fault,
                           emit)
        out.close()
        return 0
    if args.chain_grad:
        ct = card_tests()
        seeds = (ct.CHAIN_GRAD_SEEDS if args.card_seeds
                 else range(1000, 1000 + args.draws))
        run_chain_grad(torch, fused, ct, seeds, args.fault, emit)
        out.close()
        return 0
    f32 = args.dtype == "float32"
    if args.chain:
        run_chain(torch, cs, fused, None if f32 else torch.bfloat16,
                  32 if f32 else 128, args.layers, args.chain == "encoder",
                  args.tile, emit)
        out.close()
        print(cs.nvidia_smi())
        return 0
    bcfg = resolve(configs.SYNTHETIC_H36M_TRAIN if f32
                   else configs.SYNTHETIC_H36M_TPU_TRAIN)
    n = bcfg["train_batch_size"]
    calls = Counter(cs.forward_shapes(bcfg["model"]["dstdgcn"]))
    dtype, T, V = (None if f32 else torch.bfloat16), cs.T, cs.V
    if args.shape:
        T, V = (int(x) for x in args.shape.split(","))
    if args.forward:
        run_forward(torch, np, cs, fused, modes, dtype, n, calls, args.tile,
                    emit)
        out.close()
        print(cs.nvidia_smi())
        return 0
    tol = cs.TOL if f32 else cs.BF16_TOL["backward"]
    for mode in modes:
        bwd = getattr(fused, f"dstd_{mode}_bwd")
        pbwd = getattr(plain_bwd, f"dstd_{mode}_bwd")
        total = dict.fromkeys(cs.BWD_PASSES, 0.0)
        worst = 0.0
        for (m, ci, co), count in sorted(calls.items()):
            if m != mode:
                continue
            a = cs.op_inputs(torch, np, mode, ci, co, device, seed=ci + co,
                             n=n, t=T, v=V)
            g = torch.randn((n, T, V, co), device=device, generator=torch
                            .Generator(device).manual_seed(ci * co))
            for agg in ("right", "left"):
                got = bwd(a[0], g, *a[1:], agg=agg, dtype=dtype,
                          tile=args.tile)
                again = bwd(a[0], g, *a[1:], agg=agg, dtype=dtype,
                            tile=args.tile)
                want = pbwd(a[0], g, *a[1:], agg=agg, dtype=dtype)
                want64 = pbwd(*[t.double() for t in (a[0], g)],
                              *[t.double() for t in a[1:]], agg=agg,
                              dtype=dtype)
                norms = [max(float(b.abs().max()), 1.0) for b in want]
                errs = {key: float((x - y).abs().max()) / nrm
                        for key, x, y, nrm in zip(cs.GRADIENTS, got, want,
                                                  norms)}
                f64 = {}
                for key, x, y, z in zip(cs.GRADIENTS, got, want, want64):
                    nrm = max(float(z.abs().max()), 1.0)
                    f64[key] = [float((x.double() - z).abs().max()) / nrm,
                                float((y.double() - z).abs().max()) / nrm]
                err = max(errs.values())
                worst = max(worst, err)
                line = dict(mode=mode, dtype=args.dtype, ci=ci, co=co, n=n,
                            t=T, v=V, agg=agg, tile=args.tile, norm_err=err,
                            worst=max(errs, key=errs.get), tol=tol,
                            ok=err <= tol,
                            repeatable=all(bool(torch.equal(x, y))
                                           for x, y in zip(got, again)),
                            kernel_plain_vs_f64=f64)
                if not f32:
                    want32 = pbwd(a[0], g, *a[1:], agg=agg)
                    gap = max(float((y - z).abs().max()) / nrm
                              for y, z, nrm in zip(want, want32, norms))
                    line.update(bf16_vs_f32_gap=gap, ok=err <= tol < gap / 2)
                if agg == "right":
                    split = {}
                    ms, by = cs.device_ms(
                        torch, lambda: bwd(a[0], g, *a[1:], dtype=dtype,
                                           tile=args.tile), 10, split)
                    line.update(ms=ms, launch_ms=split, timed_by=by,
                                calls=count)
                    for key, t in split.items():
                        total[key] += count * t
                emit("check", line)
        emit("sum", dict(mode=mode, dtype=args.dtype, n=n, t=T, v=V,
                         tile=args.tile,
                         calls=sum(c for (m, _, _), c in calls.items()
                                   if m == mode),
                         launch_ms=total, ms=sum(total.values()),
                         worst_norm_err=worst))
    out.close()
    print(cs.nvidia_smi())
    return 0


def run_forward(torch, np, cs, fused, modes, dtype, n, calls, tile, emit):
    """The forward kernels of ``modes`` at ``dtype`` and batch ``n``, at
    each (Ci, Co) of ``calls`` (the 7 calls of one forward), both
    aggregations: errors, repeat and (agg right) device ms, then each op's
    sum over its calls."""
    from dstdgcn_tpu_torch.ops import dstd as plain
    device = torch.device("cuda")
    bf16 = dtype is not None
    tol = cs.BF16_TOL["forward"] if bf16 else cs.TOL
    for mode in modes:
        op = getattr(fused, f"dstd_{mode}")
        kplain, fplain = (getattr(plain, f"kernel_{mode}"),
                          getattr(plain, f"dstd_{mode}"))
        total = casts = worst = 0.0
        for (m, ci, co), count in sorted(calls.items()):
            if m != mode:
                continue
            a = cs.op_inputs(torch, np, mode, ci, co, device, seed=ci + co,
                             n=n, t=T, v=V)
            for agg in ("right", "left"):
                with torch.no_grad():
                    got = op.launch(*a, agg=agg, dtype=dtype, tile=tile)
                    again = op.launch(*a, agg=agg, dtype=dtype, tile=tile)
                    want = kplain(*a, agg, dtype)
                    want64 = kplain(*[t.double() for t in a], agg, dtype)
                    want32 = fplain(*a, None, agg)
                peak = float(want32.abs().max())
                peak64 = float(want64.abs().max())
                err = float((got - want).abs().max()) / peak
                worst = max(worst, err)
                line = dict(
                    mode=mode, dtype=str(dtype), ci=ci, co=co, n=n,
                    agg=agg, tile=tile, norm_err=err, tol=tol,
                    ok=err <= tol,
                    repeatable=bool(torch.equal(got, again)),
                    kernel_plain_vs_f64=[
                        float((got.double() - want64).abs().max()) / peak64,
                        float((want.double() - want64).abs().max())
                        / peak64])
                if bf16:
                    gap = float((want - want32).abs().max()) / peak
                    line.update(bf16_vs_f32_gap=gap, ok=err <= tol < gap / 2)
                if agg == "right":
                    # timed on the x of the model's path (bf16 at bf16)
                    def call(a=a, x=a[0].to(dtype or torch.float32)):
                        with torch.no_grad():
                            return op.launch(x, *a[1:], dtype=dtype,
                                             tile=tile)
                    ms, by = cs.device_ms(torch, call, 20)
                    line.update(ms=ms, timed_by=by, calls=count)
                    total += count * ms
                    if bf16:
                        xb = a[0].to(dtype)
                        x_ms, _ = cs.device_ms(torch, lambda: xb.float(), 20)
                        o_ms, _ = cs.device_ms(torch,
                                               lambda: got.to(dtype), 20)
                        line.update(cast_ms=[x_ms, o_ms])
                        casts += count * (x_ms + o_ms)
                emit("check", line)
        emit("sum", dict(mode=mode, dtype=str(dtype), n=n, tile=tile,
                         forward=True,
                         calls=sum(c for (m, _, _), c in calls.items()
                                   if m == mode),
                         ms=total, cast_ms=casts, worst_norm_err=worst))


def card_tests():
    """The card tests' module (``tests/test_torch_cuda.py``), for its cases
    and helpers."""
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_cuda.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    return ct


def run_chain(torch, cs, fused, dtype, n, layers, encoder, tile, emit):
    """The whole-encoder kernel (``encoder``) or the chain kernel at
    ``dtype`` over ``layers`` seeded layers at batch ``n``, both
    aggregations, at ``tile`` (None: the wrapper's): error against its
    plain version and the bf16-versus-float32 gap, repeat, and (agg right)
    device ms."""
    from dstdgcn_tpu_torch.kernels import build
    ct = card_tests()
    device = torch.device("cuda")
    t, v, c = cs.T, cs.V, 64
    given = ct._chain_layers(layers, t, v, c, device, encoder=encoder,
                             seed=3)
    packed = fused.pack_chain(given)
    x = torch.randn(n, t, v, c, device=device,
                    generator=torch.Generator(device).manual_seed(n))
    kernel = fused.dstd_encoder_chain if encoder else fused.dstd_chain
    ref = fused._encoder_oracle if encoder else fused._chain_oracle
    # the wrapper's tile search, or the given tile in its place
    lib, variant = build.library("dstd_chain"), kernel._variant(dtype)
    shape = (t, v, c, packed.spatial[2].shape[1],
             packed.temporal[2].shape[1], packed.spatial[4].shape[-1])
    if tile:
        kernel._tiles[(variant, *shape)] = tile
    tile = kernel._tile(lib, variant, *shape)
    smem = getattr(lib, build.SMEM_BYTES[kernel.name, variant])(*shape,
                                                                tile)
    for agg in ("right", "left"):
        with torch.no_grad():
            got = kernel(x, packed, agg, dtype)
            again = kernel(x, packed, agg, dtype)
            want = ref(x, given, agg, dtype)
            want32 = ref(x, given, agg)
        peak = float(want32.abs().max())
        err = float((got - want).abs().max()) / peak
        line = dict(kernel=kernel.name, dtype=str(dtype), n=n,
                    layers=layers, agg=agg, tile=tile, smem_bytes=smem,
                    norm_err=err,
                    repeatable=bool(torch.equal(got, again)))
        if dtype is not None:
            gap = float((want - want32).abs().max()) / peak
            line.update(bf16_vs_f32_gap=gap, over_gap=err / gap,
                        ok=err <= cs.BF16_CHAIN_FRAC * gap)
        else:
            line.update(ok=err <= cs.TOL * max(peak, 1.0) / peak)
        if agg == "right":
            def call():
                with torch.no_grad():
                    return kernel(x, packed, agg, dtype)
            ms, by = cs.device_ms(torch, call, 10)
            b_ms, t_ops, t_mem = cs.bound_of(*cs.chain_cost(
                n, c, layers, encoder, dtype))
            line.update(ms=ms, timed_by=by, bound_ms=b_ms,
                        bound_by="operations" if t_ops >= t_mem
                        else "bytes")
        emit("check", line)


def run_sparse(torch, np, cs, emit):
    """The three block-sparse kernels at the large graph: errors against
    their plain versions, repeat, device ms and bound."""
    from dstdgcn_tpu_torch.kernels import sparse
    device = torch.device("cuda")
    rows, cols, arrs = cs.large_graph(np, sparse)
    n, v, r, c, block = (cs.SPARSE_N, cs.SPARSE_V, cs.SPARSE_R, cs.SPARSE_C,
                         cs.SPARSE_BLOCK)
    q, k, w, x = (torch.from_numpy(arrs[key]).to(device) for key in "qkwx")
    adj = torch.randn((n, v, v), device=device,
                      generator=torch.Generator(device).manual_seed(3))
    m = sparse.pattern(rows, cols, block, v, v).mask(device)
    per_row = np.bincount(rows)
    emit("graph", dict(n=n, v=v, r=r, c=c, block=block,
                       active=len(rows), blocks=(v // block) ** 2,
                       per_row=dict(min=int(per_row.min()),
                                    max=int(per_row.max()),
                                    mean=float(per_row.mean())),
                       per_row_counts=per_row.tolist()))
    pat = (rows, cols, block)
    ops = {
        "block_spmm": (lambda: sparse.block_spmm(adj, x, *pat),
                       lambda: sparse.spmm_dense(adj * m, x)),
        "block_sddmm": (lambda: sparse.block_sddmm(q, k, w, *pat),
                        lambda: sparse.sddmm_dense(q, k, w, m)),
        "block_sddmm_spmm": (lambda: sparse.block_sddmm_spmm(q, k, w, x,
                                                              *pat),
                             lambda: sparse.sddmm_spmm_dense(q, k, w, x, m)),
    }
    with torch.no_grad():
        for name, (kernel, plain) in ops.items():
            got, again, want = kernel(), kernel(), plain()
            if name == "block_sddmm":
                # inactive blocks are undefined: active blocks only
                sel = m.bool().expand_as(want)
                got, again, want = got[sel], again[sel], want[sel]
            err, rel = cs.norm_err(got, want)
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            ms, by = cs.device_ms(torch, kernel, 50)
            b_ms, t_ops, t_mem = cs.bound_of(*cs.sparse_cost(
                name, n, len(rows), block, r, c, v))
            emit("check", dict(kernel=name, max_abs_err=err, norm_err=rel,
                               tol=cs.SPARSE_TOL[name],
                               ok=rel <= cs.SPARSE_TOL[name],
                               repeatable=bool(torch.equal(got, again)),
                               sha256=digest[:16],
                               ms=ms, timed_by=by, bound_ms=b_ms,
                               bound_by="operations" if t_ops >= t_mem
                               else "bytes"))
            del got, again, want


def run_autograd_draws(torch, fused, draws, fault, emit):
    """The bf16 autograd card test on the cotangents of seeds 0 ..
    ``draws`` - 1 for each op, with an optional ``dx_*`` fault of the
    backward kernel (module docstring)."""
    ct = card_tests()
    device = torch.device("cuda")
    bf16 = torch.bfloat16
    for mode in ("temporal", "spatial"):
        real = getattr(fused, f"dstd_{mode}_bwd")
        bwd = None
        if fault:
            def bwd(*a, real=real, **k):
                out = list(real(*a, **k))
                out[0] = FAULTS[fault](out[0])
                return tuple(out)
        failed, failed_before, worst = [], 0, []
        for seed in range(draws):
            counts, typed, dx, rest = ct._bf16_autograd_case(mode, seed,
                                                             device, bwd)
            ok = (typed and ct._held(bf16, "backward", *dx)
                  and max(rest) <= ct.BF16_TOL["backward"]
                  and counts[f"dstd_{mode}_bf16"] == 1)
            failed_before += not (dx[0] <= ct.BF16_TOL["backward"]
                                  and max(rest) <= ct.BF16_TOL["backward"])
            bound = max(ct.BF16_TOL["backward"],
                        ct.F64_NOISE * max(dx[2:]))
            worst.append(dx[1] / bound)
            if not ok:
                failed.append(dict(seed=seed, dx=list(dx),
                                   weights=max(rest)))
        emit("sum", dict(mode=mode, draws=draws, fault=fault,
                         failed=len(failed), failed_two_orders=failed_before,
                         kernel64_over_bound=[min(worst), max(worst)],
                         first=failed[:5]))


def run_chain_grad(torch, fused, ct, seeds, fault, emit):
    """The card test's float32 chain gradient over seeded draws, for the
    kernels and with the plain forward or the plain backward in their
    place, or with a broken forward (module docstring)."""
    from dstdgcn_tpu_torch.ops import dstd as plain
    from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd
    device = torch.device("cuda")
    ops = (fused.dstd_spatial, fused.dstd_temporal)
    kept = [(op.launch, op.bwd) for op in ops]

    def plain_launch(fn):
        def launch(x, *w, agg="right", dtype=None, tile=None):
            # contiguous, as the kernel's output (the next op's backward
            # kernel reads it as its saved input)
            return fn(x, *w, None, agg).contiguous()
        return launch

    def plain_backward(fn):
        def bwd(x, g, *w, agg="right", dtype=None):
            return fn(x, g, *w, agg=agg, dtype=dtype)
        return bwd

    def faulty(launch):
        def run(*a, **k):
            return FAULTS[fault](launch(*a, **k))
        return run

    def path(name):
        for op, (launch, bwd) in zip(ops, kept):
            op.launch, op.bwd = launch, bwd
        for op, mode in zip(ops, ("spatial", "temporal")):
            if name == "plain_forward":
                op.launch = plain_launch(getattr(plain, f"dstd_{mode}"))
            if name == "plain_backward":
                op.bwd = plain_backward(getattr(plain_bwd,
                                                f"dstd_{mode}_bwd"))
            if name == "fault":
                op.launch = faulty(op.launch)

    names = (("fault",) if fault else
             ("kernels", "plain_forward", "plain_backward"))
    past, count = {}, 0
    try:
        for seed in seeds:
            for agg in ("right", "left"):
                count += 1
                refs = {}
                for name in names:
                    path(name)
                    rows, _, got = ct._chain_grad_case(agg, seed, device,
                                                       cpu=False, refs=refs)
                    again = got
                    if name == "kernels":
                        _, _, again = ct._chain_grad_case(
                            agg, seed, device, cpu=False, refs=refs)
                    worst = [max(r[i] for r in rows) / 1e-4
                             for i in range(3)]
                    rounded = max(max(r[4:]) for r in rows) / 1e-4
                    two = all(ct._held(None, "gradient", *r[:4])
                              for r in rows)
                    held = all(ct._held(None, "gradient", *r) for r in rows)
                    emit("draw", dict(seed=seed, agg=agg, path=name,
                                      fault=fault, to_plain=worst[0],
                                      to_f64=worst[1],
                                      plain_to_f64=worst[2],
                                      rounded_to_f64=rounded,
                                      held_two_orders=two, held=held,
                                      repeatable=all(
                                          torch.equal(a, b)
                                          for a, b in zip(got, again))))
                    n = past.setdefault(name, dict(bound=0, two_orders=0,
                                                   rule=0))
                    n["bound"] += worst[0] > 1.0
                    n["two_orders"] += not two
                    n["rule"] += not held
    finally:
        path("kernels")
    emit("sum", dict(draws=count, fault=fault, past=past))


def run_cases(torch, fused, which, dtype, fault, emit):
    """The card tests' tile cases of one op (``which``: MODE or
    MODE:TILE) at ``dtype``, through the card tests' ``_tile_case``, or
    (``which`` = ``encoder``) their bf16 encoder-chain cases through
    ``_bf16_chain_case``; ``fault`` alters the backward kernel's dx
    (``dx_*``) or the forward kernel's output (``out_*``) after each
    call, and only that pass runs."""
    ct = card_tests()
    if which in ("encoder", "chain"):
        run_chain_cases(torch, fused, ct, which, fault, emit)
        return
    mode, _, tile_only = which.partition(":")
    bwd = real = getattr(fused, f"dstd_{mode}_bwd")
    fwd = real_fwd = getattr(fused, f"dstd_{mode}").launch
    if fault and fault.startswith("dx_"):
        def bwd(*a, **k):
            out = list(real(*a, **k))
            out[0] = FAULTS[fault](out[0])
            return tuple(out)
    elif fault:
        def fwd(*a, **k):
            return FAULTS[fault](real_fwd(*a, **k))

    passes = (("forward",) if fault and fault.startswith("out_") else
              ("backward",) if fault else ("forward", "backward"))
    device = torch.device("cuda")
    for case in ct.TILE_CASES:
        if case[0] != mode or (tile_only and case[1] != int(tile_only)):
            continue
        if dtype is None:
            held, repeat = ct._tile_case(*case, device, dtype, bwd, fwd,
                                         passes)
            ok = {key: ct._held(dtype, key, *d) for key, d in held.items()}
            rows = {}
        else:       # the card test's rule, with F9's flip-row rule
            ok, repeat, held, rows = ct._bf16_tile_held(case, device, bwd,
                                                        fwd, passes)
        emit("case", dict(case=list(case), dtype=str(dtype), fault=fault,
                          held={key: list(d) + [ct._f4_ratio(dtype, key, *d),
                                                rows.get(key), ok[key]]
                                for key, d in held.items()},
                          ok=all(ok.values()), repeatable=repeat))



def run_chain_cases(torch, fused, ct, which, fault, emit):
    """The card tests' bf16 chain cases of the encoder kernel (``which``
    ``encoder``) or of ``dstd_chain`` (N = 1 and 128 at the H36M shape,
    then ``ENCODER_EDGES``), both aggregations, held by
    ``chip_smoke.chain_held``, with an ``out_*`` fault applied to the
    kernel's output after each call, or (``f32_chain``) the float32 kernel
    in the bf16 one's place."""
    import chip_smoke as cs
    encoder = which == "encoder"
    kernel = fused.dstd_encoder_chain if encoder else fused.dstd_chain
    call = None
    if fault == F32_CHAIN:
        def call(x, given, agg, dtype=None):
            return kernel(x, given, agg)
    elif fault:
        def call(*a, **k):
            return FAULTS[fault](kernel(*a, **k))
    device = torch.device("cuda")
    shapes = [(n, 35, 22, 64) for n in (1, 128)] + ct.ENCODER_EDGES
    for shape in shapes:
        for agg in ("right", "left"):
            out, same = ct._bf16_chain_case(encoder, agg, *shape, device,
                                            call)
            emit("case", dict(case=[which, agg, *shape], fault=fault,
                              held={key: list(d) + [cs.chain_held(*d)]
                                    for key, d in out.items()},
                              ok=same and all(cs.chain_held(*d)
                                              for d in out.values())))


if __name__ == "__main__":
    sys.exit(main())
