#!/usr/bin/env python3
"""Per-launch profile of the bf16 DSTD-GC backward kernels on one NVIDIA
GPU, for the A/B of kernel versions.

    python3 bwd_profile.py OUT_DIR [--tree DIR] [--label L]
                           [--modes temporal,spatial] [--build-only]

For the kernels of the port in ``--tree`` (default: this checkout; another
checkout's kernels are built in its own tree): the registers and spills of
every backward function (``nvcc -Xptxas -v``), its tensor-core ``HMMA``
count and instructions (``cuobjdump -sass``), and for each op of
``--modes`` at the bf16 training slice's batch
(``synthetic_h36m_tpu_train``, N = 128, T = 35, V = 22) and at each
(Ci, Co) of its 7 calls, both aggregations: the gradients against the
plain backward of the bf16 contract (the worst gradient's distance over
max(|plain|, 1), as ``chip_smoke.py`` phase 3 holds it at ``BF16_TOL``,
and the bf16-versus-float32 gap beside it), each gradient's and the plain
version's distance to the plain version in float64, whether two calls
give the same bits, and (the model's aggregation, right) the profiler's
device ms of each of the call's four launches.  The last line per op sums
the times over the 7 calls of one backward.  Nothing is asserted: a
variant that computes something else still reports its times, with ``ok``
false.

With ``--cases MODE[:TILE]`` it runs instead the card tests' bf16 tile
cases of that op (``tests/test_torch_cuda.py::BF16_TILE_CASES``, at one
tile if given, on the same inputs): per case the forward kernel's error
over the peak and each gradient's error over max(|plain|, 1) against the
plain contract, beside the card tests' bounds (their ``BF16_TOL``), and
each gradient's and the plain version's distance to float64.

Writes ``OUT_DIR/bwd_profile_<label>.jsonl`` (one line per check, one per
op's sum) and prints the same lines.  ``--build-only`` builds the
backward libraries and stops (to build several trees in parallel before
timing them one after another).
"""

import argparse
import importlib.util
import json
import os
import sys
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--modes", default="temporal,spatial")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    modes = args.modes.split(",")
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

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
    libs = [f"dstd_{mode}_bwd" for mode in modes]
    secs = build.build_all(libs)
    print(f"{label}: the port of {tree}; build {secs}", flush=True)
    # the nvcc log of a library this process did not build: the one saved
    # by the process that did
    os.makedirs(args.out_dir, exist_ok=True)
    logs = {}
    for name in libs:
        path = os.path.join(args.out_dir, f"build_{label}_{name}.log")
        logs[name] = build.build_log(name)
        if logs[name]:
            with open(path, "w") as f:
                f.write(logs[name])
        elif os.path.exists(path):
            with open(path) as f:
                logs[name] = f.read()
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
        for kernel, regs, stores, loads in cs.ptxas_usage(logs[name]):
            emit("ptxas", dict(kernel=kernel, registers=regs,
                               spill=[stores, loads],
                               hmma=sass.get(kernel, [None, None])))

    if args.cases:
        run_cases(cs, torch, np, fused, plain_bwd, args.cases, emit)
        out.close()
        return 0

    bcfg = resolve(configs.SYNTHETIC_H36M_TPU_TRAIN)
    n = bcfg["train_batch_size"]
    calls = Counter(cs.forward_shapes(bcfg["model"]["dstdgcn"]))
    bf16, T, V = torch.bfloat16, cs.T, cs.V
    for mode in modes:
        bwd = getattr(fused, f"dstd_{mode}_bwd")
        pbwd = getattr(plain_bwd, f"dstd_{mode}_bwd")
        total = dict.fromkeys(cs.BWD_PASSES, 0.0)
        worst = 0.0
        for (m, ci, co), count in sorted(calls.items()):
            if m != mode:
                continue
            a = cs.op_inputs(torch, np, mode, ci, co, device, seed=ci + co,
                             n=n)
            g = torch.randn((n, T, V, co), device=device, generator=torch
                            .Generator(device).manual_seed(ci * co))
            for agg in ("right", "left"):
                got = bwd(a[0], g, *a[1:], agg=agg, dtype=bf16)
                again = bwd(a[0], g, *a[1:], agg=agg, dtype=bf16)
                want = pbwd(a[0], g, *a[1:], agg=agg, dtype=bf16)
                want32 = pbwd(a[0], g, *a[1:], agg=agg)
                want64 = pbwd(*[t.double() for t in (a[0], g)],
                              *[t.double() for t in a[1:]], agg=agg,
                              dtype=bf16)
                norms = [max(float(b.abs().max()), 1.0) for b in want]
                errs = {key: float((x - y).abs().max()) / nrm
                        for key, x, y, nrm in zip(cs.GRADIENTS, got, want,
                                                  norms)}
                gap = max(float((y - z).abs().max()) / nrm
                          for y, z, nrm in zip(want, want32, norms))
                f64 = {}
                for key, x, y, z in zip(cs.GRADIENTS, got, want, want64):
                    nrm = max(float(z.abs().max()), 1.0)
                    f64[key] = [float((x.double() - z).abs().max()) / nrm,
                                float((y.double() - z).abs().max()) / nrm]
                err = max(errs.values())
                worst = max(worst, err)
                tol = cs.BF16_TOL["backward"]
                line = dict(mode=mode, ci=ci, co=co, n=n, agg=agg,
                            norm_err=err, worst=max(errs, key=errs.get),
                            tol=tol, bf16_vs_f32_gap=gap,
                            ok=err <= tol < gap / 2,
                            repeatable=all(bool(torch.equal(x, y))
                                           for x, y in zip(got, again)),
                            kernel_plain_vs_f64=f64)
                if agg == "right":
                    split = {}
                    ms, by = cs.device_ms(
                        torch, lambda: bwd(a[0], g, *a[1:], dtype=bf16), 10,
                        split)
                    line.update(ms=ms, launch_ms=split, timed_by=by,
                                calls=count)
                    for key, t in split.items():
                        total[key] += count * t
                emit("check", line)
        emit("sum", dict(mode=mode, n=n, calls=sum(
            c for (m, _, _), c in calls.items() if m == mode),
            launch_ms=total, ms=sum(total.values()), worst_norm_err=worst))
    out.close()
    print(cs.nvidia_smi())
    return 0


def run_cases(cs, torch, np, fused, plain_bwd, which, emit):
    """The card tests' bf16 tile cases of one op (``which``: MODE or
    MODE:TILE), errors only."""
    from dstdgcn_tpu_torch.ops import dstd as plain
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_cuda.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    mode, _, tile_only = which.partition(":")
    bf16, device = torch.bfloat16, torch.device("cuda")
    for case in ct.BF16_TILE_CASES:
        m, tile, n, t, v, cin, co, agg = case
        if m != mode or (tile_only and tile != int(tile_only)):
            continue
        a = ct._inputs(mode, n, t, v, cin, co, device, seed=1)
        g = torch.from_numpy(np.random.RandomState(2).randn(
            n, t, v, co).astype(np.float32)).to(device)
        got = getattr(fused, f"dstd_{mode}").launch(*a, agg=agg, dtype=bf16,
                                                    tile=tile)
        want = getattr(plain, f"kernel_{mode}")(*a, agg, bf16)
        fwd = float((got - want).abs().max()) / float(want.abs().max())
        bwd = getattr(fused, f"dstd_{mode}_bwd")
        grads = bwd(a[0], g, *a[1:], agg=agg, dtype=bf16, tile=tile)
        pbwd = getattr(plain_bwd, f"dstd_{mode}_bwd")
        gwant = pbwd(a[0], g, *a[1:], agg=agg, dtype=bf16)
        g64 = pbwd(*[x.double() for x in (a[0], g)],
                   *[x.double() for x in a[1:]], agg=agg, dtype=bf16)
        errs, f64 = {}, {}
        for key, x, y, z in zip(cs.GRADIENTS, grads, gwant, g64):
            errs[key] = float((x - y).abs().max()) / max(
                float(y.abs().max()), 1.0)
            nrm = max(float(z.abs().max()), 1.0)
            f64[key] = [float((x.double() - z).abs().max()) / nrm,
                        float((y.double() - z).abs().max()) / nrm]
        emit("case", dict(case=list(case), forward=fwd,
                          forward_ok=fwd <= ct.BF16_TOL["forward"],
                          backward=errs, worst=max(errs, key=errs.get),
                          backward_ok=max(errs.values())
                          <= ct.BF16_TOL["backward"],
                          kernel_plain_vs_f64=f64))


if __name__ == "__main__":
    sys.exit(main())
