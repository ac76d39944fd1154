#!/usr/bin/env python3
"""The noise of ``chip_smoke.py``'s bf16 train-step check (phase 9), on one
NVIDIA GPU.

    python3 step_noise.py OUT_DIR [--tree DIR] [--slice-state] [--faults]

For the kernels of the port in ``--tree`` (default: this checkout; another
checkout's kernels are built in its own tree), at several weight states,
the step check's numbers (``chip_smoke.step_errors``) and its judgement
(``chip_smoke.step_verdict``): how far the kernel path's gradients lie from
the plain path's float64 run, against the plain path's own distance.  So
the check's bound (``chip_smoke.BF16_STEP_NOISE``) can be read against
right kernels at many states and against kernel paths with a fault.

States: the weights the plain path of the bf16 contract reaches in 2, 4,
8, 16 and 32 train steps from the bf16 slice's seeded initial weights
(``synthetic_h36m_tpu_train``, the batches in turn); with
``--slice-state``, the weights the slice trains with the kernels (phase 9's
``main.run``, then its timing steps), saved to ``OUT_DIR/slice_state.pt``,
which a later run (another tree's kernels) reads.  With ``--faults``, the
kernel path again at each state with one output of the bf16 spatial
backward altered after its kernel: a gradient scaled by 1 + 2^-8 (one bf16
step) or by 1.01, dalpha by 1.1, or dx of joint 0 set to 0.

Writes ``OUT_DIR/step_noise_<label>.jsonl`` (one line per state and fault:
the losses and every parameter's four distances) and prints per line the
two groups' kernel-over-plain ratios of the mean distance (the check's)
and of the largest.
"""

import argparse
import copy
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = (2, 4, 8, 16, 32)


def faults(torch):
    """{name: (output index of the backward's 11, how it is altered)}."""
    def zero_joint(t):
        t = t.clone()
        t[:, :, 0, :] = 0
        return t

    return {"dwf_step": (3, lambda t: t * (1 + 2 ** -8)),
            "dwf_1pc": (3, lambda t: t * 1.01),
            "dx_step": (0, lambda t: t * (1 + 2 ** -8)),
            "dwrm_1pc": (9, lambda t: t * 1.01),
            "dalpha_10pc": (2, lambda t: t * 1.1),
            "dx_joint0": (0, zero_joint)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--slice-state", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import dstdgcn_tpu_torch
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.kernels import build, fused
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.utils.config import resolve
    cs.check(os.path.dirname(dstdgcn_tpu_torch.__file__).startswith(tree),
             f"the port came from {dstdgcn_tpu_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    os.makedirs(args.out_dir, exist_ok=True)
    print(cs.nvidia_smi())
    print(f"{label}: the port of {tree}; build {build.build_all()}")

    cfg = configs.synthetic_h36m_tpu_train()
    rcfg = resolve(cfg)
    bs = rcfg["train_batch_size"]
    train = get_dataset("synthetic", **rcfg["dataset"]["train"]).arrays()[:3]
    batches = [[a[i:i + bs] for a in train]
               for i in range(0, len(train[0]) - bs + 1, bs)]
    states = {}
    slice_path = os.path.join(args.out_dir, "slice_state.pt")
    if args.slice_state:
        runner, _ = run(cfg, "cuda",
                        run_dir=os.path.join(args.out_dir, "train_bf16"))
        eng = runner.engine

        def step():
            return eng.train_step(*batches[0])

        cs.time_ms(torch, step, 5)        # phase 9's timing steps
        cs.device_profile(torch, step, 3, host={})
        torch.save(eng.model.state_dict(), slice_path)
    if os.path.exists(slice_path):
        states["slice"] = torch.load(slice_path)
    engines = cs.bf16_step_engines(torch, device, rcfg)
    plain = engines["plain"]
    for i in range(max(STEPS)):
        plain.train_step(*batches[i % len(batches)])
        if i + 1 in STEPS:
            states[f"plain{i + 1}"] = copy.deepcopy(plain.model.state_dict())

    real = fused.dstd_spatial.bwd
    cases = {"none": None}
    if args.faults:
        cases.update(faults(torch))
    kernel = engines["kernel"]
    path = os.path.join(args.out_dir, f"step_noise_{label}.jsonl")
    with open(path, "w") as f:
        for sname, state in states.items():
            t0 = time.perf_counter()
            losses, grads = cs.bf16_step_grads(torch, device, engines, state,
                                               batches[0])
            for cname, case in cases.items():
                if case is not None:
                    idx, alter = case

                    def faulty(*a, idx=idx, alter=alter, **k):
                        out = list(real(*a, **k))
                        out[idx] = alter(out[idx])
                        return tuple(out)

                    fused.dstd_spatial.bwd = faulty
                    try:
                        loss = float(kernel.compute_gradients(*batches[0])[
                            "total"])
                    finally:
                        fused.dstd_spatial.bwd = real
                    got = dict(grads, kernel={
                        n: p.grad.double()
                        for n, p in kernel.model.named_parameters()})
                else:
                    loss, got = losses["kernel"], grads
                errs = cs.step_errors(got)
                verdict = cs.step_verdict(errs)
                f.write(json.dumps(dict(tree=label, state=sname, fault=cname,
                                        loss_kernel=loss, losses=losses,
                                        errs=errs)) + "\n")
                rel = abs(loss - losses["plain"]) / abs(losses["plain"])
                line = f"{label} {sname} {cname}: loss rel {rel:.3g}"
                groups = cs.step_groups(errs)
                for group, (k64, p64, _, worst) in verdict.items():
                    # the group's largest distances beside its means
                    top = errs[worst][2] / max(errs[n][3]
                                               for n in groups[group])
                    line += (f"; {group} mean {k64:.3g} / plain {p64:.3g} = "
                             f"{k64 / p64:.2f}, largest {top:.2f} ({worst})")
                print(line)
            print(f"  {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())


if __name__ == "__main__":
    sys.exit(main())
