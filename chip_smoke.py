#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which must pass (exit code 1 and no result line otherwise):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel from ``dstdgcn_tpu_torch/csrc`` for
   ``sm_90a``, one ``nvcc`` per source in parallel (4 libraries: the
   spatial and temporal forward and backward);
3. each kernel against its plain PyTorch version on the card, agg right and
   left, at every (Ci, Co) the serving and training paths give it, N=32,
   T=35, V=22, seeded inputs, TF32 off.  Forward kernels: |kernel - plain|
   <= 1e-4 + 1e-4 |plain| elementwise.  Backward kernels (against
   ``ops/dstd_bwd.py``, seeded cotangent): per output tensor
   max |kernel - plain| <= 1e-4 max(max |plain|, 1), the JAX package's own
   norm, since the weight gradients sum 24,640 rows in another order.  The
   backward's plain time is autograd through the plain forward;
4. the serving slice: ``dstdgcn_tpu_torch.main.run`` on the config
   ``synthetic_h36m_serving`` (full-width H36M DSTD-GCN, random weights from
   seed 777) on ``cuda``: finite per-frame MPJPE, wall time per batch, and
   each forward kernel's launch count at exactly 7 per forward; then batch-1
   requests, and one full batch served through the kernels against the
   plain path (at the same 1e-4);
5. the training slice: ``main.run`` on ``synthetic_h36m_train`` (the same
   model, ``use_pallas: True``, 2 epochs of 8 steps of batch 32, an eval
   sweep of 2 batches after each): finite losses and per-frame MPJPE, the
   csv and both checkpoints written, and exact launch counts (forward
   kernels 14 per train step plus 7 per eval batch; backward kernels 14
   calls per train step, 4 launches each); wall ms per train step and the
   device-busy share of one step; then one train step on one batch with
   dropout 0 and BatchNorm calibrated, kernel path against plain path
   (loss to 1e-5 relative; each parameter's gradient against the plain
   path run in float64, within 1e-3 max(max |float64|, 1) or twice the
   plain float32 path's own distance, see GRAD_TOL), and the train step
   timed on both paths;
6. a ``{"kernels": [...]}`` line with each kernel's launches on the
   training path, max error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  ``ms`` / ``plain_ms``
are device times per call from ``torch.profiler`` (the kernels' own time);
``call_ms`` is the CUDA-event mean per call of back-to-back calls, host
launch overhead included.  Caches are warm: the 12.7 MB activations of a
launch fit in the 50 MB L2, as they do between the ops of one forward.
Run logs and a full report go to ``chiprun_out/chip_smoke/``.
"""

import copy
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")

N, T, V = 32, 35, 22
TOL = 1e-4
#: train-step comparison: the loss against the plain path; each gradient
#: against the plain path run in float64, within 1e-3 of max(|float64|, 1)
#: or, where float32 rounding alone is larger, within twice the plain
#: float32 path's own distance to float64.  The gradient of a gate alpha
#: sums about a million products dA * dyn that largely cancel, so float32
#: summation order alone moves it by a few 1e-3 (the plain float32 path has
#: measured up to 4.7e-3 from float64 there), and no fixed bound of 1e-3
#: or tighter separates a kernel fault from rounding.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
#: published H100 SXM peaks (float32 outside the tensor cores, HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: file:line of the TPU kernel each CUDA kernel replaces, and its source
KERNELS = {
    "dstd_spatial": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:137"),
    "dstd_temporal": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:193"),
    "dstd_spatial_bwd": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:85"),
    "dstd_temporal_bwd": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:177"),
}
FORWARD = ("dstd_spatial", "dstd_temporal")
BACKWARD = ("dstd_spatial_bwd", "dstd_temporal_bwd")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def op_cost(mode, n, ci, co, backward=False):
    """(flops, bytes) one call needs: every input read once, every output
    written once; tanh and the pair difference count one op each.  The
    backward recomputes the forward up to the adjacency, then does the
    dA and dxf products, dalpha / dbase / dbrm, dx from dxf, dwf / dbf,
    dwrm, ds, du, the dq / dk sums, dx from dq / dk and dwqk / dbqk; it
    reads x, g and the weights and writes dx and the weight gradients."""
    k = 2 if mode == "spatial" else 1
    r = 2
    ref, pair = (T, V) if mode == "spatial" else (V, T)
    rows = n * T * V
    scores = n * k * r * ref * pair * pair          # score entries
    adj = n * k * ref * pair * pair                 # adjacency entries
    proj = 2 * rows * ci * co * k                   # feature projection
    qk = 2 * rows * ci * 2 * r * k                  # q/k projections
    mix = 2 * scores * ref                          # frame/joint mixing
    agg = 2 * adj * co                              # aggregation
    weights = (k * pair * pair + 1 + k * ci * co + k * co + 2 * k * ci * r
               + 2 * k * r + k * r * ref * ref + k * ref)
    if not backward:
        flops = proj + qk + 2 * scores + mix + 2 * adj + agg
        return flops, 4 * (rows * ci + rows * co + weights)
    flops = (proj + qk + 2 * scores + mix + 2 * adj   # recompute
             + 2 * agg                                # dA, dxf
             + 3 * adj                                # dalpha, dbase, dbrm
             + 2 * proj + rows * co * k               # dx(dxf), dwf, dbf
             + 2 * mix                                # dwrm, ds
             + 3 * scores + 2 * scores                # du, dq / dk sums
             + 2 * qk + rows * 2 * r * k)             # dx(dqk), dwqk, dbqk
    return flops, 4 * (2 * rows * ci + rows * co + 2 * weights)


def bound_ms(mode, n, ci, co, backward=False):
    """(least ms, ms of the operations, ms of the bytes) of one call."""
    flops, nbytes = op_cost(mode, n, ci, co, backward)
    t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), t_ops, t_mem


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters, tries=3, host=None):
    """{name: device ms per call} of what ``fn`` runs on the card, from
    ``torch.profiler`` (CUPTI): the kernels' own time, no host gaps.  The
    profiler now and then records nothing; it is then asked again, and an
    empty dict returned after ``tries`` attempts.  A ``host`` dict receives
    {name: host ms per call} (self CPU time) from the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device-side entries only (kernels, copies): an operator's entry
        # repeats the device time of the kernels it launched, and so does a
        # user annotation's device range (Optimizer.step, for one).  Per
        # call: the mean time of one record times the records per call, so
        # a record the profiler dropped does not shrink the result.
        out = {e.key: e.self_device_time_total / e.count / 1e3
               * max(1, round(e.count / iters))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")
               and e.self_device_time_total > 0}
        if out:
            if host is not None:
                host.update({e.key: e.self_cpu_time_total / iters / 1e3
                             for e in prof.key_averages()
                             if e.self_cpu_time_total > 0})
            return out
    return {}


def device_ms(torch, fn, iters):
    """(ms per call, how it was timed): the profiler's device time, or the
    CUDA-event time per call (host gaps included) if the profiler saw
    nothing."""
    total = sum(device_profile(torch, fn, iters).values())
    if total > 0:
        return total, "profiler"
    return time_ms(torch, fn, iters), "events"


def errors(torch, got, want):
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-6)
    ok = bool((diff <= TOL + TOL * want.abs()).all())
    return float(diff.max()), float(rel.max()), ok


def grad_errors(got, want):
    """(max abs err, worst err / max(max |plain|, 1), ok) over the tensors
    of one backward call."""
    abs_err = norm_err = 0.0
    for a, b in zip(got, want):
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        norm_err = max(norm_err, d / max(float(b.abs().max()), 1.0))
    return abs_err, norm_err, norm_err <= TOL


def op_inputs(torch, np, mode, ci, co, device, seed):
    """Seeded inputs at the model's initialization scales, with the gates
    and biases that initialize at zero made non-zero."""
    rng = np.random.RandomState(seed)
    k = 2 if mode == "spatial" else 1
    ref, pair = (T, V) if mode == "spatial" else (V, T)

    def nrm(std, *shape):
        return (rng.randn(*shape) * std).astype(np.float32)

    arrs = [nrm(1.0, N, T, V, ci), nrm(0.3, k, pair, pair),
            np.asarray([0.7], np.float32), nrm((2 / co) ** 0.5, k, ci, co),
            nrm(0.1, k, co), nrm(1.0, k, ci, 2), nrm(0.1, k, 2),
            nrm(1.0, k, ci, 2), nrm(0.1, k, 2),
            nrm((2 / ref) ** 0.5, k, 2, ref, ref), nrm(0.1, k, ref)]
    return [torch.from_numpy(a).to(device) for a in arrs]


def forward_shapes(model_cfg):
    """(mode, Ci, Co) of the 7 spatial and 7 temporal launches of one
    forward: in-layer, encoders, out-layer."""
    f, layers = model_cfg["num_feature"], model_cfg["num_layers"]
    cin, cout = model_cfg["input_channels"], model_cfg["input_channels"] // 2
    spatial = [(cin, f)] + [(f, f)] * layers + [(f, cout)]
    temporal = [(f, f)] * (layers + 1) + [(cout, cout)]
    return ([("spatial",) + s for s in spatial]
            + [("temporal",) + s for s in temporal])


def calibrate_batchnorm(torch, model, inputs):
    """Set every JointBatchNorm's statistics to those of ``inputs`` (one
    train-mode forward of the plain path, momentum 1, no dropout) so the
    activations of a random-weight model stay O(1) as in a trained one."""
    from dstdgcn_tpu_torch.models import JointBatchNorm
    bns = [m for m in model.modules() if isinstance(m, JointBatchNorm)]
    saved = [m.momentum for m in bns]
    p = model.do_in.p
    for m in bns:
        m.momentum = 1.0
    model.do_in.p = 0.0
    with torch.no_grad():
        model.train()(inputs)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    model.do_in.p = p
    model.eval()


def run_smoke():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    try:
        from dstdgcn_tpu_torch import configs
        from dstdgcn_tpu_torch.data import get_dataset
        from dstdgcn_tpu_torch.engine import PredictionEngine
        from dstdgcn_tpu_torch.kernels import build, fused
        from dstdgcn_tpu_torch.main import run
        from dstdgcn_tpu_torch.models import get_model
        from dstdgcn_tpu_torch.ops import dstd as plain
        from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd
        from dstdgcn_tpu_torch.utils.config import resolve
    except ImportError as e:
        raise SmokeFailure(f"cannot import the port ({e}): run "
                           "chip_smoke.py from the repository root") from e

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    report = {}

    # 1. the card
    smi = nvidia_smi()
    print(smi)
    yaml_ok = subprocess.run([sys.executable, "-c", "import yaml"],
                             capture_output=True).returncode == 0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()} "
          f"yaml {'importable' if yaml_ok else 'missing'}")
    report.update(nvidia_smi=smi, torch=torch.__version__,
                  cuda=torch.version.cuda, yaml=yaml_ok)

    # 2. build every kernel, one nvcc per source in parallel
    t0 = time.perf_counter()
    secs = build.build_all()
    total = time.perf_counter() - t0
    print(f"build: {total:.1f} s for {len(secs)} kernels "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in secs:
        log = build.build_log(name)
        with open(os.path.join(OUT_DIR, f"build_{name}.log"), "w") as f:
            f.write(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["build_seconds"] = dict(secs, total=total)

    # 3. each kernel against its plain version at the serving and training
    # shapes (the two slices' configs share the model block)
    model_cfg = resolve(configs.SYNTHETIC_H36M_SERVING)["model"]["dstdgcn"]
    check(model_cfg == resolve(configs.SYNTHETIC_H36M_TRAIN)["model"][
        "dstdgcn"], "the serving and training slices differ in the model")
    shapes = sorted({(ci, co) for _, ci, co in forward_shapes(model_cfg)})
    timings, max_err, checks = {}, {name: 0.0 for name in KERNELS}, []
    for mode in ("spatial", "temporal"):
        name = f"dstd_{mode}"
        kernel, ref = getattr(fused, name), getattr(plain, name)
        for ci, co in shapes:
            args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co)
            for agg in ("right", "left"):
                before = kernel.launches
                got = kernel(*args, None, agg)
                torch.cuda.synchronize()
                check(kernel.launches == before + 1,
                      f"{name} did not count its launch")
                want = ref(*args, None, agg)
                abs_err, rel_err, ok = errors(torch, got, want)
                k_call = time_ms(torch, lambda: kernel(*args, None, agg), 20)
                p_call = time_ms(torch, lambda: ref(*args, None, agg), 10)
                k_ms, k_by = device_ms(
                    torch, lambda: kernel(*args, None, agg), 20)
                p_ms, p_by = device_ms(torch, lambda: ref(*args, None, agg),
                                       10)
                launches = kernel.launches - before
                b_ms, t_ops, t_mem = bound_ms(mode, N, ci, co)
                timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call, k_by)
                max_err[name] = max(max_err[name], abs_err)
                line = dict(kernel=name, agg=agg, ci=ci, co=co, n=N,
                            max_abs_err=abs_err, max_rel_err=rel_err,
                            ok=ok, ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                            plain_call_ms=p_call, timed_by=[k_by, p_by],
                            bound_ms=b_ms,
                            bound_by="operations" if t_ops >= t_mem
                            else "bytes", check_launches=launches)
                checks.append(line)
                print("check " + json.dumps(line))
                check(ok, f"{name} agg={agg} {ci}->{co} disagrees with the "
                          f"plain op: max abs err {abs_err}")
    # the backward kernels against the hand-derived plain backward, and
    # timed against autograd through the plain forward
    for mode in ("spatial", "temporal"):
        name = f"dstd_{mode}_bwd"
        kernel, ref = getattr(fused, name), getattr(plain_bwd, name)
        ref_fwd = getattr(plain, f"dstd_{mode}")
        for ci, co in shapes:
            args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co)
            gen = torch.Generator(device=device).manual_seed(ci * co)
            g = torch.randn((N, T, V, co), generator=gen, device=device)
            req = [a.detach().clone().requires_grad_() for a in args]

            def autograd_plain(req=req, g=g, agg=None):
                out = ref_fwd(*req, None, agg)
                return torch.autograd.grad(out, req, g)

            for agg in ("right", "left"):
                before = kernel.launches
                got = kernel(args[0], g, *args[1:], agg=agg)
                again = kernel(args[0], g, *args[1:], agg=agg)
                torch.cuda.synchronize()
                check(kernel.launches == before + 2 * fused.BWD_LAUNCHES,
                      f"{name} did not count its launches")
                repeat = all(bool(torch.equal(a, b))
                             for a, b in zip(got, again))
                want = ref(args[0], g, *args[1:], agg=agg)
                abs_err, norm_err, ok = grad_errors(got, want)

                def call(agg=agg):
                    return kernel(args[0], g, *args[1:], agg=agg)

                def plain_call(agg=agg):
                    return autograd_plain(agg=agg)

                k_call = time_ms(torch, call, 20)
                p_call = time_ms(torch, plain_call, 10)
                k_ms, k_by = device_ms(torch, call, 20)
                p_ms, p_by = device_ms(torch, plain_call, 10)
                b_ms, t_ops, t_mem = bound_ms(mode, N, ci, co, True)
                timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call, k_by)
                max_err[name] = max(max_err[name], abs_err)
                line = dict(kernel=name, agg=agg, ci=ci, co=co, n=N,
                            max_abs_err=abs_err, max_norm_err=norm_err,
                            ok=ok, repeatable=repeat, ms=k_ms,
                            plain_ms=p_ms, call_ms=k_call,
                            plain_call_ms=p_call, timed_by=[k_by, p_by],
                            bound_ms=b_ms,
                            bound_by="operations" if t_ops >= t_mem
                            else "bytes")
                checks.append(line)
                print("check " + json.dumps(line))
                check(ok, f"{name} agg={agg} {ci}->{co} disagrees with the "
                          f"plain backward: {norm_err} of max(|plain|, 1)")
                check(repeat, f"{name} agg={agg} {ci}->{co}: two calls on "
                              "the same inputs differ")
    report["checks"] = checks

    # 4. the serving slice through its entry point, counts from zero
    cfg = configs.synthetic_h36m_serving()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, (avg, per_frame) = run(cfg, "cuda",
                                   run_dir=os.path.join(OUT_DIR, "run"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    engine = runner.engine
    batches = engine.test_batch_seconds
    forwards = len(batches)
    print(f"slice: main.run on cuda, {forwards} batches of "
          f"{cfg['test_batch_size']} in {wall:.2f} s; per-frame MPJPE "
          f"{[float(m) for m in per_frame]} avg {float(avg)}")
    print(f"slice: wall ms per batch {[round(s * 1e3, 3) for s in batches]}"
          f" (median {float(np.median(batches)) * 1e3:.3f})")
    print(f"slice: launches {counts} over {forwards} forwards")
    check(forwards > 0, "the slice ran no batch")
    check(np.all(np.isfinite(per_frame)) and np.isfinite(avg),
          "non-finite MPJPE")
    for name in FORWARD:
        check(counts[name] == 7 * forwards,
              f"{name}: {counts[name]} launches, expected 7 per forward "
              f"x {forwards}")
    for name in BACKWARD:
        check(counts[name] == 0, f"{name} launched while serving")
    report["slice"] = dict(per_frame=[float(m) for m in per_frame],
                           avg=float(avg), batch_seconds=batches,
                           launches=counts, forwards=forwards, wall=wall)

    # batch-1 requests through the same engine
    test_cfg = resolve(cfg)["dataset"]["test"]
    dataset = get_dataset("synthetic", **test_cfg)
    inputs = dataset.input_seqs
    req_ms = []
    for i in range(4):
        before = fused.launch_counts()
        t0 = time.perf_counter()
        out = engine.predict(inputs[i:i + 1])
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        after = fused.launch_counts()
        check(out.shape == (1, T, inputs.shape[-1])
              and bool(torch.isfinite(out).all()), "bad batch-1 output")
        check(all(after[k] - before[k] == 7 for k in FORWARD),
              f"batch-1 request launched {after} (before {before})")
    print(f"serve: 4 batch-1 requests, ms {[round(m, 3) for m in req_ms]}")
    report["batch1_ms"] = req_ms

    # where the time of one batch-32 forward goes on the card
    def forward():
        return engine.predict(inputs[:N])

    fwd_call = time_ms(torch, forward, 5)
    prof = device_profile(torch, forward, 5)
    fwd_dev = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
    busy = (f"{fwd_dev:.3f} ms ({100 * fwd_dev / fwd_call:.1f}%)" if prof
            else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{N} forward {fwd_call:.3f} ms per call, device "
          f"busy {busy}; top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    report["forward_profile"] = dict(call_ms=fwd_call, device_ms=fwd_dev,
                                     by_kernel=prof)

    # one full batch: kernel path against the plain path, same weights,
    # gates and biases moved off zero, BatchNorm calibrated on the batch
    model = engine.model
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(device))
    model_opts = {k: v for k, v in resolve(cfg)["model"].items()
                  if k != "name"}
    plain_model = get_model("dstdgcn", **dict(model_opts, use_pallas=False))
    plain_model.load_state_dict(model.state_dict())
    plain_engine = PredictionEngine(cfg["engine"], plain_model, device="cuda")
    batch = inputs[:N]
    calibrate_batchnorm(torch, plain_engine.model,
                        plain_engine.transform(plain_engine.to_device(batch)))
    model.load_state_dict(plain_engine.model.state_dict())
    before = fused.launch_counts()
    got = engine.predict(batch)
    want = plain_engine.predict(batch)
    torch.cuda.synchronize()
    abs_err, rel_err, ok = errors(torch, got, want)
    after = fused.launch_counts()
    print(f"serve: batch {N} kernel path vs plain path max_abs_err "
          f"{abs_err} max_rel_err {rel_err} (|out| max "
          f"{float(want.abs().max())}) launches "
          f"{ {k: after[k] - before[k] for k in FORWARD} }")
    check(ok, f"model output: kernel path disagrees with the plain path "
              f"(max abs err {abs_err})")
    check(all(after[k] - before[k] == 7 for k in FORWARD),
          "the kernel path did not launch 7 of each kernel")
    report["model_check"] = dict(max_abs_err=abs_err, max_rel_err=rel_err)

    # the same forwards timed on both paths (CUDA events, host included)
    paths = {}
    for label, eng in (("kernel", engine), ("plain", plain_engine)):
        paths[label] = {
            n: time_ms(torch, lambda: eng.predict(inputs[:n]), 10)
            for n in (N, 1)}
    print(f"serve: forward ms per call, kernel path vs plain path: batch {N}"
          f" {paths['kernel'][N]:.3f} vs {paths['plain'][N]:.3f}; batch 1 "
          f"{paths['kernel'][1]:.3f} vs {paths['plain'][1]:.3f}")
    report["paths_ms"] = paths

    # 5. the training slice through its entry point, counts from zero
    tcfg = configs.synthetic_h36m_train()
    rcfg = resolve(tcfg)
    epochs = rcfg["epoch"]
    n_train = rcfg["dataset"]["train"]["synthetic"]["num_sequences"]
    n_test = rcfg["dataset"]["test"]["synthetic"]["num_sequences"]
    steps = epochs * -(-n_train // rcfg["train_batch_size"])
    evals = epochs * -(-n_test // rcfg["test_batch_size"])
    train_dir = os.path.join(OUT_DIR, "train")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    trunner, history = run(tcfg, "cuda", run_dir=train_dir)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tcounts = fused.launch_counts()
    teng = trunner.engine
    step_s = teng.train_step_seconds
    rows = np.asarray(history, dtype=np.float64)
    print(f"train: main.run on cuda, {len(step_s)} steps of "
          f"{rcfg['train_batch_size']} and {evals} eval batches in "
          f"{twall:.2f} s; per epoch (epoch, lr, train loss, test loss, "
          f"per-frame MPJPE) {rows.tolist()}")
    print(f"train: wall ms per step, first {step_s[0] * 1e3:.3f}, then "
          f"median {float(np.median(step_s[1:])) * 1e3:.3f} "
          f"(min {min(step_s[1:]) * 1e3:.3f}, max "
          f"{max(step_s[1:]) * 1e3:.3f})")
    print(f"train: launches {tcounts} over {steps} steps and {evals} eval "
          "batches")
    check(len(step_s) == steps, f"{len(step_s)} train steps, expected "
                                f"{steps}")
    check(rows.shape == (epochs, 3 + 1 + len(rcfg["setting"]["eval_frame"]))
          and bool(np.all(np.isfinite(rows))),
          "non-finite losses or MPJPE in training")
    with open(os.path.join(train_dir, "training_loss.csv")) as f:
        csv_rows = [line.strip().split(",") for line in f if line.strip()]
    check(csv_rows[0][:4] == ["epoch", "lr", "train_loss", "test_loss"]
          and len(csv_rows) == epochs + 2,
          f"training_loss.csv holds {csv_rows}")
    for ckpt in ("last.ckpt", "best.ckpt"):
        check(os.path.isfile(os.path.join(train_dir, "checkpoints", ckpt)),
              f"{ckpt} was not written")
    want_counts = {name: 14 * steps + 7 * evals for name in FORWARD}
    want_counts.update({name: fused.BWD_LAUNCHES * 14 * steps
                        for name in BACKWARD})
    check(tcounts == want_counts, f"training launched {tcounts}, expected "
                                  f"{want_counts}")
    report["train"] = dict(history=rows.tolist(), step_seconds=step_s,
                           launches=tcounts, steps=steps, evals=evals,
                           wall=twall)

    # where the time of one train step goes on the card
    train_ds = get_dataset("synthetic", **rcfg["dataset"]["train"])
    tbatch = [a[:N] for a in train_ds.arrays()[:3]]

    def train_step():
        return teng.train_step(*tbatch)

    step_call = time_ms(torch, train_step, 5)
    shost = {}
    sprof = device_profile(torch, train_step, 3, host=shost)
    step_dev = sum(sprof.values())
    top = sorted(sprof.items(), key=lambda kv: -kv[1])[:8]
    busy = (f"{step_dev:.3f} ms ({100 * step_dev / step_call:.1f}%)"
            if sprof else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{N} train step {step_call:.3f} ms per call, "
          f"device busy {busy}; top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    htop = sorted(shost.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile: train step host self time {sum(shost.values()):.3f} "
          "ms per call (under the profiler); top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in htop))
    report["train_profile"] = dict(call_ms=step_call, device_ms=step_dev,
                                   by_kernel=sprof, host_ms=shost)

    # one train step on one batch: kernel path against the plain path, same
    # weights, dropout 0, BatchNorm calibrated on the batch
    tmodel = teng.model
    topts = {k: v for k, v in rcfg["model"].items() if k != "name"}
    pmodel = get_model("dstdgcn", **dict(topts, use_pallas=False))
    peng = PredictionEngine(rcfg["engine"], pmodel, device="cuda")
    peng.init()
    pmodel.load_state_dict(tmodel.state_dict())
    calibrate_batchnorm(torch, pmodel, peng.transform(peng.to_device(
        tbatch[0])))
    tmodel.load_state_dict(pmodel.state_dict())
    for m in (tmodel, pmodel):
        m.do_in.p = 0.0
    before = fused.launch_counts()
    k_loss = float(teng.compute_gradients(*tbatch)["total"])
    after = fused.launch_counts()
    p_loss = float(peng.compute_gradients(*tbatch)["total"])
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    # the plain path once more in float64, the yardstick of both
    m64 = copy.deepcopy(pmodel).double()
    e64 = PredictionEngine(rcfg["engine"], m64, device="cuda")
    b64 = [torch.as_tensor(a, dtype=torch.float64, device=device)
           for a in tbatch]
    m64.train()
    total64 = (sum(e64._one_pass(b64[0], b64[2], None, None, None).values())
               + sum(e64._one_pass(b64[1], b64[2].flip(1), None, None,
                                   None).values())) / 2
    total64.backward()
    total64 = total64.detach()

    def rel(got, want):
        return float((got.double() - want).abs().max()) / max(
            float(want.abs().max()), 1.0)

    g64 = {n: p.grad for n, p in m64.named_parameters()}
    pgrads = dict(pmodel.named_parameters())
    grad_errs = {pname: (rel(p.grad, pgrads[pname].grad.double()),
                         rel(p.grad, g64[pname]),
                         rel(pgrads[pname].grad, g64[pname]))
                 for pname, p in tmodel.named_parameters()}
    # each gradient's distance to float64 over what it may be
    excess = {k: e[1] / max(GRAD_TOL, 2 * e[2])
              for k, e in grad_errs.items()}
    worst_name = max(excess, key=excess.get)
    worst = grad_errs[worst_name][1]
    step_launches = {k: after[k] - before[k] for k in KERNELS}
    print(f"train: one step, kernel path vs plain path: loss {k_loss} vs "
          f"{p_loss} (rel {loss_rel:.3g}; float64 {total64.item()}); "
          f"launches {step_launches}")
    top = set(sorted(grad_errs, key=lambda k: -grad_errs[k][0])[:3]
              + sorted(grad_errs, key=lambda k: -grad_errs[k][1])[:3])
    for pname in sorted(top, key=lambda k: -grad_errs[k][1]):
        kp, k64, p64 = grad_errs[pname]
        print(f"train: gradient {pname}: kernel vs plain {kp:.3g}, kernel "
              f"vs float64 {k64:.3g}, plain vs float64 {p64:.3g} of "
              "max(|reference|, 1)")
    check(loss_rel <= LOSS_RTOL, f"train loss: kernel path {k_loss}, plain "
                                 f"path {p_loss}")
    check(excess[worst_name] <= 1.0,
          f"gradient of {worst_name}: {worst} of max(|float64|, 1), the "
          f"plain float32 path {grad_errs[worst_name][2]}")
    check(step_launches == {
        **{k: 14 for k in FORWARD},
        **{k: 14 * fused.BWD_LAUNCHES for k in BACKWARD}},
        f"one train step launched {step_launches}")
    report["train_check"] = dict(loss=k_loss, plain_loss=p_loss,
                                 loss_rel=loss_rel, worst_grad=worst,
                                 worst_excess=excess[worst_name],
                                 worst_param=worst_name,
                                 grad_errs=grad_errs)

    # the train step timed on both paths (CUDA events, host included; the
    # profiler's device time beside it)
    tpaths = {}
    for label, eng in (("kernel", teng), ("plain", peng)):
        def one(eng=eng):
            return eng.train_step(*tbatch)
        tpaths[label] = dict(call_ms=time_ms(torch, one, 10),
                             device_ms=sum(device_profile(torch, one,
                                                          3).values()))
    print(f"train: step ms per call, kernel path vs plain path: "
          f"{tpaths['kernel']['call_ms']:.3f} vs "
          f"{tpaths['plain']['call_ms']:.3f}; device "
          f"{tpaths['kernel']['device_ms']:.3f} vs "
          f"{tpaths['plain']['device_ms']:.3f}")
    report["train_paths_ms"] = tpaths

    # 6. the kernels line: times summed over the 7 calls of one N=32
    # forward (or of its backward) at their (Ci, Co), with the model's
    # aggregation; launches are those of the training slice, the serving
    # slice's beside them
    agg = "left" if model_cfg.get("fast") else "right"
    kernels = []
    for name, meta in KERNELS.items():
        mode = name.split("_")[1]
        backward = name in BACKWARD
        ms = plain_ms = call_ms = b_ms = ops_ms = mem_ms = 0.0
        timed_by = set()
        for m, ci, co in forward_shapes(model_cfg):
            if m != mode:
                continue
            k_t, p_t, k_call, k_by = timings[(name, ci, co, agg)]
            timed_by.add(k_by)
            b, t_ops, t_mem = bound_ms(mode, N, ci, co, backward)
            ms, plain_ms, b_ms = ms + k_t, plain_ms + p_t, b_ms + b
            call_ms += k_call
            ops_ms, mem_ms = ops_ms + t_ops, mem_ms + t_mem
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=tcounts[name],
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms,
            bound_by="operations" if ops_ms >= mem_ms else "bytes",
            library_ms=None, call_ms=call_ms,
            serving_launches=counts[name],
            timed_by="+".join(sorted(timed_by))))
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main():
    try:
        result = run_smoke()
    except Exception:  # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
