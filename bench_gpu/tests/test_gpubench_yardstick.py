"""The yardstick on the CPU: the frozen operation and byte counts against a
brute count, the trace readers on a small synthetic trace, and the plain
reference against the port's plain path."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench_tiny import REPO, SEED, make_copy

from bench_gpu import check, costs, devtrace, reference, run, windows
from bench_gpu.loops import eval as eval_loop
from bench_gpu.loops import train as train_loop


def _op_inputs(mode, n, t, v, ci, co, dtype):
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    g = torch.Generator().manual_seed(0)
    w = dict(wf=torch.randn(k, ci, co, generator=g),
             bf=torch.randn(k, co, generator=g),
             wm1=torch.randn(k, ci, 2, generator=g),
             bm1=torch.randn(k, 2, generator=g),
             wm2=torch.randn(k, ci, 2, generator=g),
             bm2=torch.randn(k, 2, generator=g),
             wrm=torch.randn(k, 2, ref, ref, generator=g),
             brm=torch.randn(k, ref, generator=g))
    x = torch.randn(n, t, v, ci, generator=g).to(dtype)
    base = torch.randn(k, pair, pair, generator=g)
    alpha = torch.randn(1, generator=g)
    return x, base, alpha, w


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("bf16", [False, True])
def test_op_cost_against_a_brute_count(mode, bf16):
    """The contraction count of one forward call equals what the plain
    op's products count; the bytes are x, the weights and the output."""
    n, t, v, ci, co = 2, 5, 4, 3, 6
    x, base, alpha, w = _op_inputs(mode, n, t, v, ci, co,
                                   torch.bfloat16 if bf16 else torch.float32)
    with FlopCounterMode(display=False) as fc:
        out = reference.dstd_op(mode, x.float(), base, alpha, w, None)
    rest, nbytes, dots, peak = costs.op_cost(mode, n, ci, co, t, v,
                                             bf16=bf16)
    assert dots == fc.get_total_flops()
    weights = sum(a.numel() for a in w.values()) + base.numel() + 1
    assert weights == costs.op_weights(mode, ci, co, t, v)
    brute = (x.numel() * x.element_size() + 4 * weights
             + out.numel() * 4)
    assert nbytes == brute
    assert peak == (costs.PEAK_BF16_FLOPS if bf16
                    else costs.PEAK_F32_DOT_FLOPS)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    assert rest == 2 * n * k * 2 * ref * pair * pair \
        + 2 * n * k * ref * pair * pair


def test_model_flops_count_the_forward():
    cfg = json.loads((REPO / "bench_gpu/configs/h36m_tpu.json").read_text())
    hp = dict(cfg["model"]["dstdgcn"], num_feature=8, num_layers=1)
    cfg["model"]["dstdgcn"] = hp
    p = reference.init_params(cfg, 0)
    x = torch.randn(2, 35, 22, 3)
    with FlopCounterMode(display=False) as fc:
        reference.forward(p, cfg, x, False)
    assert costs.model_flops(hp, 2, 35, 22) == fc.get_total_flops()


def _synthetic_trace():
    """Two host threads: the engine thread runs an op that launches two
    kernels, and the autograd thread runs a backward node whose child op
    launches a kernel through a runtime call (no External id on it)."""
    us = 1e6

    def ev(name, cat, ts, dur, tid, **args):
        return dict(ph="X", name=name, cat=cat, ts=ts * us, dur=dur * us,
                    tid=tid, args=args)

    return [
        ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
        ev("aten::mm", "cpu_op", 0.10, 0.05, 1, **{"External id": 10}),
        ev("cudaLaunchKernel", "cuda_runtime", 0.11, 0.01, 1, correlation=1),
        ev("gemm", "kernel", 0.20, 0.10, 7, correlation=1,
           **{"External id": 10}),
        ev("cast", "kernel", 0.30, 0.05, 7, correlation=2,
           **{"External id": 10}),
        ev("_DSTDFunctionBackward", "cpu_op", 0.50, 0.20, 2,
           **{"External id": 20}),
        ev("aten::copy_", "cpu_op", 0.52, 0.02, 2, **{"External id": 21}),
        ev("cuLaunchKernelEx", "cuda_driver", 0.60, 0.01, 2, correlation=3),
        ev("bwd_kernel", "kernel", 0.70, 0.20, 7, correlation=3),
        ev("copy", "gpu_memcpy", 0.95, 0.02, 7, correlation=4),
    ]


def test_trace_readers_on_a_synthetic_trace():
    tr = devtrace.Trace(_synthetic_trace())
    assert tr.window_s == pytest.approx(1.0)
    assert len(tr.kernels()) == 3
    assert tr.busy_s() == pytest.approx(0.15 + 0.20 + 0.02)
    sec, count = tr.device_s_under("_DSTDFunctionBackward")
    assert count == 1 and sec == pytest.approx(0.20)
    sec, count = tr.device_s_under("aten::mm")
    assert count == 2 and sec == pytest.approx(0.15)
    assert tr.host_s() == pytest.approx(0.05 + 0.20)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.37)
    assert gaps["aten::mm"] == pytest.approx(0.20)     # at the gap's middle
    assert gaps["aten::copy_"] == pytest.approx(0.35)  # on the other thread
    assert gaps["outside any operation"] == pytest.approx(0.08)
    ops = dict(tr.top_device_ops())
    assert ops["bwd_kernel"] == pytest.approx(0.20)


def test_metric_readers_on_a_synthetic_trace():
    tr = devtrace.Trace(_synthetic_trace())
    cfg = json.loads((REPO / "bench_gpu/configs/h36m_tpu.json").read_text())
    hp = cfg["model"]["dstdgcn"]
    ns = types.SimpleNamespace(
        trace=tr, profiled=2, window=dict(steps=10, seconds=2.0,
                                          samples=1280),
        config=cfg, costs=costs, model=hp, batch=128, frames=35, joints=22,
        bf16=True, directions=2, peak_flops=costs.PEAK_BF16_FLOPS)
    read = {m: run.load_reader(REPO, "metrics", m).read(ns) for m in (
        "host_ms.train", "launches.train", "roofline.dstd_bwd.train",
        "roofline.dstd_fwd.eval", "mfu.train", "mfu.eval",
        "idle_share.train", "idle_share.eval")}
    assert read["host_ms.train"] == pytest.approx(1e3 * 0.25 / 2)
    assert read["launches.train"] == pytest.approx(1.5)
    bound = costs.ops_bound_s(hp, 128, 35, 22, True)
    assert read["roofline.dstd_bwd.train"] == pytest.approx(
        100 * bound * 2 * 2 / 0.20)
    assert read["roofline.dstd_fwd.eval"] is None      # no marked span
    flops = costs.model_flops(hp, 128, 35, 22)
    assert read["mfu.train"] == pytest.approx(
        100 * 6 * flops * 2 / (0.37 * costs.PEAK_BF16_FLOPS))
    assert read["mfu.eval"] == pytest.approx(
        100 * flops * 10 / (2.0 * costs.PEAK_BF16_FLOPS))
    assert read["idle_share.train"] == pytest.approx(63.0)
    ns.trace = devtrace.Trace([])
    assert run.load_reader(REPO, "metrics", "idle_share.eval").read(ns) \
        is None
    assert run.load_reader(REPO, "metrics", "mfu.train").read(ns) is None
    assert run.load_reader(REPO, "metrics", "launches.train").read(ns) \
        is None


def test_window_readers():
    """Each end-to-end metric of BENCHMARK.json has its reader, and reads
    the window (a rate over all its work and time) or the device's trace
    of the steps after it (busy time over the profiled steps); the
    per-layer rate and tail over all the window's steps."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    walls = [0.05] * 90 + [0.2] * 10
    ns = types.SimpleNamespace(window=dict(samples=12800, seconds=4.0,
                                           walls=walls), setup_s=12.5,
                               trace=devtrace.Trace(_synthetic_trace()),
                               profiled=2)
    want = dict(setup_s=12.5, train_step_device_ms=1e3 * 0.37 / 2,
                eval_samples_per_s=3200.0)
    for m in bench["end_to_end"]:
        got = run.load_reader(REPO, "end_to_end", m["name"]).read(ns)
        assert got == pytest.approx(want[m["name"]]), m["name"]
    got = run.load_reader(REPO, "metrics", "samples_per_s.train").read(ns)
    assert got == pytest.approx(3200.0)
    got = run.load_reader(REPO, "metrics", "step_ms_p95.train").read(ns)
    assert got == pytest.approx(200.0)
    ns.trace, ns.profiled = None, 0
    assert run.load_reader(REPO, "end_to_end",
                           "train_step_device_ms").read(ns) is None


def test_off_precision_share():
    from bench_gpu import program
    bf = {"dstd_spatial_bf16": 6, "dstd_spatial_bwd_bf16": 2}
    assert check.off_precision_share(bf, "bfloat16",
                                     program.launch_variant) == 0.0
    assert check.off_precision_share(dict(bf, dstd_spatial=2), "bfloat16",
                                     program.launch_variant) == 0.2
    assert check.off_precision_share({}, "bfloat16",
                                     program.launch_variant) == 1.0


def test_traffic_is_seeded_and_fixed_in_size():
    cfg = json.loads((REPO / "bench_gpu/configs/cmu_tpu.json").read_text())
    a = windows.Windows(cfg, 2 ** 31 + 5, 1, 16)
    b = windows.Windows(cfg, 2 ** 31 + 5, 1, 16)
    c = windows.Windows(cfg, 7, 1, 16)
    for x, y, z in zip(a.arrays, b.arrays, c.arrays):
        assert np.array_equal(x, y) and x.shape == z.shape
        assert not np.array_equal(x, z)
    inputs, inputs_inv, targets, all_seqs = a.arrays
    assert inputs.shape == (16, 35, 75) and all_seqs.shape == (16, 35, 114)
    assert np.array_equal(inputs[:, 10:], np.repeat(inputs[:, 9:10], 25, 1))
    assert np.array_equal(inputs_inv[:, :10], targets[:, 25:35][:, ::-1])
    src = windows.TrainStream(a, 4, 1)
    rows = np.concatenate([next(src)[0] for _ in range(4)])
    assert len({r.tobytes() for r in rows}) == 16


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_reference_against_the_ports_plain_path(tmp_path, dtype):
    """The port's plain path on the CPU (its kernels' plain versions) and
    the reference agree on three training steps and an evaluation sweep:
    to float32 rounding at float32, and at bf16 as the reference rounded
    at the same points."""
    root = make_copy(tmp_path)
    loaded = run.load_cell(root, "h36m_tpu.train")
    loaded["config"]["model"]["dstdgcn"]["compute_dtype"] = dtype
    q = None if dtype is None else reference.bf16
    h = run.Harness(torch, loaded, SEED, 0, "cpu", timed=False)
    st = train_loop.setup(h)
    ref = reference.train_steps(h.config, SEED, st["rows"], "cpu", q)
    # the later checked steps, from the program's state in a later epoch
    # (another StepLR rate), the dropout masks of the first steps skipped
    st["epoch"] = 7
    train_loop.after_window(h, st)
    ref_post = reference.train_steps(h.config, SEED, st["post_rows"], "cpu",
                                     q, start=st["post_start"])
    got = check.train_numbers(st["readings"], ref)
    got.update(check.train_numbers(st["post"], ref_post, "post_"))
    # at bf16 the change over three Adam steps is left out: Adam turns the
    # two paths' different roundings of near-zero gradient elements into
    # whole steps of either sign
    tol = (dict(loss_gap=1e-6, grad_gap=1e-4, update_gap=1e-2) if q is None
           else dict(loss_gap=1e-5, grad_gap=1e-1))
    tol.update({"post_" + k: v for k, v in tol.items()})
    assert all(got[k] <= tol[k] for k in tol), got
    assert st["steps_missed"] == 0 and st["post_start"]["steps"] == 3
    for k, v in ref["p0"].items():
        assert torch.equal(st["readings"]["p0"][k], v), k
    loaded = run.load_cell(root, "h36m_tpu.eval")
    loaded["config"]["model"]["dstdgcn"]["compute_dtype"] = dtype
    h = run.Harness(torch, loaded, SEED, 0, "cpu", timed=False,
                    keep_all=True)
    st = eval_loop.setup(h)
    st["keep"] = True
    eval_loop._sweep(h, st, record=True)
    got = eval_loop.verify(h, st, q)[0]
    assert got["pred_gap"] <= (1e-5 if q is None else 1e-2), got
    assert got["mpjpe_gap"] <= (1e-6 if q is None else 1e-3), got
