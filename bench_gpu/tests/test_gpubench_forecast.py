"""The forecast cell on the CPU at a tiny size: a run end to end reads
``correct``, each planted fault and the TF32 control's stand-in fail a
limit, the new readers read a synthetic trace, and ``load_cell`` finds the
cell's files by name alone.

The tiny copy cuts Graph WaveNet to V 40, batch 4, widths 8 / 8 / 16 /
32 (8 layers, as published), 16 x 16 blocks and a series of half a day;
the harness, the loop and the limits are the cell's own."""

from __future__ import annotations

import json
import types

import pytest
import torch

from gpubench_tiny import REPO, SEED, make_copy, run_cell

from bench_gpu import (check, costs, costs_gwnet, devtrace, faults_forecast,
                       run)
from bench_gpu.loops import forecast

CELL = "gwnet_gla.forecast"
TINY = dict(joints_to_consider=40, residual_channels=8, dilation_channels=8,
            skip_channels=16, end_channels=32, block=16)
NEW = ["mfu.forecast", "roofline.spmm.forecast",
       "diffusion_device_ms.forecast", "spmm_device_ms.forecast"]
#: the training cells' readers that the cell reports too (the window's
#: rate and walls, the trace's host time, launches and idle share)
SHARED = ["host_ms.train", "launches.train", "samples_per_s.train",
          "step_ms_p95.train", "idle_share.train"]
#: the engine's span readers, which read the cell's trace as well but whose
#: entries ``test_gpubench_spans.py`` holds to the DSTD-GCN training cells
SPANS = ["forward_device_ms.train", "backward_device_ms.train",
         "optimizer_device_ms.train", "forward_idle_ms.train",
         "backward_idle_ms.train", "optimizer_idle_ms.train",
         "sync_wait_ms.train"]


def make_forecast_copy(dest):
    """``make_copy`` with the forecast cell cut to the tiny size."""
    root = make_copy(dest)
    src = json.loads((REPO / "bench_gpu/configs/gwnet_gla.json").read_text())
    src["model"]["gwnet"].update(TINY)
    src["graph"] = dict(seed=5, freeways=4, extent_km=10.0, reach_km=3.0)
    src["train_batch_size"] = src["test_batch_size"] = 4
    (root / "bench_gpu/configs/gwnet_gla.json").write_text(json.dumps(src))
    path = root / "bench_gpu/traffic/forecast.json"
    mix = json.loads(path.read_text())
    mix.update(days=0.25, warmup_steps=1, trace_steps=2)
    path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_forecast_copy(tmp_path_factory.mktemp("tiny_forecast"))


def test_sound_run_is_correct(tiny):
    rc, res, err = run_cell(tiny, CELL)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s"}    # no trace on the CPU
    assert set(res["checks"]) == {
        "loss_gap", "grad_gap", "update_gap", "post_loss_gap",
        "post_update_gap", "adam_steps_missed", "tf32_in_window"}


@pytest.mark.parametrize("fault", sorted(faults_forecast.BY_NAME))
def test_fault_under_the_timed_path_is_not_correct(tiny, fault):
    rc, res, _ = run_cell(tiny, CELL, fault=faults_forecast.BY_NAME[fault])
    assert rc == 0
    assert res["correct"] is False, (fault, res["checks"])


def test_tf32_left_on_in_the_window_is_not_correct(tiny):
    """A program that leaves TF32 allowed: the number reads 1."""
    def allow(engine):
        torch.backends.cudnn.allow_tf32 = True
    before = torch.backends.cudnn.allow_tf32
    try:
        rc, res, _ = run_cell(tiny, CELL, fault=allow)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert rc == 0
    assert res["checks"]["tf32_in_window"]["value"] == 1.0
    assert res["correct"] is False


def test_a_coarser_reference_fails_a_limit(tiny):
    """The control's stand-in on the CPU, which has no TF32: the reference
    with its products' operands rounded to TF32's 10-bit mantissa fails
    a limit of the table."""
    loaded = run.load_cell(tiny, CELL)
    h = run.Harness(torch, loaded, SEED, 0, "cpu", timed=False)
    st = forecast.setup(h)
    forecast.after_window(h, st)
    st["tf32"] = False
    good, (ref, ref_post) = forecast.verify(h, st)

    def tf32(x):
        bits = x.detach().view(torch.int32) & ~0x1FFF
        return x + (bits.view(torch.float32) - x).detach()

    mm, conv = torch.mm, torch.nn.functional.conv2d
    try:
        torch.mm = lambda a, b: mm(tf32(a), tf32(b))
        torch.nn.functional.conv2d = (
            lambda x, w, *a, **k: conv(tf32(x), tf32(w), *a, **k))
        low = forecast.reference_steps(h, st, st["rows"])
    finally:
        torch.mm, torch.nn.functional.conv2d = mm, conv
    numbers = check.train_numbers(low, ref)
    table = check.limits("forecast", "float32", tiny)
    assert check.judge(good, table)[0], good
    assert not check.judge(numbers, {k: table[k] for k in numbers})[0], (
        numbers)


def _ev(name, cat, ts, dur, tid, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts * 1e6, dur=dur * 1e6,
                tid=tid, args=args)


def _trace(spans=True):
    """One step: the forward's diffusion span launches the SpMM kernel and
    a dense product on thread 1; autograd's thread 2 launches the SpMM's
    d_x inside the backward spans.  Busy 0.29 s of the 1 s span, all of it
    launched under the diffusion spans, 0.15 s under the SpMM's."""
    events = [_ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
              _ev("cudaLaunchKernel", "cuda_runtime", 0.06, 0.001, 1,
                  correlation=1),
              _ev("spmm_kernel", "kernel", 0.10, 0.05, 7, correlation=1),
              _ev("cudaLaunchKernel", "cuda_runtime", 0.16, 0.001, 1,
                  correlation=2),
              _ev("sgemm", "kernel", 0.16, 0.14, 7, correlation=2),
              _ev("cudaLaunchKernel", "cuda_runtime", 0.45, 0.001, 2,
                  correlation=3),
              _ev("spmm_kernel", "kernel", 0.50, 0.10, 7, correlation=3)]
    if spans:
        events += [
            _ev("gwnet.diffusion", "user_annotation", 0.05, 0.20, 1),
            _ev("sparse.spmm", "user_annotation", 0.055, 0.01, 1),
            _ev("gwnet.diffusion", "user_annotation", 0.40, 0.30, 2),
            _ev("sparse.spmm", "user_annotation", 0.44, 0.02, 2)]
    return devtrace.Trace(events)


def _reading(trace, sizes=True):
    cfg = json.loads((REPO / "bench_gpu/configs/gwnet_gla.json").read_text())
    hp = cfg["model"]["gwnet"]
    win = dict(road_nnz=[98_700, 98_700])
    if sizes:
        win.update(block=128, padded=3840,
                   spmm_blocks=dict(forward=[115, 115], backward=[118, 118]))
    return types.SimpleNamespace(
        trace=trace, profiled=1, window=win, config=cfg, costs=costs,
        model=hp, batch=64, frames=24, joints=3834, bf16=False,
        directions=1, peak_flops=costs.PEAK_F32_DOT_FLOPS)


def _read(ns, names=NEW):
    return {m: run.load_reader(REPO, "metrics", m).read(ns) for m in names}


def test_new_readers_on_a_synthetic_trace():
    got = _read(_reading(_trace()))
    assert got["diffusion_device_ms.forecast"] == pytest.approx(290.0)
    assert got["spmm_device_ms.forecast"] == pytest.approx(150.0)
    assert _read(_reading(_trace()), ["idle_share.train"])[
        "idle_share.train"] == pytest.approx(71.0)
    bound = costs_gwnet.spmm_bound_s(
        _reading(None).model, 64, dict(forward=[115, 115],
                                       backward=[118, 118]), 128, 3840)
    assert got["roofline.spmm.forecast"] == pytest.approx(
        100 * bound / 0.15)
    flops = costs_gwnet.step_flops(_reading(None).model, 64,
                                   [98_700, 98_700])
    assert got["mfu.forecast"] == pytest.approx(
        100 * flops / (0.29 * costs.PEAK_F32_DOT_FLOPS))


def test_spmm_launches_count_inside_an_autograd_node():
    """A kernel whose ``External id`` names the autograd Function around
    the span (as the profiler records a launch inside ``_SpmmFunction``)
    still counts for the span its launch call lies in."""
    events = [_ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
              _ev("_SpmmFunction", "cpu_op", 0.05, 0.05, 1,
                  **{"External id": 9}),
              _ev("sparse.spmm", "user_annotation", 0.06, 0.03, 1),
              _ev("cudaLaunchKernelExC", "cuda_runtime", 0.07, 0.001, 1,
                  correlation=4),
              _ev("spmm_kernel", "kernel", 0.08, 0.2, 7, correlation=4,
                  **{"External id": 9})]
    got = _read(_reading(devtrace.Trace(events)))
    assert got["spmm_device_ms.forecast"] == pytest.approx(200.0)


def test_new_readers_read_nothing_without_spans_or_sizes():
    none = _read(_reading(_trace(spans=False)))
    assert none["diffusion_device_ms.forecast"] is None
    assert none["spmm_device_ms.forecast"] is None
    assert none["roofline.spmm.forecast"] is None
    assert _read(_reading(_trace(), sizes=False))[
        "roofline.spmm.forecast"] is None
    assert set(_read(_reading(None)).values()) == {None}


def test_shared_readers_read_the_forecast_window(tiny):
    """The training cells' readers read the forecast loop's own window
    (its walls and samples) and a trace of it, the engine's spans too."""
    loaded = run.load_cell(tiny, CELL)
    h = run.Harness(torch, loaded, SEED, 0.5, "cpu", timed=False)
    st = forecast.setup(h)
    win = forecast.window(h, st)
    forecast.release(st)
    trace = _trace()
    for name, start, dur in (("engine.forward", 0.0, 0.3),
                             ("engine.backward", 0.3, 0.5),
                             ("engine.optimizer", 0.8, 0.1),
                             ("engine.sync", 0.9, 0.1)):
        trace.host[1].append(dict(name=name, cat="user_annotation",
                                  ts=start, end=start + dur, tid=1,
                                  args={}))
    for evs in trace.host.values():
        evs.sort(key=lambda ev: (ev["ts"], -ev["end"]))
    ns = run.reading(h, forecast, win, trace, profiled=1)
    got = _read(ns, SHARED + SPANS)
    assert None not in got.values(), got
    assert got["forward_device_ms.train"] == pytest.approx(190.0)
    assert got["backward_device_ms.train"] == pytest.approx(100.0)
    assert got["launches.train"] == 3
    assert got["samples_per_s.train"] == pytest.approx(
        win["samples"] / win["seconds"])


def test_step_flops_count_the_layers():
    model = json.loads((REPO / "bench_gpu/configs/gwnet_gla.json")
                       .read_text())["model"]["gwnet"]
    assert costs_gwnet.lengths(model, 12) == [12, 10, 9, 7, 6, 4, 3, 1]
    # the adaptive hops alone, forward: 2 V^2 N C sum(L) x 2 hops
    v, f = 3834, 64 * 32 * 52
    forward = 2 * 2 * v * v * f
    assert 3 * forward * 0.9 < costs_gwnet.step_flops(model, 64, [0, 0]) \
        < 3 * forward * 1.2
    assert costs_gwnet.transposed_blocks([0, 0, 1], [0, 2, 1], 3) == 3


def test_load_cell_finds_the_cells_files_by_name():
    loaded = run.load_cell(REPO, CELL)
    assert loaded["config"]["name"] == "gwnet_gla"
    assert loaded["traffic"]["loop"] == "forecast"
    assert check.limits_file("forecast", "float32", REPO).is_file()
    assert {m["name"] for m in loaded["per_layer"]} == set(NEW + SHARED)
    assert [m["name"] for m in loaded["end_to_end"]] == [
        "train_step_device_ms", "setup_s"]
    for m in NEW + SHARED:
        assert (REPO / "bench_gpu/metrics" / f"{m}.py").is_file()
    model = loaded["config"]["model"]["gwnet"]
    for key in ("input_time_frame", "output_time_frame",
                "joints_to_consider"):
        assert key in model
