"""The readers of the program's spans (``bench_gpu/spans.py`` and the
per-layer metrics that use it) on synthetic traces: launches from another
thread inside ``engine.backward``, an idle gap split across two spans, the
idle breakdown labelled by the spans, and None where there is no trace or
no span (a program that names no phase)."""

from __future__ import annotations

import ast
import json
import types

import pytest

from gpubench_tiny import REPO

from bench_gpu import costs, devtrace, run, spans

TRAIN = ["forward_device_ms.train", "backward_device_ms.train",
         "optimizer_device_ms.train", "forward_idle_ms.train",
         "backward_idle_ms.train", "optimizer_idle_ms.train",
         "sync_wait_ms.train", "roofline.dstd_fwd.train"]
EVAL = ["forward_idle_ms.eval", "metric_idle_ms.eval",
        "readback_wait_ms.eval"]


def _ev(name, cat, ts, dur, tid, **args):
    us = 1e6
    return dict(ph="X", name=name, cat=cat, ts=ts * us, dur=dur * us,
                tid=tid, args=args)


def _launch(ts, corr, tid=1, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _ev(name, cat, ts, 0.005, tid, correlation=corr)


def _device(name, ts, dur, corr, cat="kernel"):
    return _ev(name, cat, ts, dur, 7, correlation=corr)


def _train_trace(program_spans=True):
    """One step on the driving thread (1): the forward launches a kernel
    inside a DSTD-GC op's span and a cast after it; autograd's thread (2)
    launches the backward kernel while thread 1 waits in
    ``engine.backward``; the optimizer launches one kernel; the sync reads
    the losses back (a copy).  Busy: [0.15, 0.25], [0.30, 0.33],
    [0.50, 0.62], [0.74, 0.78], [0.86, 0.87]."""
    events = [
        _ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
        _launch(0.12, 1), _device("fwd", 0.15, 0.10, 1),
        _launch(0.30, 2), _device("cast", 0.30, 0.03, 2),
        _ev("_DSTDFunctionBackward", "cpu_op", 0.40, 0.20, 2),
        _launch(0.45, 3, tid=2, name="cuLaunchKernelEx", cat="cuda_driver"),
        _device("bwd", 0.50, 0.12, 3),
        _launch(0.72, 4), _device("adam", 0.74, 0.04, 4),
        _launch(0.85, 5, name="cudaMemcpyAsync"),
        _device("copy", 0.86, 0.01, 5, cat="gpu_memcpy"),
    ]
    if program_spans:
        events += [
            _ev("engine.step", "user_annotation", 0.02, 0.93, 1),
            _ev("engine.forward", "user_annotation", 0.05, 0.30, 1),
            _ev("dstd.op", "user_annotation", 0.10, 0.10, 1),
            _ev("engine.backward", "user_annotation", 0.35, 0.35, 1),
            _ev("engine.optimizer", "user_annotation", 0.70, 0.10, 1),
            _ev("engine.sync", "user_annotation", 0.80, 0.10, 1),
        ]
    return devtrace.Trace(events)


def _eval_trace():
    """One batch: the forward launches a kernel, the metric one more, the
    read-back copies the metric to the host."""
    return devtrace.Trace([
        _ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
        _ev("engine.eval_forward", "user_annotation", 0.10, 0.30, 1),
        _launch(0.20, 1), _device("fwd", 0.25, 0.20, 1),
        _ev("engine.eval_metric", "user_annotation", 0.40, 0.20, 1),
        _launch(0.50, 2), _device("norm", 0.55, 0.03, 2),
        _ev("engine.readback", "user_annotation", 0.60, 0.30, 1),
        _launch(0.61, 3, name="cudaMemcpyAsync"),
        _device("copy", 0.62, 0.01, 3, cat="gpu_memcpy"),
    ])


def _reading(trace, profiled=2):
    cfg = json.loads((REPO / "bench_gpu/configs/h36m_tpu.json").read_text())
    return types.SimpleNamespace(
        trace=trace, profiled=profiled, config=cfg, costs=costs,
        model=cfg["model"]["dstdgcn"], batch=128, frames=35, joints=22,
        bf16=True, directions=2, peak_flops=costs.PEAK_BF16_FLOPS)


def _read(names, ns):
    return {m: run.load_reader(REPO, "metrics", m).read(ns) for m in names}


def test_span_intervals_device_and_idle_seconds():
    tr = _train_trace()
    assert spans.intervals(tr, "engine.forward") == [
        pytest.approx((0.05, 0.35))]
    assert spans.intervals(tr, "engine.eval_forward") == []
    # the backward kernel was launched from thread 2, inside the span
    assert spans.device_s(tr, "engine.backward") == pytest.approx(0.12)
    assert spans.device_s(tr, "engine.forward") == pytest.approx(0.13)
    assert spans.device_s(tr, "dstd.op") == pytest.approx(0.10)
    # the gap [0.33, 0.50] lies across the forward and the backward
    assert spans.idle_s(tr, "engine.forward") == pytest.approx(
        0.10 + 0.05 + 0.02)
    assert spans.idle_s(tr, "engine.backward") == pytest.approx(
        0.15 + 0.08)
    assert spans.idle_s(tr, "engine.optimizer") == pytest.approx(0.06)
    assert spans.host_s(tr, "engine.sync") == pytest.approx(0.10)
    # nothing counted twice: the three phases and the sync's copy make the
    # busy time
    phases = ("engine.forward", "engine.backward", "engine.optimizer")
    assert sum(spans.device_s(tr, p) for p in phases) + 0.01 == \
        pytest.approx(tr.busy_s())
    assert sum(spans.idle_s(tr, p) for p in phases) == pytest.approx(0.46)


def test_train_readers_on_a_synthetic_trace():
    ns = _reading(_train_trace())
    got = _read(TRAIN, ns)
    want = {"forward_device_ms.train": 0.13, "backward_device_ms.train":
            0.12, "optimizer_device_ms.train": 0.04,
            "forward_idle_ms.train": 0.17, "backward_idle_ms.train": 0.23,
            "optimizer_idle_ms.train": 0.06, "sync_wait_ms.train": 0.10}
    for name, seconds in want.items():
        assert got[name] == pytest.approx(1e3 * seconds / 2), name
    bound = costs.ops_bound_s(ns.model, 128, 35, 22, backward=False)
    assert got["roofline.dstd_fwd.train"] == pytest.approx(
        100 * bound * 2 * 2 / 0.10)


def test_idle_breakdown_names_the_program_spans():
    """With the spans, no idle gap of the step lies outside any operation:
    each takes the driving thread's innermost span, or the operation that
    another thread runs."""
    gaps = dict(_train_trace().idle_gaps())
    assert "outside any operation" not in gaps
    assert gaps["engine.forward"] == pytest.approx(0.15 + 0.05)
    assert gaps["_DSTDFunctionBackward"] == pytest.approx(0.17)
    assert gaps["engine.step"] == pytest.approx(0.13)
    bare = dict(_train_trace(program_spans=False).idle_gaps())
    assert bare["outside any operation"] == pytest.approx(0.70 - 0.17)


def test_eval_readers_on_a_synthetic_trace():
    got = _read(EVAL, _reading(_eval_trace(), profiled=1))
    assert got["forward_idle_ms.eval"] == pytest.approx(1e3 * 0.15)
    assert got["metric_idle_ms.eval"] == pytest.approx(1e3 * 0.12)
    assert got["readback_wait_ms.eval"] == pytest.approx(1e3 * 0.30)


@pytest.mark.parametrize("trace", ["none", "empty", "no_spans"])
def test_readers_read_nothing_without_spans(trace):
    """No trace, an empty one (a run on the CPU), or a program that names
    no phase (an older commit): every reader None."""
    tr = dict(none=None, empty=devtrace.Trace([]),
              no_spans=_train_trace(program_spans=False))[trace]
    got = _read(TRAIN + EVAL, _reading(tr))
    assert all(v is None for v in got.values()), got
    none = _read(TRAIN, _reading(_train_trace(), profiled=0))
    assert none == dict.fromkeys(TRAIN)


def test_every_new_metric_is_in_the_benchmark():
    """Each reader here has its entry, with the cells its spans exist in,
    and the helper imports nothing of the port or of JAX."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in TRAIN:
        assert entries[name]["workloads"] == ["h36m_tpu.train",
                                              "cmu_tpu.train"], name
        assert entries[name]["moves"] == "train_step_device_ms"
    for name in EVAL:
        assert entries[name]["workloads"] == ["h36m_tpu.eval"], name
        assert entries[name]["moves"] == "eval_samples_per_s"
    tree = ast.parse((REPO / "bench_gpu/spans.py").read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"dstdgcn_tpu_torch", *run.FORBIDDEN}
