"""The dense adaptive hop's readers (``dense_hop_device_ms.forecast``,
``roofline.dense_hop.forecast``) on synthetic traces: what the
``dense.hop`` spans launched, on the forward's thread and on autograd's,
counts; without the span (the program before it had one) both read None;
the step's bound at the forecast configuration is the 112.4 ms its shapes
give (V 3,834, batch 64, 32 channels, layers of lengths 12, 10, 9, 7, 6, 4,
3 and 1, two hops, 44 products)."""

from __future__ import annotations

import json
import types

import pytest

from gpubench_tiny import REPO

from bench_gpu import devtrace, run

NEW = ["dense_hop_device_ms.forecast", "roofline.dense_hop.forecast"]


def _ev(name, cat, ts, dur, tid, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts * 1e6, dur=dur * 1e6,
                tid=tid, args=args)


def _trace(spans=True):
    """One step: the forward's hop span launches a kernel of 0.04 s on
    thread 1, a product outside the span (0.2 s) does not count; autograd's
    thread 2 launches the backward's two products (0.05 s and 0.07 s)
    inside a span of its own."""
    events = [_ev(devtrace.WINDOW, "user_annotation", 0.0, 1.0, 1),
              _ev("cudaLaunchKernel", "cuda_runtime", 0.06, 0.001, 1,
                  correlation=1),
              _ev("gemm_kernel", "kernel", 0.10, 0.04, 7, correlation=1),
              _ev("cudaLaunchKernel", "cuda_runtime", 0.16, 0.001, 1,
                  correlation=2),
              _ev("sgemm", "kernel", 0.16, 0.2, 7, correlation=2),
              _ev("cudaLaunchKernelExC", "cuda_runtime", 0.45, 0.001, 2,
                  correlation=3),
              _ev("gemm_kernel", "kernel", 0.50, 0.05, 7, correlation=3),
              _ev("cudaLaunchKernelExC", "cuda_runtime", 0.46, 0.001, 2,
                  correlation=4),
              _ev("gemm_kernel", "kernel", 0.56, 0.07, 7, correlation=4)]
    if spans:
        events += [
            _ev("dense.hop", "user_annotation", 0.055, 0.01, 1),
            _ev("dense.hop", "user_annotation", 0.44, 0.03, 2)]
    return devtrace.Trace(events)


def _model():
    cfg = json.loads((REPO / "bench_gpu/configs/gwnet_gla.json").read_text())
    return cfg["model"]["gwnet"]


def _reading(trace, profiled=1):
    return types.SimpleNamespace(trace=trace, profiled=profiled,
                                 window={}, model=_model(), batch=64)


def _read(ns, names=NEW):
    return {m: run.load_reader(REPO, "metrics", m).read(ns) for m in names}


def _bound_s():
    return run.load_reader(REPO, "metrics",
                           "roofline.dense_hop.forecast").bound_s(_model(), 64)


def test_readers_on_a_synthetic_trace():
    got = _read(_reading(_trace()))
    assert got["dense_hop_device_ms.forecast"] == pytest.approx(160.0)
    assert got["roofline.dense_hop.forecast"] == pytest.approx(
        100 * _bound_s() / 0.16)


@pytest.mark.parametrize("profiled", [1, 2])
def test_readers_count_per_profiled_step(profiled):
    got = _read(_reading(_trace(), profiled))
    assert got["dense_hop_device_ms.forecast"] == pytest.approx(
        160.0 / profiled)
    assert got["roofline.dense_hop.forecast"] == pytest.approx(
        100 * _bound_s() * profiled / 0.16)


def test_readers_read_nothing_without_the_span():
    assert set(_read(_reading(_trace(spans=False))).values()) == {None}
    assert set(_read(_reading(None)).values()) == {None}
    assert set(_read(_reading(_trace(), profiled=0)).values()) == {None}


def test_the_bound_at_the_forecast_configuration():
    """44 products of 2 V^2 F at 164.9 TFLOP/s, every one bound by its
    products: 2 hops x (52 forward + 2 x 51 backward) units of L, each
    2 V^2 (64 x 32) products."""
    bound = _bound_s()
    assert bound == pytest.approx(0.1124, rel=5e-3)
    v, unit = 3834, 64 * 32
    assert bound == pytest.approx(
        2 * (52 + 2 * 51) * 2 * v * v * unit / (494.7e12 / 3))


def test_the_new_entries_name_the_forecast_cell_alone():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        entry = entries[name]
        assert entry["workloads"] == ["gwnet_gla.forecast"]
        assert entry["layer"] == "Kernels, dense"
        assert entry["moves"] == "train_step_device_ms"
        assert entry["source"] == "device_trace"
        assert (REPO / "bench_gpu/metrics" / f"{name}.py").is_file()
    assert entries[NEW[0]]["unit"] == "ms/step"
    assert entries[NEW[0]]["better"] == "lower"
    assert entries[NEW[1]]["unit"] == "%"
    assert entries[NEW[1]]["better"] == "higher"
