"""The harness on the CPU at a tiny size: a run end to end, the look for a
card, cells found by name, the import rules, and the faults and the
control that ``correct`` has to catch."""

from __future__ import annotations

import ast
import functools
import io
import json
from pathlib import Path

import pytest
import torch

from gpubench_tiny import REPO, SEED, make_copy, run_cell

from bench_gpu import check, faults, reference, run
from bench_gpu.loops import eval as eval_loop
from bench_gpu.loops import train as train_loop


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["h36m_tpu.train", "cmu_tpu.train",
                                      "h36m_tpu.eval"])
def test_sound_run_prints_the_contract_line(tiny, workload):
    rc, res, err = run_cell(tiny, workload)
    assert rc == 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    for name, c in res["checks"].items():
        assert c["value"] is not None
        assert f"{name} " in err.strip().splitlines()[-len(res["checks"]):][
            list(res["checks"]).index(name)]


def test_without_a_card_no_result(tiny):
    """No CUDA device: exit code 2 and nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(["--workload", "h36m_tpu.train", "--seed", "1",
                  "--seconds", "1"], root=tiny, out=out, err=err)
    assert rc == 2 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_new_files_found_by_name(tiny, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, and entries in BENCHMARK.json, with no file edited."""
    root = make_copy(tmp_path / "copy")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench_gpu/configs/h36m_tpu.json").read_text())
    cfg["name"] = "h36m_wide"
    cfg["model"]["dstdgcn"]["num_feature"] = 12
    (root / "bench_gpu/configs/h36m_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "bench_gpu/traffic/train.json").read_text())
    mix["pool_sequences"] = 48
    (root / "bench_gpu/traffic/train_small.json").write_text(json.dumps(mix))
    (root / "bench_gpu/metrics/steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.window['steps'])\n")
    (root / "bench_gpu/end_to_end/train_steps_per_s.py").write_text(
        "def read(run):\n"
        "    return run.window['steps'] / run.window['seconds']\n")
    bench["configs"].append(dict(bench["configs"][0], name="h36m_wide",
                                 file="bench_gpu/configs/h36m_wide.json"))
    bench["workloads"].append(dict(name="h36m_wide.train_small",
                                   config="h36m_wide",
                                   traffic="train_small", chips=1,
                                   why="a throwaway cell"))
    bench["per_layer"].append(dict(
        name="steps_seen.train", unit="steps", better="higher",
        source="host_clock", layer="Model step",
        moves="train_step_device_ms", workloads=["h36m_wide.train_small"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and "h36m_tpu.train" in m["workloads"]:
            m["workloads"].append("h36m_wide.train_small")
    bench["end_to_end"].append(dict(
        name="train_steps_per_s", unit="steps/s", better="higher",
        bound=0.05, source="host_clock",
        workloads=["h36m_wide.train_small"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, _ = run_cell(root, "h36m_wide.train_small", trace=1)
    assert rc == 0
    assert res["metrics"]["steps_seen.train"]["value"] > 0
    rc, res, _ = run_cell(root, "h36m_wide.train_small")
    assert rc == 0
    assert res["metrics"]["train_steps_per_s"]["value"] > 0
    loaded = run.load_cell(root, "h36m_wide.train_small")
    assert loaded["config"]["model"]["dstdgcn"]["num_feature"] == 12
    assert loaded["traffic"]["pool_sequences"] == 48


def test_a_precision_without_limits_does_not_run(tmp_path):
    """A configuration at a precision with no limits table of its loop
    exits with code 2 and prints no result; with the table as a new file,
    the cell runs under it."""
    root = make_copy(tmp_path / "copy")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench_gpu/configs/h36m_tpu.json").read_text())
    cfg.update(name="h36m_f32", precision="float32")
    cfg["model"]["dstdgcn"]["compute_dtype"] = None
    (root / "bench_gpu/configs/h36m_f32.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="h36m_f32",
                                 file="bench_gpu/configs/h36m_f32.json"))
    bench["workloads"].append(dict(name="h36m_f32.train", config="h36m_f32",
                                   traffic="train", chips=1,
                                   why="a throwaway cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(root, "h36m_f32.train")
    assert rc == 2 and res is None and "no limits" in err
    table = dict(limits=dict(loss_gap=1e-6, grad_gap=1e-4))
    (root / "bench_gpu/limits/train.float32.json").write_text(
        json.dumps(table))
    rc, res, _ = run_cell(root, "h36m_f32.train")
    assert rc == 0 and set(res["checks"]) == set(table["limits"])
    assert res["correct"] is True, res["checks"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_rules():
    """No module of the benchmark imports JAX or the JAX package, and the
    reference and the yardstick import nothing of the port; top-level
    names compared whole."""
    files = sorted((REPO / "bench_gpu").rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path
    for name in ("reference.py", "costs.py", "windows.py", "check.py",
                 "devtrace.py"):
        tops = {n.split(".")[0] for n in _imports(REPO / "bench_gpu" / name)}
        assert "dstdgcn_tpu_torch" not in tops, name


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "dstdgcn_tpu_torch_like",
                        types.ModuleType("dstdgcn_tpu_torch_like"))
    assert "dstdgcn_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("workload,fault", [
    ("h36m_tpu.train", "frozen"), ("h36m_tpu.train", "half_batch"),
    ("h36m_tpu.train", "late_half_batch"),
    ("h36m_tpu.eval", "swapped_answer")])
def test_fault_under_the_timed_path_is_not_correct(tiny, workload, fault):
    """The rest of a run, with the timed path broken underneath; the late
    fault after the tiny mix's 3 checked and 1 warm-up steps, so only the
    checked steps after the window see it."""
    loop = "train" if workload.endswith("train") else "eval"
    planted = faults.BY_LOOP[loop][fault]
    if fault.startswith("late_"):
        planted = functools.partial(planted, after=4)
    rc, res, _ = run_cell(tiny, workload, fault=planted)
    assert rc == 0
    assert res["correct"] is False
    if fault.startswith("late_"):
        failed = {k for k, c in res["checks"].items()
                  if not c["value"] <= c["limit"]}
        assert failed and all(k.startswith("post_") for k in failed), res


def test_sound_run_is_correct_on_the_cpu(tiny):
    """The same run with nothing planted reads true."""
    rc, res, _ = run_cell(tiny, "h36m_tpu.train")
    assert rc == 0 and res["correct"] is True, res["checks"]


@pytest.mark.parametrize("workload", ["h36m_tpu.train", "h36m_tpu.eval"])
def test_control_in_fp8_fails_a_limit(tiny, workload):
    """The reference computed in fp8 (the precision below the stated bf16)
    in the program's place fails at least one limit."""
    loaded = run.load_cell(tiny, workload)
    loop = loaded["traffic"]["loop"]
    h = run.Harness(torch, loaded, SEED, 0, "cpu", timed=False,
                    keep_all=True)
    if loop == "train":
        st = train_loop.setup(h)
        train_loop.after_window(h, st)
        _, (ref, _) = train_loop.verify(h, st)
        low = reference.train_steps(h.config, SEED, st["rows"], "cpu",
                                    reference.fp8)
        numbers = check.train_numbers(low, ref)
    else:
        st = eval_loop.setup(h)
        st["keep"] = True
        eval_loop._sweep(h, st, record=True)
        numbers = eval_loop.verify(h, st, None, reference.fp8)[0]
    table = check.limits(loop, loaded["config"]["precision"])
    ok, checks = check.judge(numbers, {k: v for k, v in table.items()
                                       if k in numbers})
    assert not ok, checks


@pytest.mark.cuda
def test_control_at_cell_size_on_the_card():
    """On the card at the cell's own size: the fp8 control fails a limit on
    three seeds, and the program passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_gpu import calibrate
    for workload in ("h36m_tpu.train", "h36m_tpu.eval"):
        loaded = run.load_cell(REPO, workload)
        table = check.limits(loaded["traffic"]["loop"],
                             loaded["config"]["precision"])
        for seed in (11, 12, 13):
            got = calibrate.readings(loaded, seed, "cuda", 2.0, [])
            for side, ok in (("program", True), ("control", False)):
                part = {k: v for k, v in table.items() if k in got[side]}
                assert check.judge(got[side], part)[0] is ok, got
