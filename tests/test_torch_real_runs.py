"""The port's real-data runners end to end on the CPU.

Seeded trees in each dataset's format (``chip_smoke.py``'s writers: every
H36M subject and action, every CMU action, two 3DPW sequence files) go
through ``dstdgcn_tpu_torch.main.run(..., "cpu")`` on the three slice
configs cut to 8 features and 2 layers, 1 epoch of 2 steps of batch 8:

* ``run_train`` for H36M, CMU and 3DPW writes ``training_loss.csv`` under
  the JAX runners' headers (H36M and CMU: epoch, lr, train_loss, test_loss,
  the 8 horizons, then each action's 8) with the best row appended, and
  both checkpoints;
* the recovery probe: ``test`` mode on ``best.ckpt`` reproduces the best
  row's test loss exactly, for H36M and CMU; ``test-all`` writes 15 action
  rows and an ``average`` row; 3DPW's ``test`` writes its horizons and its
  ``test-all`` raises, as the JAX runner's does;
* the CLI in ``--device cpu`` mode on a YAML form of ``real_h36m_train``;
* each slice config's YAML and dict forms agree, and hold the shipped
  config's blocks at full width.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import chip_smoke as cs
from dstdgcn_tpu.data.datasets import define_actions
from dstdgcn_tpu.runner.action_runner import _HORIZON_HEADS_LONG
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.main import run

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ("h36m", "cmu", "3dpw")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    h36m = cs.write_h36m_tree(str(root / "h36m"), seed=7, frames=80,
                              test_frames=210)
    return {"h36m": (h36m, h36m),
            "cmu": cs.write_cmu_tree(str(root / "cmu"), seed=8,
                                     files=(1, 1), frames=(120, 100)),
            "3dpw": cs.write_pw3d_tree(str(root / "3dpw"), seed=9,
                                       files=(2, 1), frames=(60, 50))}


def _config(name, paths, run_dir, mode="train"):
    cfg = configs.set_data_paths(getattr(configs, f"real_{name}_train")(),
                                 *paths[name])
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=2)
    cfg["train_batch_size"] = cfg["test_batch_size"] = 8
    cfg["epoch"] = 1
    cfg["engine"]["max_iter"] = 2
    cfg["mode"] = mode
    cfg["save"]["path"]["base"] = str(run_dir)
    return cfg


def _heads(name):
    if name == "3dpw":
        return ["test_loss"] + [f"3d{(f + 1) * 40}"
                                for f in (4, 9, 14, 19, 24)]
    return ["test_loss"] + _HORIZON_HEADS_LONG + [
        act + h for act in define_actions("all", name)
        for h in _HORIZON_HEADS_LONG]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def trained(paths, tmp_path_factory):
    out = {}
    for name in DATASETS:
        run_dir = tmp_path_factory.mktemp(f"train_{name}")
        tfused.reset_launch_counts()
        runner, history = run(_config(name, paths, run_dir), "cpu")
        out[name] = (run_dir, runner, history, tfused.launch_counts())
    return out


@pytest.mark.parametrize("name", DATASETS)
def test_run_train_writes_the_jax_runner_files(trained, name):
    run_dir, runner, history, counts = trained[name]
    assert runner.engine.device.type == "cpu"
    assert len(runner.engine.train_step_seconds) == 2
    rows = _rows(run_dir / "training_loss.csv")
    head = ["epoch", "lr", "train_loss"] + _heads(name)
    assert rows[0] == head
    assert len(head) == (3 + 9 + {"h36m": 15, "cmu": 8}[name] * 8
                         if name != "3dpw" else 9)
    # one epoch row, then the best row appended
    assert len(rows) == 3 and rows[1] == rows[2]
    got = np.array([float(v) for v in rows[1]])
    np.testing.assert_array_equal(got, history[0])
    assert got[0] == 1 and got[1] == pytest.approx(3e-3)
    assert np.all(np.isfinite(got))
    for ckpt in ("last.ckpt", "best.ckpt"):
        assert (run_dir / "checkpoints" / ckpt).is_file()
    # on CPU tensors the wrappers run the plain ops and count no launch
    assert set(counts.values()) == {0}
    assert set(runner.data_seconds) == {"train", "test"}


@pytest.mark.parametrize("name", ["h36m", "cmu"])
def test_recovery_probe_and_test_all(trained, paths, tmp_path, name):
    run_dir, _, history, _ = trained[name]
    cfg = _config(name, paths, tmp_path / "test", "test")
    cfg["model"].update(load=True, ckpt=str(run_dir / "checkpoints" /
                                            "best.ckpt"))
    runner, (avg, row) = run(cfg, "cpu")
    rows = _rows(tmp_path / "test" / "testing_loss.csv")
    assert rows[0] == _heads(name)
    assert float(rows[1][0]) == history[0][3] == avg
    np.testing.assert_array_equal([float(v) for v in rows[1]], history[0][3:])
    if name != "h36m":
        return
    cfg = _config(name, paths, tmp_path / "all", "test-all")
    cfg["model"].update(load=True, ckpt=str(run_dir / "checkpoints" /
                                            "best.ckpt"))
    _, table = run(cfg, "cpu")
    rows = _rows(tmp_path / "all" / "testing_loss.csv")
    assert rows[0] == ["action", "avg"] + [str(40 * (i + 1))
                                           for i in range(25)]
    assert [r[0] for r in rows[1:]] == define_actions("all", "h36m") + [
        "average"]
    values = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    assert values.shape == (16, 26) and np.all(np.isfinite(values))
    # every action has the same number of batches: a plain mean
    np.testing.assert_allclose(values[-1], values[:-1].mean(0), rtol=1e-12)
    assert [r[0] for r in table] == [r[0] for r in rows[1:]]


def test_pw3d_test_and_test_all(trained, paths, tmp_path):
    run_dir = trained["3dpw"][0]
    cfg = _config("3dpw", paths, tmp_path / "test", "test")
    cfg["model"].update(load=True, ckpt=str(run_dir / "checkpoints" /
                                            "best.ckpt"))
    _, (avg, per_frame) = run(cfg, "cpu")
    rows = _rows(tmp_path / "test" / "testing_loss.csv")
    assert rows[0] == _heads("3dpw") and len(rows[1]) == 6
    assert float(rows[1][0]) == avg == trained["3dpw"][2][0][3]
    cfg = _config("3dpw", paths, tmp_path / "all", "test-all")
    with pytest.raises(NotImplementedError, match="per-action"):
        run(cfg, "cpu")


def test_cli_cpu_mode_trains_real_h36m(paths, tmp_path):
    cfg = _config("h36m", paths, tmp_path / "unused")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dstdgcn_tpu_torch.main", "--run_dir",
         str(tmp_path / "run"), "--config", str(path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = _rows(tmp_path / "run" / "training_loss.csv")
    assert len(rows) == 3 and len(rows[1]) == 132
    for ckpt in ("last.ckpt", "best.ckpt"):
        assert (tmp_path / "run" / "checkpoints" / ckpt).is_file()


@pytest.mark.parametrize("name", DATASETS)
def test_slice_config_yaml_equals_dict(name):
    with open(os.path.join(REPO, "dstdgcn_tpu_torch", "configs",
                           f"real_{name}_train.yaml")) as f:
        raw = yaml.safe_load(f)
    assert raw == getattr(configs, f"REAL_{name.upper()}_TRAIN")
    with open(os.path.join(REPO, "configs", f"dstdgcn_{name}.yaml")) as f:
        shipped = yaml.safe_load(f)
    for block in ("runner", "dataset", "setting", "train_batch_size",
                  "test_batch_size"):
        assert raw[block] == shipped[block], block
    assert raw["model"]["dstdgcn"] == shipped["model"]["dstdgcn"]
    assert raw["model"]["dstdgcn"]["num_feature"] == 64
    assert raw["model"]["dstdgcn"]["num_layers"] == 5
    assert raw["model"]["use_pallas"] is True
    assert raw["epoch"] == 2 and raw["engine"]["max_iter"] == 8
    engine = dict(raw["engine"], max_iter=shipped["engine"]["max_iter"])
    assert engine == shipped["engine"]
