"""The port's multi-process launch on the CPU: ``parallel.distributed.
initialize``, the loader's split by process, and the launch recipe itself
(two ``python -m dstdgcn_tpu_torch.main`` processes with the ``DSTDGCN_*``
variables over gloo) against one process.

The two-process run trains a narrowed ``synthetic_h36m_dp_train`` (8
features, 1 layer, dropout 0 so that no rank's masks enter, 64 train and 32
test sequences at a global batch of 32): rank 0's ``training_loss.csv``
must match the one-process run's within 1e-5 relative (the two-rank sums
run in another order).  Every wait is bounded and the ranks are killed on a
failure.
"""

import csv
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader
from dstdgcn_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parent.parent
#: seconds a launch may take before its processes are killed
LAUNCH_TIMEOUT = 240
LAUNCH_VARS = ("DSTDGCN_COORDINATOR", "DSTDGCN_NUM_PROCESSES",
               "DSTDGCN_PROCESS_ID", "DSTDGCN_BACKEND", "MASTER_ADDR",
               "WORLD_SIZE", "RANK")


@pytest.fixture
def no_launch_vars(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_initialize_without_block_or_variables_is_a_no_op(no_launch_vars):
    assert distributed.initialize(None, device="cpu") == (0, 1)
    assert distributed.process_info() == (0, 1)
    # coordinator: auto without a launcher's variables: one process
    assert distributed.initialize({"coordinator": "auto"},
                                  device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert distributed.device_of("cpu") == torch.device("cpu")


def _captured(monkeypatch):
    captured = {}

    def fake_init(backend, **kw):
        captured.update(kw, backend=backend)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    return captured


def test_initialize_environment_overrides_the_config(no_launch_vars):
    """The per-process variables beat the shipped block, as the JAX
    package's fix 8433b6a has it (``tests/test_parallel.py``)."""
    captured = _captured(no_launch_vars)
    no_launch_vars.setenv("DSTDGCN_COORDINATOR", "envhost:9")
    no_launch_vars.setenv("DSTDGCN_NUM_PROCESSES", "2")
    no_launch_vars.setenv("DSTDGCN_PROCESS_ID", "1")
    distributed.initialize({"coordinator": "auto", "num_processes": 8,
                            "process_id": 5}, device="cpu")
    assert captured == dict(backend="gloo", init_method="tcp://envhost:9",
                            world_size=2, rank=1,
                            timeout=distributed.TIMEOUT)


@pytest.mark.parametrize("device,block,env,want", [
    ("cpu", None, None, "gloo"),
    ("cuda", None, None, "nccl"),
    ("cuda", "gloo", None, "gloo"),
    ("cuda", "nccl", "gloo", "gloo"),
])
def test_initialize_backend_follows_the_device_unless_named(
        no_launch_vars, device, block, env, want):
    captured = _captured(no_launch_vars)
    cfg = {"coordinator": "file:///nowhere", "num_processes": 2,
           "process_id": 0}
    if block:
        cfg["backend"] = block
    if env:
        no_launch_vars.setenv("DSTDGCN_BACKEND", env)
    distributed.initialize(cfg, device=device)
    assert captured["backend"] == want
    assert captured["init_method"] == "file:///nowhere"


def test_initialize_refuses_an_incomplete_launch(no_launch_vars):
    _captured(no_launch_vars)
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize({"coordinator": "h:1", "num_processes": 2},
                               device="cpu")


def test_loader_process_split_matches_the_jax_loader():
    """Each process's share of every global batch is the JAX loader's, and
    the shares interleave back into the global batch
    (``tests/test_parallel.py``'s split test)."""
    from dstdgcn_tpu.data import Loader as JLoader
    rng = np.random.RandomState(0)
    data = (rng.randn(40, 3).astype(np.float32),)
    full = Loader(data, 8, shuffle=True, seed=3, drop_last=True)
    shards = [Loader(data, 8, shuffle=True, seed=3, drop_last=True,
                     process_index=i, process_count=2) for i in range(2)]
    jshards = [JLoader(data, 8, shuffle=True, seed=3, drop_last=True,
                       process_index=i, process_count=2) for i in range(2)]
    for loader in (full, *shards, *jshards):
        loader.set_epoch(2)
    for (gb,), (s0,), (s1,), (j0,), (j1,) in zip(full, *shards, *jshards):
        assert s0.shape[0] == s1.shape[0] == gb.shape[0] // 2
        merged = np.empty_like(gb)
        merged[0::2], merged[1::2] = s0, s1
        np.testing.assert_array_equal(merged, gb)
        np.testing.assert_array_equal(s0, np.asarray(j0))
        np.testing.assert_array_equal(s1, np.asarray(j1))
    with pytest.raises(ValueError, match="split"):
        Loader(data, 7, process_index=0, process_count=2)


def _narrowed_config(path):
    import yaml
    cfg = configs.synthetic_h36m_dp_train()
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1,
                                   st_gcnn_dropout=0.0)
    cfg["dataset"]["train"]["synthetic"]["num_sequences"] = 64
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 32
    path.write_text(yaml.safe_dump(cfg))
    return path


def _main(config, run_dir, env):
    return subprocess.Popen(
        [sys.executable, "-m", "dstdgcn_tpu_torch.main", "--config",
         str(config), "--run_dir", str(run_dir), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_two_process_main_matches_one_process(tmp_path):
    config = _narrowed_config(tmp_path / "dp.yaml")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    two = tmp_path / "two"
    procs = [_main(config, two, dict(
        env, DSTDGCN_COORDINATOR=f"file://{tmp_path}/rendezvous",
        DSTDGCN_NUM_PROCESSES="2", DSTDGCN_PROCESS_ID=str(r)))
        for r in range(2)]
    procs.append(_main(config, tmp_path / "one", env))
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p, log in zip(("rank 0", "rank 1", "one process"), procs,
                            logs):
        assert p.returncode == 0, f"{name} failed:\n{log[-6000:]}"
    head2, rows2 = _read_csv(two / "training_loss.csv")
    head1, rows1 = _read_csv(tmp_path / "one" / "training_loss.csv")
    assert head2 == head1 and rows2.shape == rows1.shape == (3, 12)
    np.testing.assert_allclose(rows2, rows1, rtol=1e-5)
    for ckpt in ("last.ckpt", "best.ckpt"):
        assert (two / "checkpoints" / ckpt).is_file()
    # rank 0 alone logs: one process's lines in the shared log.txt
    log = (two / "log.txt").read_text()
    assert "rank: 0 of 2" in log and "rank: 1 of 2" not in log
    assert "process mesh: {'data': 2, 'graph': 1}" in log


def _files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_two_process_graph_axis_main_matches_one_process(tmp_path):
    """``synthetic_h36m_fast_graph_train`` (the fast variant with the joint
    axis over two ranks) cut to 8 features, 1 layer, dropout 0 and 128
    train and 64 test sequences, launched as two ``main`` processes, each
    with a run directory of its own: rank 0's ``training_loss.csv`` within
    1e-4 relative of one process's, and rank 1 writes no file."""
    import yaml
    cfg = configs.synthetic_h36m_fast_graph_train()
    cfg["model"]["dstdgcn_fast"].update(num_feature=8, num_layers=1,
                                        st_gcnn_dropout=0.0)
    cfg["dataset"]["train"]["synthetic"]["num_sequences"] = 128
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 64
    config = tmp_path / "graph.yaml"
    config.write_text(yaml.safe_dump(cfg))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    dirs = [tmp_path / f"rank{r}" for r in range(2)] + [tmp_path / "one"]
    procs = [_main(config, dirs[r], dict(
        env, DSTDGCN_COORDINATOR=f"file://{tmp_path}/rendezvous",
        DSTDGCN_NUM_PROCESSES="2", DSTDGCN_PROCESS_ID=str(r)))
        for r in range(2)]
    procs.append(_main(config, dirs[2], env))
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p, log in zip(("rank 0", "rank 1", "one process"), procs,
                            logs):
        assert p.returncode == 0, f"{name} failed:\n{log[-6000:]}"
    head2, rows2 = _read_csv(dirs[0] / "training_loss.csv")
    head1, rows1 = _read_csv(dirs[2] / "training_loss.csv")
    assert head2 == head1 and rows2.shape == rows1.shape == (3, 8)
    np.testing.assert_allclose(rows2, rows1, rtol=1e-4)
    for ckpt in ("last.ckpt", "best.ckpt"):
        assert (dirs[0] / "checkpoints" / ckpt).is_file()
    assert _files_under(dirs[1]) == []
    assert "process mesh: {'data': 1, 'graph': 2}" in (
        dirs[0] / "log.txt").read_text()
