"""The port's real-data slice against the JAX runner on the CPU.

An H36M expmap tree written by ``chip_smoke.write_h36m_tree`` (subject 5,
all 15 actions: the test split) goes through the JAX ``H36MRunner`` and the
port's with the same weights: the JAX engine's, every parameter moved by
seeded noise so that the gates take part, carried across by
``utils/bridge.py::load_flax_variables`` and loaded by each runner from a
checkpoint of its own package.  ``_eval_all_actions``, the
``testing_loss.csv`` of ``test`` mode and the ``test-all`` table agree
column by column within 1e-4 relative, under the same headers.  The
BatchNorm statistics are calibrated on a test batch (``chip_smoke.py``'s
``calibrate_batchnorm``, through the port, carried back by
``to_flax_variables``), so the activations stay O(1) as in a trained model
rather than growing about 10x a block.  The model runs at 8 features and 2
layers; the JAX model on its plain ops (``use_pallas`` False), the port's
through its kernel wrappers (their plain versions on the CPU).
"""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from dstdgcn_tpu.engine.checkpoint import save_checkpoint
from dstdgcn_tpu.runner import get_runner as jax_get_runner
from dstdgcn_tpu.utils.logging import setup_logger as jax_setup_logger
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import define_actions, get_dataset
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.runner import get_runner
from dstdgcn_tpu_torch.utils.bridge import (load_flax_variables,
                                            to_flax_variables)
from dstdgcn_tpu_torch.utils.config import resolve
from dstdgcn_tpu_torch.utils.logging import setup_logger

torch.set_num_threads(2)

RTOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Subject 5 alone, 15 actions x 2 subactions of 210 raw frames: 105
    after downsampling, 5 ``all``-mode windows a subaction."""
    root = tmp_path_factory.mktemp("h36m")
    return cs.write_h36m_tree(str(root), seed=5, subjects=(5,),
                              test_frames=210)


def _config(tree, run_dir, mode):
    cfg = configs.set_data_paths(configs.real_h36m_train(), tree, tree)
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=2)
    cfg["test_batch_size"] = 8
    cfg["mode"] = mode
    cfg["save"]["path"]["base"] = str(run_dir)
    return cfg


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _numbers(rows):
    return np.array([[float(v) for v in row if not v.isalpha()]
                     for row in rows])


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):
    """Run directories of both packages, each with a checkpoint of the same
    weights: the JAX engine's, moved off their init, with BatchNorm
    statistics calibrated on a test batch."""
    base = tmp_path_factory.mktemp("runs")
    jcfg = resolve(_config(tree, base / "jax", "test"))
    jcfg["model"]["use_pallas"] = False
    jcfg["logger"] = jax_setup_logger("jax_real_slice", str(base / "jax"))
    jrunner = jax_get_runner("h36m", copy.deepcopy(jcfg))
    sample = np.zeros((1, 35, 66), np.float32)
    state = jrunner.engine.init(sample)
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), state.params)

    cfg = _config(tree, base / "port", "test")
    cfg["logger"] = setup_logger("port_real_slice", str(base / "port"))
    runner = get_runner("h36m", cfg, device="cpu")
    engine = runner.engine
    engine.init()
    load_flax_variables(engine.model, {
        "params": params,
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    test = dict(resolve(cfg)["dataset"]["test"]["h36m"], actions="walking")
    batch = get_dataset("h36m", h36m=test).input_seqs[:8]
    cs.calibrate_batchnorm(torch, engine.model,
                           engine.transform(engine.to_device(batch)))
    engine.save(str(base / "port_ckpt"), 1.0, 0)
    back = to_flax_variables(engine.model)
    state = state.replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, back["batch_stats"]))
    jckpt = base / "jax.ckpt"
    save_checkpoint(str(jckpt), state, dict(lr=3e-3, err=1.0, epoch=0))
    return dict(base=base, jcfg=jcfg, jckpt=str(jckpt),
                ckpt=str(base / "port_ckpt" / "last.ckpt"))


def _runs(tree, weights, mode):
    """(JAX run dir, port run dir) after ``mode`` from the shared weights;
    the runners too."""
    base = weights["base"]
    jcfg = copy.deepcopy({k: v for k, v in weights["jcfg"].items()
                          if k != "logger"})
    jcfg.update(mode=mode, logger=weights["jcfg"]["logger"])
    jcfg["model"].update(load=True, ckpt=weights["jckpt"])
    jcfg["save"]["path"]["base"] = str(base / f"jax_{mode}")
    os.makedirs(jcfg["save"]["path"]["base"], exist_ok=True)
    jrunner = jax_get_runner("h36m", jcfg)
    jrunner.run()
    cfg = _config(tree, base / f"port_{mode}", mode)
    cfg["model"].update(load=True, ckpt=weights["ckpt"])
    runner, _ = run(cfg, "cpu")
    return (base / f"jax_{mode}", base / f"port_{mode}", jrunner, runner)


def test_eval_all_actions_and_testing_loss_match_the_jax_runner(tree,
                                                                 weights):
    jdir, pdir, jrunner, runner = _runs(tree, weights, "test")
    jhead, jrows = _read(jdir / "testing_loss.csv")
    head, rows = _read(pdir / "testing_loss.csv")
    assert head == jhead and len(head) == 1 + 8 + 15 * 8
    assert head[:3] == ["test_loss", "3d80", "3d160"]
    assert head[-1] == "walkingtogether3d1000"
    got, want = _numbers(rows), _numbers(jrows)
    assert got.shape == want.shape == (1, 129)
    # calibrated: MPJPE of the order of the poses' millimetres
    assert np.all(np.isfinite(got)) and np.all((got > 1) & (got < 1e4))
    np.testing.assert_allclose(got, want, rtol=RTOL)

    # _eval_all_actions on both runners' loaded engines, directly
    acts = define_actions("all", "h36m")
    jres = jrunner._eval_all_actions(acts, jrunner._build_test_loaders(acts),
                                     None, None)
    res = runner._eval_all_actions(acts, runner._build_test_loaders(acts),
                                   None, None)
    assert res[3] == jres[3] == head
    assert res[0] == pytest.approx(jres[0], rel=RTOL)
    np.testing.assert_allclose(res[1], jres[1], rtol=RTOL)
    np.testing.assert_allclose(res[2], jres[2], rtol=RTOL)
    np.testing.assert_allclose(res[2], got[0], rtol=1e-12)
    # 15 actions x 10 windows, batches of 8: 2 batches an action
    assert len(runner.test_batch_seconds) == 30


def test_test_all_table_matches_the_jax_runner(tree, weights):
    jdir, pdir, _, runner = _runs(tree, weights, "test-all")
    jhead, jrows = _read(jdir / "testing_loss.csv")
    head, rows = _read(pdir / "testing_loss.csv")
    assert head == jhead == ["action", "avg"] + [str(40 * (i + 1))
                                                 for i in range(25)]
    assert [r[0] for r in rows] == [r[0] for r in jrows] == (
        define_actions("all", "h36m") + ["average"])
    got, want = _numbers(rows), _numbers(jrows)
    assert got.shape == want.shape == (16, 26)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
