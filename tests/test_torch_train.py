"""The port's training side on the CPU, against the JAX package.

* the loss registry against ``dstdgcn_tpu/engine/losses.py`` (every key,
  with and without joint weights; float32, 1e-5 relative);
* ``steplr`` against the JAX schedule and torch's StepLR, and the clip rule
  against ``optax.clip_by_global_norm`` (1e-6 relative);
* the lockstep: the JAX ``PredictionEngine`` train step (``use_pallas``
  off) and the port's, from bridged weights on the same numpy batches,
  dropout 0, inverse training on, ``step_size: 1`` so that 20 steps over 3
  epochs cross two StepLR boundaries, weight decay and clip set.  Per-step
  ``total`` agrees to 1e-4 relative; the parameters and BatchNorm
  statistics after 20 steps agree to 1e-3 max(|p|, 1), compared through the
  reverse weight bridge;
* the reverse bridge against a flax init tree, the checkpoint round trip,
  the CLI in train mode, and the recovery probe (test mode on
  ``best.ckpt`` reproduces the best epoch's eval loss exactly).
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.engine import losses as jlosses
from dstdgcn_tpu.engine import steplr as jsteplr
from dstdgcn_tpu.graphs import skeleton as jsk
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine, steplr
from dstdgcn_tpu_torch.engine import losses as tlosses
from dstdgcn_tpu_torch.graphs import skeleton as tsk
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.utils.bridge import (flatten_tree, load_flax_variables,
                                            to_flax_variables)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = ["epoch", "lr", "train_loss", "test_loss", "3d80", "3d160", "3d320",
        "3d400", "3d560", "3d720", "3d880", "3d1000"]
SMALL = dict(input_channels=6, input_time_frame=10, output_time_frame=10,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=1, layout="h36m")


def _small_train_config(run_dir, epochs=2):
    """The training slice's config cut to CPU size: 8 features, 1 encoder
    layer, 16 train and 8 test sequences of T = 10 + 25 frames."""
    cfg = configs.synthetic_h36m_train()
    cfg["dataset"]["train"]["synthetic"]["num_sequences"] = 16
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 8
    cfg["train_batch_size"] = cfg["test_batch_size"] = 8
    cfg["epoch"] = epochs
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1)
    cfg["save"]["path"]["base"] = str(run_dir)
    return cfg


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("key", ["jl2", "tl2", "cl1", "cl2", "gm2", "bl2"])
def test_losses_match_jax(key, weighted):
    rng = np.random.RandomState(0)
    p = rng.randn(3, 6, 66).astype(np.float32) * 10
    t = rng.randn(3, 6, 66).astype(np.float32) * 10
    w = rng.rand(22).astype(np.float32) if weighted else None
    inc_j = jsk.bone_incidence("h36m")
    inc_t = tsk.bone_incidence("h36m")
    np.testing.assert_array_equal(np.asarray(inc_j), inc_t)
    want = jlosses.registry(inc_j)[key](
        jnp.asarray(p), jnp.asarray(t), None if w is None else jnp.asarray(w))
    got = tlosses.registry(inc_t)[key](
        torch.from_numpy(p), torch.from_numpy(t),
        None if w is None else torch.from_numpy(w))
    assert set(tlosses.registry(inc_t)) == set(jlosses.registry(inc_j))
    assert set(tlosses.registry()) == set(jlosses.registry())
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-12)


def test_steplr_and_clip_match_jax_and_optax():
    sched, jsched = steplr(3e-3, 0.9, 5), jsteplr(3e-3, 0.9, 5)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=3e-3)
    torch_sched = torch.optim.lr_scheduler.StepLR(opt, 5, 0.9)
    for epoch in range(21):
        assert sched(epoch) == jsched(epoch)
        assert sched(epoch) == pytest.approx(opt.param_groups[0]["lr"],
                                             rel=1e-12)
        opt.step()
        torch_sched.step()
    rng = np.random.RandomState(1)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    for clip in (0.5 * norm, 2.0 * norm):
        eng = PredictionEngine(dict(configs.synthetic_h36m_train()["engine"],
                                    clip=clip), torch.nn.Linear(1, 1),
                               device="cpu")
        tx = optax.clip_by_global_norm(clip)
        want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
        got = [torch.from_numpy(g.copy()) for g in grads]
        eng._clip_gradients(got)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_engine_refuses_unported_keys_and_accepts_prng_impl():
    model = get_model("dstdgcn", dstdgcn=SMALL)
    base = configs.synthetic_h36m_train()["engine"]
    PredictionEngine(dict(base, prng_impl="rbg"), model, device="cpu")
    # cross-rank BatchNorm builds; training it needs a mesh with its axis
    synced = PredictionEngine(base, get_model(
        "dstdgcn", dstdgcn=dict(SMALL, bn_axis_name="data")), device="cpu")
    synced.init()
    with pytest.raises(ValueError, match="'data'"):
        synced.train_step(*np.zeros((3, 1, 20, 66), np.float32))
    with pytest.raises(RuntimeError, match="init"):
        PredictionEngine(base, model, device="cpu").train_step(
            *np.zeros((3, 1, 20, 66), np.float32))


def _jax_variables(seed=0):
    jmodel = jax_get_model("dstdgcn", dstdgcn=SMALL)
    variables = jmodel.init({"params": jax.random.key(seed)},
                            jnp.zeros((1, 20, 22, 3)), train=False)
    return jax.tree.map(np.asarray, variables)


def test_reverse_bridge_round_trips_a_flax_tree():
    variables = _jax_variables()
    model = get_model("dstdgcn", dstdgcn=SMALL)
    load_flax_variables(model, variables)
    back = to_flax_variables(model)
    assert set(back) == {"params", "batch_stats"}
    for col in back:
        want = flatten_dict(variables[col], sep=".")
        got = flatten_tree(back[col])
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])


def test_lockstep_training_matches_jax_engine():
    ecfg = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=1e-4,
                           gamma=0.5, step_size=1),
                loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                use_weight=False, inverse=True, max_iter=-1, clip=5.0)
    ds = Synthetic(layout="h36m", num_sequences=56, input_n=10, output_n=10,
                   mode="train")
    loader = Loader(ds.arrays(), 8, shuffle=True)

    jeng = JaxEngine(dict(ecfg), jax_get_model("dstdgcn", dstdgcn=SMALL))
    state = jeng.init(ds.input_seqs[:1])
    # move the gates and biases that init at zero so every path trains
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), state.params)
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jeng.tx.init(params))
    step = jeng._build_train_step(None, None, None)

    eng = PredictionEngine(dict(ecfg), get_model("dstdgcn", dstdgcn=SMALL),
                           device="cpu")
    eng.init()
    load_flax_variables(eng.model, {
        "params": params,
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})

    totals, jtotals = [], []
    for epoch, n_steps in ((0, 7), (1, 7), (2, 6)):
        loader.set_epoch(epoch)
        lr = eng.set_epoch_lr(epoch)
        assert lr == jeng.lr_schedule(epoch) == 3e-3 * 0.5 ** epoch
        for i, (inputs, inputs_inv, targets, _) in enumerate(loader):
            if i == n_steps:
                break
            state, jl = step(state, jnp.asarray(inputs),
                             jnp.asarray(inputs_inv), jnp.asarray(targets),
                             jnp.asarray(lr, jnp.float32))
            jtotals.append(float(jl["total"]))
            totals.append(float(eng.train_step(inputs, inputs_inv,
                                               targets)["total"]))
    assert len(totals) == 20
    np.testing.assert_allclose(totals, jtotals, rtol=1e-4)
    assert totals[-1] < totals[0]
    got = to_flax_variables(eng.model)
    for col, tree in (("params", state.params),
                      ("batch_stats", state.batch_stats)):
        want = flatten_dict(jax.tree.map(np.asarray, tree), sep=".")
        mine = flatten_tree(got[col])
        assert set(mine) == set(want)
        for key, w in want.items():
            err = np.abs(mine[key] - w).max()
            assert err <= 1e-3 * max(np.abs(w).max(), 1.0), (col, key, err)


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    cfg = configs.synthetic_h36m_train()["engine"]
    ds = Synthetic(layout="h36m", num_sequences=16, input_n=10,
                   output_n=10, mode="train")
    model_cfg = dict(SMALL, st_gcnn_dropout=0.1)
    eng = PredictionEngine(cfg, get_model("dstdgcn", dstdgcn=model_cfg),
                           device="cpu")
    eng.init()
    eng.train(Loader(ds.arrays(), 8, shuffle=True), 0)
    eng.save(str(tmp_path), err=1.25, epoch=0, is_best=True)
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt", "last.ckpt"]

    other = PredictionEngine(cfg, get_model("dstdgcn", dstdgcn=model_cfg),
                             device="cpu")
    other.init(seed=999)
    assert other.recover(str(tmp_path / "last.ckpt")) == (0, 1.25)
    for (ka, va), (kb, vb) in zip(eng.model.state_dict().items(),
                                  other.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sa, sb = eng.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for pa, pb in zip(sa["state"].values(), sb["state"].values()):
        for key in pa:
            assert torch.equal(torch.as_tensor(pa[key]),
                               torch.as_tensor(pb[key]))
    assert torch.equal(eng.generator.get_state(), other.generator.get_state())
    assert other.lr == eng.lr
    # the resumed engine continues exactly, dropout included
    batch = [a[:8] for a in ds.arrays()[:3]]
    a = eng.train_step(*batch)["total"]
    b = other.train_step(*batch)["total"]
    assert torch.equal(a, b)
    for pa, pb in zip(eng.model.parameters(), other.model.parameters()):
        assert torch.equal(pa, pb)
    # model_only keeps the optimizer and generator of the live engine
    third = PredictionEngine(cfg, get_model("dstdgcn", dstdgcn=model_cfg),
                             device="cpu")
    third.init(seed=5)
    gen = third.generator.get_state()
    third.recover(str(tmp_path / "best.ckpt"), model_only=True)
    assert torch.equal(third.generator.get_state(), gen)
    assert not third.optimizer.state_dict()["state"]


def test_cli_trains_on_cpu_and_writes_csv_and_checkpoints(tmp_path):
    import yaml
    cfg = _small_train_config(tmp_path / "unused")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dstdgcn_tpu_torch.main", "--run_dir",
         str(tmp_path / "run"), "--config", str(path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "run" / "training_loss.csv") as f:
        rows = list(csv.reader(f))
    # header, one row per epoch, then the best epoch's row again
    assert rows[0] == HEAD and len(rows) == 4
    assert all(np.isfinite(float(v)) for row in rows[1:] for v in row)
    assert [float(r[0]) for r in rows[1:3]] == [1.0, 2.0]
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == [
        "best.ckpt", "last.ckpt"]


def test_recovery_probe_reproduces_the_best_eval_loss(tmp_path):
    cfg = _small_train_config(tmp_path / "train")
    runner, history = run(cfg, "cpu")
    assert len(history) == 2 and np.all(np.isfinite(history))
    with open(tmp_path / "train" / "training_loss.csv") as f:
        best = [float(v) for v in list(csv.reader(f))[-1]]
    test_cfg = _small_train_config(tmp_path / "test")
    test_cfg["mode"] = "test"
    test_cfg["model"].update(load=True, ckpt=str(
        tmp_path / "train" / "checkpoints" / "best.ckpt"))
    _, (avg, per_frame) = run(test_cfg, "cpu")
    assert float(avg) == best[3]
    assert [float(m) for m in per_frame] == best[4:]
