"""The port's per-group optimizer (``engine/solver.py``) on the CPU, against
``dstdgcn_tpu/engine/solver.py`` and the JAX engine.

* the groups: every parameter of the whole model (the small DSTDGCN) falls
  in the group the JAX package labels it with;
* the update rules: five updates of each optimizer name, each with and
  without momentum, weight decay and bias factor, on seeded parameters and
  gradients at the slices' learning rate (3e-3), match optax within 1e-6
  of max(|p|, 1) for each tensor.  Adam's updates differ by up to about
  1e-5 relative, as optax forms the bias correction ``1 - 0.999 ** t`` in
  float32 (0.999 rounds to 0.99900001, 1.3e-5 relative at t = 1) and torch
  in float64: 1e-6 of a parameter holds at the slices' learning rate;
* the engine: ``engine.solver`` (the slice's block: adam, bias factor 2,
  weight decay 1e-4, none on the biases) with the clip, 3 steps in
  lockstep with the JAX engine from bridged weights (dropout 0); the JAX
  engine then saves its checkpoint, a fresh port engine recovers it (the
  JAX state bit for bit, Adam's moments and count); 2 more steps on all
  three.  Per-step
  ``total`` within 1e-5 relative, the parameters and BatchNorm statistics
  within 1e-5 of max(|p|, 1) after the 5 steps.  Save one kind: a bias
  that feeds a BatchNorm (``residual_proj.bias``, into ``residual_bn``)
  has a gradient of zero in exact arithmetic, as the BatchNorm subtracts
  its mean; the engines round that zero differently, and Adam, which
  divides a gradient by its own size, turns the rounding into steps of up
  to lr x bias_lr_factor.  Such a bias and the running mean it shifts are
  held within that many such steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.engine.solver import _is_bias
from dstdgcn_tpu.engine.solver import make_optimizer as jax_make_optimizer
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu_torch.data import Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.engine.solver import is_bias, make_optimizer
from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.utils.bridge import (flatten_tree, load_flax_variables,
                                            to_flax_variables)

torch.set_num_threads(2)

SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=1, layout="h36m")
#: the engine slice's solver block (configs/synthetic_h36m_engine_train)
SOLVER = dict(optimizer_name="adam", bias_lr_factor=2.0, weight_decay=1e-4,
              weight_decay_bias=0.0)


def _jax_variables(seed=0):
    jmodel = jax_get_model("dstdgcn", dstdgcn=SMALL)
    variables = jmodel.init({"params": jax.random.key(seed)},
                            jnp.zeros((1, 8, 22, 3)), train=False)
    return jax.tree.map(np.asarray, variables)


def test_groups_equal_the_jax_labels_on_the_whole_model():
    params = _jax_variables()["params"]
    labels = flatten_dict(jax.tree_util.tree_map_with_path(
        lambda path, _: "bias" if _is_bias(path) else "base", params),
        sep=".")
    model = get_model("dstdgcn", dstdgcn=SMALL)
    mine = {name: "bias" if is_bias(name) else "base"
            for name, _ in model.named_parameters()}
    assert mine == labels
    # the DSTD-GC biases sit in the base group, the Dense and BatchNorm
    # biases in the bias group
    assert mine["encoder_0.block.spatial.bf"] == "base"
    assert mine["encoder_0.block.temporal.brm"] == "base"
    assert mine["conv_st_in.block.bn.bias"] == "bias"
    assert mine["conv_st_in.block.residual_proj.bias"] == "bias"
    opt = make_optimizer(dict(SOLVER, base_lr=3e-3), model.named_parameters())
    groups = {g["label"]: g for g in opt.param_groups}
    ids = {id(p): name for name, p in model.named_parameters()}
    for label, group in groups.items():
        assert {labels[ids[id(p)]] for p in group["params"]} == {label}
    assert groups["bias"]["lr"] == 2 * groups["base"]["lr"] == 6e-3
    assert (groups["base"]["weight_decay"], groups["bias"]["weight_decay"]) \
        == (1e-4, 0.0)


#: shapes of a made-up parameter tree that holds every kind of name
SHAPES = {"layer": {"kernel": (4, 3), "bias": (3,), "bf": (3,)},
          "bn": {"scale": (5,), "bias": (5,)}, "b": (2,),
          "residual_bias": (3,)}


@pytest.mark.parametrize("full", [False, True],
                         ids=["plain", "momentum_decay_factor"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_five_updates_match_optax(name, full):
    cfg = dict(optimizer_name=name, base_lr=3e-3)
    if full:
        cfg.update(momentum=0.9, weight_decay=1e-2, weight_decay_bias=3e-3,
                   bias_lr_factor=0.5)
    rng = np.random.RandomState(11)
    tree = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))
    flat = flatten_dict(tree, sep=".")
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat.items()}
    opt = make_optimizer(cfg, params.items())
    tx = jax_make_optimizer(cfg, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    for step in range(5):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in flatten_dict(grads, sep=".").items():
            params[k].grad = torch.from_numpy(g)
        opt.step()
    want = flatten_dict(jax.tree.map(np.asarray, jparams), sep=".")
    for k, p in params.items():
        err = np.abs(p.detach().numpy() - want[k]).max()
        assert err <= 1e-6 * max(np.abs(want[k]).max(), 1.0), (name, k, err)


def _lockstep_cfg():
    return dict(learn=dict(opt="adam", lr=3e-3, weight_decay=1e-4, gamma=0.9,
                           step_size=5),
                loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                use_weight=False, inverse=True, max_iter=-1, clip=5.0,
                solver=dict(SOLVER))


#: a bias into a BatchNorm, and the running mean it shifts: a gradient of
#: zero in exact arithmetic, which Adam turns into steps of up to lr x
#: bias_lr_factor (the module docstring)
ROUNDED_ZERO = ("residual_proj.bias", "residual_bn.mean")


def _close(got, want, col, steps):
    assert set(got) == set(want), col
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        if key.endswith(ROUNDED_ZERO):
            assert err <= steps * 3e-3 * SOLVER["bias_lr_factor"], (key, err)
            continue
        assert err <= 1e-5 * max(np.abs(w).max(), 1.0), (col, key, err)


def test_solver_lockstep_and_recovery_of_the_jax_checkpoint(tmp_path):
    ds = Synthetic(layout="h36m", num_sequences=40, input_n=4, output_n=4,
                   mode="train")
    batches = [[a[i * 8:(i + 1) * 8] for a in ds.arrays()[:3]]
               for i in range(5)]
    jeng = JaxEngine(_lockstep_cfg(), jax_get_model("dstdgcn",
                                                    dstdgcn=SMALL))
    state = jeng.init(ds.input_seqs[:1])
    # move the gates and biases that init at zero so every path trains
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), state.params)
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jeng.tx.init(params))
    step = jeng._build_train_step(None, None, None)
    lr = jnp.asarray(jeng.lr, jnp.float32)

    eng = PredictionEngine(_lockstep_cfg(), get_model("dstdgcn",
                                                      dstdgcn=SMALL),
                           device="cpu")
    eng.init()
    load_flax_variables(eng.model, {
        "params": params,
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})

    totals, jtotals = [], []
    for batch in batches[:3]:
        state, jl = step(state, *(jnp.asarray(a) for a in batch), lr)
        jtotals.append(float(jl["total"]))
        totals.append(float(eng.train_step(*batch)["total"]))

    # the JAX engine's checkpoint, recovered by a fresh port engine
    jeng.state = state
    jeng.save(str(tmp_path), err=1.5, epoch=2)
    other = PredictionEngine(_lockstep_cfg(), get_model(
        "dstdgcn", dstdgcn=SMALL), device="cpu")
    other.init(seed=5)
    assert other.recover(str(tmp_path / "last.ckpt")) == (2, 1.5)
    assert other.lr == jeng.lr
    got = to_flax_variables(other.model)
    for col, tree in (("params", state.params),
                      ("batch_stats", state.batch_stats)):
        want = flatten_dict(jax.tree.map(np.asarray, tree), sep=".")
        for key, val in flatten_tree(got[col]).items():
            np.testing.assert_array_equal(val, want[key])
    for group in other.optimizer.param_groups:
        assert group["lr"] == jeng.lr * group["lr_factor"]
        for p in group["params"]:
            st = other.optimizer.state[p]
            assert float(st["step"]) == 3 and set(st) == {
                "step", "exp_avg", "exp_avg_sq"}

    others = []
    for batch in batches[3:]:
        state, jl = step(state, *(jnp.asarray(a) for a in batch), lr)
        jtotals.append(float(jl["total"]))
        totals.append(float(eng.train_step(*batch)["total"]))
        others.append(float(other.train_step(*batch)["total"]))
    np.testing.assert_allclose(totals, jtotals, rtol=1e-5)
    np.testing.assert_allclose(others, jtotals[3:], rtol=1e-5)
    for e in (eng, other):
        got = to_flax_variables(e.model)
        for col, tree in (("params", state.params),
                          ("batch_stats", state.batch_stats)):
            _close(flatten_tree(got[col]),
                   flatten_dict(jax.tree.map(np.asarray, tree), sep="."),
                   col, 5)
    assert os.path.isfile(tmp_path / "last.ckpt")
