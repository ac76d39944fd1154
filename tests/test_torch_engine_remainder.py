"""The port's engine and utils remainder on the CPU, against the JAX package.

* ``utils/callbacks.py``: ``CallbackLogger``'s CSV, YAML and progress
  strings equal the JAX logger's on the same seeded loss stream;
  ``engine.callbacks`` writes the JAX engine's columns and rows;
* ``engine.profile``: one Chrome trace, written in the first epoch, that
  holds steps ``1 .. profile_steps`` (an ``engine.step`` span each) and no
  other;
* ``utils/timing.py``: ``loop_fn`` applies the op ``iters`` times;
* the JAX checkpoint reader: the msgpack decoder equals
  ``flax.serialization.msgpack_restore`` on seeded trees (float32, int32,
  uint32 and bool arrays, numpy and Python scalars, empty dicts); for
  each optimizer form the engines build, the JAX engine trains 3 steps
  and saves, the port recovers (parameters, BatchNorm statistics
  and the optimizer's moments bit for bit, the payload equal), and both
  take 2 more steps on the same batches: parameters within 1e-5 of
  max(|p|, 1).  The model here is a small one of the port's layers (a
  BatchNorm, two Dense layers, a PReLU) so that each form compiles in
  seconds; ``tests/test_torch_solver.py`` recovers the DSTDGCN;
* ``model.remat`` (``True`` and ``"dots"``): a train-mode forward and its
  gradients against the JAX model with the same knob (outputs 1e-5,
  gradients 1e-4 of max(|g|, 1)) and against the port without remat (1e-6
  of max(|g|, 1)), on the plain path and the kernel wrappers' CPU path.  A
  gate's gradient (``alpha_*``) sums products that largely cancel, and the
  JAX model's float32 run alone lies up to 1.2e-4 of max(|g|, 1) from the
  float64 run there: a gradient past 1e-4 of the JAX one is held, as
  ``chip_smoke.py``'s train steps hold theirs (GRAD_TOL), when the port
  lies no farther from the port's float64 run than twice the JAX run's
  own distance to it;
* ``ConvTemporalGraphical`` and ``STGCNNLayer(refine=False)`` against the
  JAX layers through the weight bridge: forward 1e-5, gradients 1e-4 of
  max(|g|, 1).
"""

import csv
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization
from flax.traverse_util import flatten_dict

from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu.models import layers as jlayers
from dstdgcn_tpu.utils.callbacks import CallbackLogger as JaxLogger
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.engine.checkpoint import msgpack_restore
from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.models import layers as tlayers
from dstdgcn_tpu_torch.utils.bridge import (flatten_tree, load_flax_variables,
                                            to_flax_variables)
from dstdgcn_tpu_torch.utils.callbacks import CallbackLogger
from dstdgcn_tpu_torch.utils.timing import loop_fn, time_looped

torch.set_num_threads(2)

BASE = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                       step_size=5),
            loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
            use_weight=False, inverse=True, max_iter=-1)


# -- a small model of the port's layers, and its flax twin ------------------

class JaxTiny(nn.Module):
    """A BatchNorm, a PReLU and two Dense layers with a residual; no bias
    feeds a BatchNorm, so no gradient is zero by construction."""

    @nn.compact
    def __call__(self, x, *, train=False):
        h = jlayers.JointBatchNorm(name="bn")(x, train=train)
        h = jlayers.PReLU(name="prelu")(nn.Dense(4, name="proj")(h))
        return nn.Dense(3, name="out")(h) + x


class TorchTiny(torch.nn.Module):

    def __init__(self):
        super().__init__()
        self.bn = tlayers.JointBatchNorm(22, 3)
        self.proj = tlayers.Dense(3, 4)
        self.prelu = tlayers.PReLU()
        self.out = tlayers.Dense(4, 3)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, g):
        tlayers.reset_all(self, g)

    def forward(self, x):
        return self.out(self.prelu(self.proj(self.bn(x)))) + x


def _batches(n=5, seed=0):
    ds = Synthetic(layout="h36m", num_sequences=8 * n, input_n=2,
                   output_n=2, mode="train", seed=seed)
    return ds, [[a[i * 8:(i + 1) * 8] for a in ds.arrays()[:3]]
                for i in range(n)]


# -- callbacks --------------------------------------------------------------

def test_callback_logger_writes_the_jax_loggers_files(tmp_path):
    rng = np.random.RandomState(4)
    stream = [{"joint": float(a), "total": float(b)}
              for a, b in rng.rand(12, 2) * 10]
    pairs = [(rng.rand(3), rng.rand(3)) for _ in range(12)]
    outs = {}
    for label, cls in (("jax", JaxLogger), ("port", CallbackLogger)):
        d = tmp_path / label
        it, pit = iter(stream), iter(pairs)
        log = cls(str(d), name="train")
        log.add_loss_log(lambda it=it: next(it), loss_freq=1, window_size=4)
        log.add_metric_log(
            lambda pit=pit: next(pit),
            [("mae", lambda p, t: float(np.abs(p - t).mean())),
             ("max", lambda p, t: float(np.abs(p - t).max()))],
            metrics_freq=2)
        descs, avgs = [], []
        for _ in range(2):
            descs += [log.step() for _ in range(6)]
            avgs.append(log.end_epoch())
        outs[label] = (descs, avgs, (d / "train_loss.csv").read_text(),
                       (d / "train_metrics.yaml").read_text())
    assert outs["port"] == outs["jax"]
    assert outs["port"][2].splitlines()[0] == "epoch,joint,total"


def test_engine_callbacks_write_the_jax_engines_columns(tmp_path):
    ds, _ = _batches(2)
    loader = Loader(ds.arrays(), 8)
    jeng = JaxEngine(dict(BASE, callbacks=dict(
        log_dir=str(tmp_path / "jax"), loss_freq=1, name="train")),
        JaxTiny())
    jeng.init(ds.input_seqs[:1])
    eng = PredictionEngine(dict(BASE, callbacks=dict(
        log_dir=str(tmp_path / "port"), loss_freq=1, name="train")),
        TorchTiny(), device="cpu")
    eng.init()
    load_flax_variables(eng.model, jax.tree.map(np.asarray, {
        "params": jeng.state.params, "batch_stats": jeng.state.batch_stats}))
    for epoch in range(2):
        jeng.train(loader, epoch)
        eng.train(loader, epoch)
    rows = {}
    for label in ("jax", "port"):
        with open(tmp_path / label / "train_loss.csv") as f:
            rows[label] = list(csv.reader(f))
    assert rows["port"][0] == rows["jax"][0] == ["epoch", "joint", "total"]
    assert len(rows["port"]) == len(rows["jax"]) == 3
    np.testing.assert_allclose(np.asarray(rows["port"][1:], float),
                               np.asarray(rows["jax"][1:], float), rtol=1e-5)


# -- profiler trace ---------------------------------------------------------

def test_engine_profile_traces_steps_one_to_profile_steps(tmp_path):
    ds, _ = _batches(5)
    loader = Loader(ds.arrays(), 8)
    prof = tmp_path / "profile"
    eng = PredictionEngine(dict(BASE, profile=str(prof), profile_steps=2),
                           TorchTiny(), device="cpu")
    eng.init()
    eng.train(loader, 0)
    eng.train(loader, 1)        # traces the first epoch only
    traces = glob.glob(str(prof / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == "engine.step"]
    assert steps == ["engine.step"] * 2
    # the optimizer of each traced step, and of no other
    assert sum(e.get("name", "").startswith("Optimizer.step")
               for e in events) == 2


# -- timing -----------------------------------------------------------------

def test_loop_fn_actually_iterates():
    def op(x):
        return x * 2.0 + 1.0

    x = torch.ones(4, 4)
    torch.testing.assert_close(loop_fn(op, 3)(x), op(op(op(x))))
    torch.testing.assert_close(loop_fn(op, 0)(x), x)
    assert time_looped(op, x, iters=5, repeats=1) > 0


# -- JAX checkpoints --------------------------------------------------------

def _same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_decoder_equals_flax(seed):
    rng = np.random.RandomState(seed)
    tree = {
        "f32": rng.randn(3, 4).astype(np.float32),
        "i32": rng.randint(-2**31, 2**31 - 1, size=(5,)).astype(np.int32),
        "u32": rng.randint(0, 2**32 - 1, size=(2,), dtype=np.uint32),
        "bool": rng.rand(2, 3) > 0.5,
        "count": np.asarray(7, np.int32),
        "f64": rng.randn(2).astype(np.float64),
        "np_scalar": np.float32(rng.randn()),
        "np_int": np.int64(rng.randint(1 << 40)),
        "nested": {"empty": {}, "0": {"x": rng.randn(0, 3).astype(
            np.float32)}, "lr": float(rng.rand()), "epoch": int(seed) - 3,
                   "big": 1 << 40, "name": "adam", "flag": True,
                   "none": None, "text": "x" * 40},
    }
    blob = serialization.msgpack_serialize(tree)
    _same(msgpack_restore(blob), serialization.msgpack_restore(blob))


#: the optimizer forms of the engines: the learn block's Adam (with L2
#: decay, under the clip) and each name of the solver block
FORMS = {
    "adam": {},
    "adam_l2": dict(learn=dict(BASE["learn"], weight_decay=1e-3)),
    "adam_clip": dict(learn=dict(BASE["learn"], weight_decay=1e-3),
                      clip=0.5),
    "solver_adam": dict(solver=dict(optimizer_name="adam", bias_lr_factor=2.0,
                                    weight_decay=1e-3,
                                    weight_decay_bias=0.0), clip=5.0),
    "solver_adamw": dict(solver=dict(optimizer_name="adamw",
                                     bias_lr_factor=0.5)),
    "solver_sgd": dict(solver=dict(optimizer_name="sgd", momentum=0.9,
                                   bias_lr_factor=2.0, weight_decay=1e-3)),
    "solver_rmsprop": dict(solver=dict(optimizer_name="rmsprop",
                                       momentum=0.9, bias_lr_factor=2.0,
                                       weight_decay=1e-3)),
}
#: optax state keys -> the torch optimizer's, by form
MOMENTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
           "sgd": {"trace": "momentum_buffer"},
           "rmsprop": {"nu": "square_avg", "trace": "momentum_buffer"}}


def _optax_nodes(tree, keys, path=()):
    if isinstance(tree, dict):
        if set(tree) == keys:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _optax_nodes(v, keys, path + (k,))


@pytest.mark.parametrize("form", list(FORMS))
def test_recover_a_jax_checkpoint_and_train_on(form, tmp_path):
    cfg = dict(BASE, **FORMS[form])
    ds, batches = _batches(5, seed=1)
    jeng = JaxEngine(dict(cfg), JaxTiny())
    state = jeng.init(ds.input_seqs[:1])
    step = jeng._build_train_step(None, None, None)
    lr = jnp.asarray(jeng.lr, jnp.float32)
    for batch in batches[:3]:
        state, _ = step(state, *(jnp.asarray(a) for a in batch), lr)
    jeng.state = state
    jeng.save(str(tmp_path), err=2.5, epoch=4)

    eng = PredictionEngine(dict(cfg), TorchTiny(), device="cpu")
    eng.init(seed=9)
    assert eng.recover(str(tmp_path / "last.ckpt")) == (4, 2.5)
    with open(tmp_path / "last.ckpt", "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert json.loads(f.read(n)) == dict(lr=jeng.lr, err=2.5, epoch=4)
    assert eng.lr == jeng.lr
    got = to_flax_variables(eng.model)
    for col in ("params", "batch_stats"):
        want = flatten_dict(jax.tree.map(np.asarray, getattr(state, col)),
                            sep=".")
        mine = flatten_tree(got[col])
        assert set(mine) == set(want)
        for key in want:
            np.testing.assert_array_equal(mine[key], want[key])
    # the optimizer's moments, bit for bit, group by group
    name = cfg.get("solver", {}).get("optimizer_name", "adam")
    name = "adam" if name == "adamw" else name
    opt_sd = serialization.to_state_dict(jax.device_get(state.opt_state))
    names = {id(p): n for n, p in eng.model.named_parameters()}
    checked = 0
    for jkey, tkey in MOMENTS[name].items():
        keys = {"count", "mu", "nu"} if name == "adam" else {jkey}
        for path, node in _optax_nodes(opt_sd, keys):
            label = path[path.index("inner_states") + 1] \
                if "inner_states" in path else None
            for group in eng.optimizer.param_groups:
                if group.get("label") != label:
                    continue
                for p in group["params"]:
                    leaf = node[jkey]
                    for part in names[id(p)].split("."):
                        leaf = leaf[part]
                    np.testing.assert_array_equal(
                        eng.optimizer.state[p][tkey].numpy(),
                        np.asarray(leaf))
                    if name == "adam":
                        assert float(eng.optimizer.state[p]["step"]) == 3
                    checked += 1
    assert checked >= len(names)

    for batch in batches[3:]:
        state, _ = step(state, *(jnp.asarray(a) for a in batch), lr)
        eng.train_step(*batch)
    got = flatten_tree(to_flax_variables(eng.model)["params"])
    for key, w in flatten_dict(jax.tree.map(np.asarray, state.params),
                               sep=".").items():
        err = np.abs(got[key] - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1.0), (form, key, err)


def test_recover_a_jax_checkpoint_model_only(tmp_path):
    ds, batches = _batches(1)
    jeng = JaxEngine(dict(BASE), JaxTiny())
    jeng.init(ds.input_seqs[:1])
    jeng.save(str(tmp_path), err=1.0, epoch=0)
    eng = PredictionEngine(dict(BASE), TorchTiny(), device="cpu")
    eng.init(seed=3)
    gen = eng.generator.get_state()
    eng.recover(str(tmp_path / "last.ckpt"), model_only=True)
    assert not eng.optimizer.state_dict()["state"]
    assert torch.equal(eng.generator.get_state(), gen)
    np.testing.assert_array_equal(
        eng.model.proj.kernel.detach().numpy(),
        np.asarray(jeng.state.params["proj"]["kernel"]))
    # a solver engine refuses the plain Adam state of another form
    sgd = PredictionEngine(dict(BASE, solver=dict(optimizer_name="sgd")),
                           TorchTiny(), device="cpu")
    sgd.init()
    with pytest.raises(ValueError, match="not a SGD"):
        sgd.recover(str(tmp_path / "last.ckpt"))


# -- remat ------------------------------------------------------------------

REMAT_MODEL = dict(input_channels=6, input_time_frame=3, output_time_frame=3,
                   st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
                   num_layers=1, layout="h36m")


def _norm_err(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _port_grads(remat, use_pallas, variables, x, dtype=torch.float32):
    model = get_model("dstdgcn", dstdgcn=dict(REMAT_MODEL, remat=remat),
                      use_pallas=use_pallas)
    load_flax_variables(model, variables)
    model.to(dtype).train()
    out = model(torch.from_numpy(x).to(dtype))
    (out ** 2).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def remat_case():
    x = np.random.RandomState(2).randn(2, 6, 22, 3).astype(np.float32)
    jmodel = jax_get_model("dstdgcn", dstdgcn=REMAT_MODEL)
    variables = jmodel.init({"params": jax.random.key(1)}, jnp.asarray(x),
                            train=False)
    rng = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), variables["params"])
    variables = {"params": params,
                 "batch_stats": jax.tree.map(np.asarray,
                                             variables["batch_stats"])}
    return x, variables


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel_path"])
@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_the_jax_model_and_no_remat(remat_case, remat,
                                                  use_pallas):
    x, variables = remat_case
    jmodel = jax_get_model("dstdgcn", dstdgcn=dict(REMAT_MODEL, remat=remat))

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out ** 2), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    out, grads = _port_grads(remat, use_pallas, variables, x)
    base_out, base_grads = _port_grads(False, use_pallas, variables, x)
    _, grads64 = _port_grads(False, False, variables, x, torch.float64)
    assert _norm_err(out, np.asarray(jout)) <= 1e-5
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    jflat = flatten_dict(jax.tree.map(np.asarray, jgrads), sep=".")
    assert set(grads) == set(jflat)
    for key, g in grads.items():
        assert (_norm_err(g, jflat[key]) <= 1e-4
                or _norm_err(g, grads64[key])
                <= 2 * _norm_err(jflat[key], grads64[key])), (key, "jax")
        assert _norm_err(g, base_grads[key]) <= 1e-6, (key, "no remat")
    assert _norm_err(out, base_out) <= 1e-6


# -- the legacy ConvTemporalGraphical layer ---------------------------------

@pytest.mark.parametrize("kernel_size", [(1, 1), (3, 3), (2, 3)])
def test_legacy_stgcnn_layer_matches_jax(kernel_size):
    t, v, ci, co = 5, 22, 4, 6
    x = np.random.RandomState(6).randn(2, t, v, ci).astype(np.float32)
    jl = jlayers.STGCNNLayer(out_channels=co, time_dim=t, joints_dim=v,
                             kernel_size=kernel_size, refine=False)
    variables = jax.tree.map(np.asarray, jl.init(jax.random.key(3),
                                                 jnp.asarray(x), train=False))
    tl = tlayers.STGCNNLayer(ci, co, t, v, kernel_size=kernel_size,
                             refine=False)
    load_flax_variables(tl, variables)
    jflat = flatten_dict(variables["params"], sep=".")
    assert {n for n, _ in tl.named_parameters()} == set(jflat)

    def loss(params, xx):
        return jnp.sum(jnp.sin(jl.apply({"params": params}, xx,
                                        train=False)))

    jout = np.asarray(jl.apply(variables, jnp.asarray(x), train=False))
    jg, jdx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl(xt)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    jgf = flatten_dict(jax.tree.map(np.asarray, jg), sep=".")
    for name, p in tl.named_parameters():
        assert _norm_err(p.grad.numpy(), jgf[name]) <= 1e-4, name
    assert _norm_err(xt.grad.numpy(), np.asarray(jdx)) <= 1e-4
    # the unit alone
    jt = jlayers.ConvTemporalGraphical(t, v)
    tv = jax.tree.map(np.asarray, jt.init(jax.random.key(4), jnp.asarray(x)))
    tt = tlayers.ConvTemporalGraphical(t, v)
    load_flax_variables(tt, tv)
    np.testing.assert_allclose(
        tt(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jt.apply(tv, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
