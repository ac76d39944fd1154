"""The port's fused-inference path on the CPU, against the JAX package.

Inputs and weights are made from numpy seeds (or flax initialisations
bridged into the port) and go through both packages:

* ``kernels/fused.py``: the plain ``dstd_chain`` against the JAX
  ``dstd_chain`` (its Pallas kernel interpreted on the CPU), output and the
  gradients within 1e-4 max(|want|, 1) (the JAX chain test's norm); the
  plain ``dstd_encoder_chain`` against the JAX one at rtol = atol = 2e-4
  (the JAX encoder test's tolerance); ``bn_affine`` at 1e-6;
* ``models/infer.py``: ``encoder_chain_params`` read from the port's
  module tree against the JAX function on the same flax variables at 1e-6;
  ``fused_eval_forward`` against the JAX one and against the port's own
  eval forward within 2e-5 max(|want|, 1) (float32 reordering through the
  residual cascade, as in the JAX test);
* the engine: ``test()`` with ``engine.fused_inference`` against the JAX
  engine with the same flag and against the port with the flag off,
  per-frame MPJPE at 1e-4 relative;
* the fused slice config, and the wrappers' refusal of a gradient.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.data import Loader as JaxLoader
from dstdgcn_tpu.data import datasets as jdatasets
from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.engine.engine import TrainState
from dstdgcn_tpu.kernels import fused as jfused
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu.models import infer as jinfer
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.data import transforms as tfm
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.models import DSTDGCN, JointBatchNorm, get_model
from dstdgcn_tpu_torch.models import infer as tinfer
from dstdgcn_tpu_torch.utils.bridge import (load_flax_variables,
                                            to_flax_variables)
from dstdgcn_tpu_torch.utils.config import get_config, resolve

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, V, C = 4, 10, 7, 6
SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=2, layout="h36m")


def _layers(rng, count, encoder):
    """Numpy chain blocks (JAX test scales: weights 0.3 randn) or encoder
    layers (affines near 1, PReLU slopes 0.25 and 0.1)."""
    def mk(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    out = []
    for _ in range(count):
        parts = []
        for k, ref, pair, alpha in ((2, T, V, 0.5), (1, V, T, 0.4)):
            parts.append((mk(k, pair, pair), np.float32(alpha), mk(k, C, C),
                          mk(k, C), mk(k, C, 2), mk(k, 2), mk(k, C, 2),
                          mk(k, 2), mk(k, 2, ref, ref), mk(k, ref)))
        if encoder:
            for _ in range(2):
                parts.append(np.stack([1.0 + 0.1 * mk(V, C), 0.2 * mk(V, C)]))
            parts.append(np.asarray([0.25, 0.1], np.float32))
        out.append(tuple(parts))
    return out


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


def _torch(tree, grad=False):
    return _to(tree, lambda a: torch.tensor(np.asarray(a),
                                            requires_grad=grad))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("agg", ["right", "left"])
def test_chain_matches_jax(agg):
    rng = np.random.RandomState(7)
    blocks = _layers(rng, 3, encoder=False)
    x = rng.randn(N, T, V, C).astype(np.float32)
    jblocks = _to(blocks, jnp.asarray)

    def jloss(xx, bb):
        return jnp.sum(jfused.dstd_chain(xx, bb, agg) ** 2)

    want = jfused.dstd_chain(jnp.asarray(x), jblocks, agg)
    wgx, wgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jblocks)

    tx = torch.tensor(x, requires_grad=True)
    tblocks = _torch(blocks, grad=True)
    tfused.reset_launch_counts()
    got = tfused.dstd_chain(tx, tblocks, agg)
    _close(got.detach(), want, 1e-4)
    flat = jax.tree_util.tree_leaves(tblocks)
    grads = torch.autograd.grad((got ** 2).sum(), [tx] + flat)
    _close(grads[0], wgx, 1e-4)
    for g, w in zip(grads[1:], jax.tree_util.tree_leaves(wgb)):
        _close(g.reshape(np.shape(w)), w, 1e-4)
    # CPU tensors: the plain chain and the plain backward, no kernel
    assert set(tfused.launch_counts().values()) == {0}
    with torch.no_grad():     # packed weights give the same result
        again = tfused.dstd_chain(tx, tfused.pack_chain(tblocks), agg)
    assert torch.equal(again, got.detach())


@pytest.mark.parametrize("agg", ["right", "left"])
def test_encoder_chain_matches_jax(agg):
    rng = np.random.RandomState(11)
    layers = _layers(rng, 2, encoder=True)
    x = rng.randn(N, T, V, C).astype(np.float32)
    want = jfused.dstd_encoder_chain(jnp.asarray(x), _to(layers, jnp.asarray),
                                     agg)
    with torch.no_grad():
        got = tfused.dstd_encoder_chain(torch.from_numpy(x), _torch(layers),
                                        agg)
        packed = tfused.dstd_encoder_chain(
            torch.from_numpy(x), tfused.pack_chain(_torch(layers)), agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(packed, got)
    # a compute dtype on CPU tensors: the plain chain rounds where the
    # kernels round (ops/dstd.py::kernel_spatial), against the JAX kernel's
    # bf16 dots within 1e-3 of the float32 output's peak, below a quarter
    # of the bf16-versus-float32 gap (8.4e-3 and 9.8e-3 of the peak here;
    # measured error 6e-8)
    want16 = jfused.dstd_encoder_chain(jnp.asarray(x), _to(layers, jnp.asarray),
                                       agg, dtype=jnp.bfloat16)
    with torch.no_grad():
        got16 = tfused.dstd_encoder_chain(torch.from_numpy(x), _torch(layers),
                                          agg, torch.bfloat16)
    assert got16.dtype == torch.float32
    scale = np.abs(np.asarray(want)).max()
    gap = np.abs(np.asarray(want16) - np.asarray(want)).max() / scale
    err = np.abs(got16.numpy() - np.asarray(want16)).max() / scale
    assert err <= 1e-3 < gap / 4, (err, gap)


def test_bn_affine_matches_jax():
    rng = np.random.RandomState(2)
    scale, bias, mean = (rng.randn(V, C).astype(np.float32) for _ in range(3))
    var = rng.rand(V, C).astype(np.float32) + 0.1
    want = jfused.bn_affine(scale, bias, mean, var)
    got = tfused.bn_affine(*(torch.from_numpy(a) for a in (scale, bias, mean,
                                                           var)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@functools.lru_cache(maxsize=None)
def _bridged(fast):
    """An input and a trained-like model: the port's initialisation with
    noise on every parameter (gates and biases off zero) and BatchNorm
    statistics moved by one train-mode pass; returned with its flax
    variables, which the JAX functions read."""
    x = np.random.RandomState(3).randn(4, 8, 22, 3).astype(np.float32)
    model = DSTDGCN(**SMALL, fast=fast)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        model.train()(torch.from_numpy(x))
    return x, to_flax_variables(model.eval()), model


@pytest.mark.parametrize("fast", [False, True])
def test_encoder_chain_params_match_jax(fast):
    x, variables, model = _bridged(fast)
    want = jinfer.encoder_chain_params(_to(variables, jnp.asarray), 2,
                                       x.shape[1], fast)
    got = tinfer.encoder_chain_params(model)
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(_to(got, lambda a: a.detach()))
    assert len(got_leaves) == len(want_leaves) == 2 * (2 * 10 + 3)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(w)),
                                   np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fast", [False, True])
def test_fused_eval_forward_matches_jax_and_the_model(fast):
    x, variables, model = _bridged(fast)
    tx = torch.from_numpy(x)
    want = np.asarray(jinfer.fused_eval_forward(
        _to(variables, jnp.asarray), jnp.asarray(x), num_layers=2,
        fast=fast))
    tfused.reset_launch_counts()
    with torch.no_grad():
        got = tinfer.fused_eval_forward(model, tx)
        eval_fwd = model(tx)
        reused = tinfer.fused_eval_forward(
            model, tx, weights=tinfer.fused_weights(model))
    _close(got, want, 2e-5)
    _close(got, eval_fwd, 2e-5)
    assert torch.equal(reused, got)
    assert set(tfused.launch_counts().values()) == {0}


def _small_config(run_dir, fused):
    """The fused slice config cut to CPU size: 8 features, 2 encoder
    layers, 16 sequences of T = 10 + 25 frames, batch 8."""
    cfg = configs.synthetic_h36m_fused()
    cfg["engine"]["fused_inference"] = fused
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 16
    cfg["test_batch_size"] = 8
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=2)
    cfg["save"]["path"]["base"] = str(run_dir)
    return resolve(cfg)


def test_fused_engine_eval_matches_jax_engine_and_the_standard_eval(
        tmp_path):
    cfg = _small_config(tmp_path, fused=True)
    mcfg = {k: v for k, v in cfg["model"].items() if k != "name"}
    setting = cfg["setting"]
    ds_kw = dict(cfg["dataset"]["test"]["synthetic"])
    jds, ds = jdatasets.Synthetic(**ds_kw), Synthetic(**ds_kw)
    args = (setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(setting["joint_to_ignore"]),
            np.array(setting["joint_to_equal"]), None, None, "all")

    # the port's initialisation with gates and biases moved off zero, then
    # the BatchNorm statistics of the test inputs, so activations stay O(1)
    # as in a trained model
    calib = get_model("dstdgcn", **dict(mcfg, dstdgcn=dict(
        mcfg["dstdgcn"], st_gcnn_dropout=0.0)))
    gen = torch.Generator().manual_seed(3)
    for mod in calib.modules():
        if isinstance(mod, JointBatchNorm):
            mod.momentum = 1.0
    with torch.no_grad():
        for p in calib.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        calib.train()(tfm.get_transform("tsc")[0](
            torch.from_numpy(ds.input_seqs)))
    variables = to_flax_variables(calib.eval())

    jeng = JaxEngine(cfg["engine"], jax_get_model("dstdgcn", **mcfg))
    jvars = _to(variables, jnp.asarray)
    jeng.state = TrainState(params=jvars["params"],
                            batch_stats=jvars["batch_stats"], opt_state=None,
                            dropout_key=None)
    want_avg, want = jeng.test(JaxLoader(jds.arrays(), 8), *args)

    got = {}
    for flag in (True, False):
        engine_cfg = dict(cfg["engine"], fused_inference=flag)
        eng = PredictionEngine(engine_cfg, get_model("dstdgcn", **mcfg),
                               device="cpu")
        eng.init()
        load_flax_variables(eng.model, variables)
        got[flag] = eng.test(Loader(ds.arrays(), 8), *args)
    avg, per_frame = got[True]
    assert np.all(np.isfinite(per_frame)) and per_frame.shape == (8,)
    np.testing.assert_allclose(per_frame, want, rtol=1e-4)
    assert avg == pytest.approx(want_avg, rel=1e-4)
    np.testing.assert_allclose(per_frame, got[False][1], rtol=1e-4)


def test_fused_slice_config_yaml_equals_dict():
    import yaml
    path = os.path.join(REPO, "dstdgcn_tpu_torch", "configs",
                        "synthetic_h36m_fused.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert raw == configs.SYNTHETIC_H36M_FUSED
    assert raw["engine"]["fused_inference"] is True
    # the serving slice but for the flag: full width, 5 layers, float32
    serving = copy.deepcopy(configs.SYNTHETIC_H36M_SERVING)
    serving["engine"]["fused_inference"] = True
    assert raw == serving
    model = get_config(path)["model"]["dstdgcn"]
    assert (model["num_feature"], model["num_layers"]) == (64, 5)
    assert model["compute_dtype"] is None


def test_encoder_chain_refuses_a_gradient():
    rng = np.random.RandomState(5)
    layers = _torch(_layers(rng, 1, encoder=True))
    x = torch.from_numpy(rng.randn(N, T, V, C).astype(np.float32))
    with pytest.raises(RuntimeError, match="no gradient"):
        tfused.dstd_encoder_chain(x.clone().requires_grad_(), layers)
    grad_layers = _torch(_layers(rng, 1, encoder=True), grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tfused.dstd_encoder_chain(x, grad_layers)
    with pytest.raises(RuntimeError, match="no gradient"):
        tfused.dstd_encoder_chain(x, tfused.pack_chain(grad_layers))
    with torch.no_grad():     # the same call without a gradient runs
        out = tfused.dstd_encoder_chain(x, grad_layers)
    assert out.shape == x.shape and not out.requires_grad
    with pytest.raises(ValueError, match="agg"):
        tfused.dstd_chain(x, [layer[:2] for layer in layers], agg="middle")
