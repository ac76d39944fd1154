"""bf16 chains and bf16 fused serving of the port on the CPU, against the
JAX package.

Inputs and weights are made from numpy seeds (or the port's initialisation
bridged into flax variables) and go through both packages:

* ``kernels/fused.py::dstd_chain`` at bf16 against the JAX ``dstd_chain``
  with ``dtype=jnp.bfloat16`` (its Pallas kernel interpreted on the CPU):
  the forward within 1e-4 max(|want|, 1) (right aggregation; left within
  LEFT_CHAIN_TOL of the peak) and every gradient within 1e-4 max(|g|, 1).
  The JAX chain's gradient is the VJP of its float32 oracle whatever the
  dtype, so the port's backward replays the chain at float32;
* ``models/infer.py::fused_eval_forward`` at bf16 against the JAX one.  The
  JAX in and out layers are the XLA ops, which round q, k, the adjacency and
  the output to the dtype; XLA:CPU cannot run their bf16 dots, so the tests
  that need them patch ``dstdgcn_tpu.ops.dstd._cast_dot`` to round to bf16
  and widen back to float32, the TPU's rounding (a test-side emulation:
  the JAX package is not changed);
* the engine's fused eval at "auto" with batch 64 (bf16) against the JAX
  engine with the same flag, the fused bf16 slice config, and the chain
  wrappers' dtypes and launch counts.
"""

import csv
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
from dstdgcn_tpu.ops import dstd as jdstd
from dstdgcn_tpu.utils.config import get_config as jget_config
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.data import transforms as tfm
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.main import run
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
#: the bf16 fused forward against the JAX one, max |port - JAX| over the
#: float32 output's peak, by aggregation, each below a quarter of its
#: bf16-versus-float32 gap.  Right (fast False): measured 0.0 against a gap
#: of 1.7e-2 (2.1e-2 before the in and out layers took the XLA ops'
#: rounding).  Left (fast True): XLA sums the left aggregation in another
#: order than torch, so an op's float32 output can differ in its last bit
#: and the next op's bf16 rounding of it flip, which the encoder's layers
#: spread (2.6e-3 of the peak after its 2 layers, with the in and out layers
#: exact): measured 4.2e-3 against a gap of 4.5e-2 (5.4e-2 before the
#: repair).
FUSED_TOL = dict(right=1e-3, left=6e-3)
#: the 3-block bf16 chain with the left aggregation against the JAX one,
#: max |port - JAX| over the peak: the same flips (18 of 1680 elements
#: after one block, 3.9e-4 of the peak), compounding over the blocks;
#: measured 1.2e-2, below half of the bf16-versus-float32 gap (3.9e-2)
LEFT_CHAIN_TOL = 1.5e-2


def _blocks(rng, count):
    """Numpy chain blocks at the JAX chain test's scales (0.3 randn)."""
    def mk(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    return [tuple((mk(k, pair, pair), np.float32(alpha), mk(k, C, C),
                   mk(k, C), mk(k, C, 2), mk(k, 2), mk(k, C, 2), mk(k, 2),
                   mk(k, 2, ref, ref), mk(k, ref))
                  for k, ref, pair, alpha in ((2, T, V, 0.5), (1, V, T, 0.4)))
            for _ in range(count)]


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


@pytest.fixture
def xla_rounding(monkeypatch):
    """The JAX XLA path's bf16 contractions as the TPU runs them: operands
    rounded to the dtype, products and sums in float32."""
    monkeypatch.setattr(jdstd, "_cast_dot", lambda v, dt: v if dt is None
                        else v.astype(dt).astype(jnp.float32))


def _port_chain(x, blocks, agg, g, dtype):
    """Output and the gradients of x and every weight of the port's chain."""
    tx = torch.tensor(x, requires_grad=True)
    tblocks = _torch(blocks, grad=True)
    out = tfused.dstd_chain(tx, tblocks, agg, dtype)
    flat = jax.tree_util.tree_leaves(tblocks)
    return out, torch.autograd.grad(out, [tx] + flat, torch.from_numpy(g))


@pytest.mark.parametrize("agg", ["right", "left"])
def test_bf16_chain_and_its_gradient_match_jax(agg):
    rng = np.random.RandomState(7)
    blocks = _blocks(rng, 3)
    x = rng.randn(N, T, V, C).astype(np.float32)
    g = np.random.RandomState(5).randn(N, T, V, C).astype(np.float32)
    want, vjp = jax.vjp(
        lambda xx, bb: jfused.dstd_chain(xx, bb, agg, jnp.bfloat16),
        jnp.asarray(x), _to(blocks, jnp.asarray))
    wgx, wgb = vjp(jnp.asarray(g))

    tfused.reset_launch_counts()
    got, grads = _port_chain(x, blocks, agg, g, torch.bfloat16)
    assert got.dtype == torch.float32
    if agg == "right":
        _close(got.detach(), want, 1e-4)
    else:
        want32 = jfused.dstd_chain(jnp.asarray(x), _to(blocks, jnp.asarray),
                                   agg)
        peak = np.abs(np.asarray(want)).max()
        gap = np.abs(np.asarray(want) - np.asarray(want32)).max() / peak
        err = np.abs(got.detach().numpy() - np.asarray(want)).max() / peak
        assert err <= LEFT_CHAIN_TOL < gap / 2, (err, gap)
    _close(grads[0], wgx, 1e-4)
    for gr, w in zip(grads[1:], jax.tree_util.tree_leaves(wgb)):
        _close(gr.reshape(np.shape(w)), w, 1e-4)
    # the backward is the float32 chain's, bit for bit: the same replay
    _, grads32 = _port_chain(x, blocks, agg, g, None)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads32))
    assert set(tfused.launch_counts().values()) == {0}


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
def test_bf16_fused_eval_forward_matches_jax(fast, xla_rounding):
    x, variables, model = _bridged(fast)
    jvars = _to(variables, jnp.asarray)
    want, want32 = (np.asarray(jinfer.fused_eval_forward(
        jvars, jnp.asarray(x), num_layers=2, fast=fast, dtype=dtype))
        for dtype in (jnp.bfloat16, None))
    tfused.reset_launch_counts()
    with torch.no_grad():
        got = tinfer.fused_eval_forward(model, torch.from_numpy(x),
                                        dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert set(tfused.launch_counts().values()) == {0}
    peak = np.abs(want32).max()
    gap = np.abs(want - want32).max() / peak
    err = np.abs(got.numpy() - want).max() / peak
    tol = FUSED_TOL["left" if fast else "right"]
    assert err <= tol < gap / 4, (err, gap)


def _small_config(run_dir):
    """The fused bf16 slice config cut to CPU size: 8 features, 2 encoder
    layers, 64 test sequences of T = 10 + 25 frames, batch 64 (where "auto"
    still resolves to bf16)."""
    cfg = configs.synthetic_h36m_tpu_fused()
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 64
    cfg.update(train_batch_size=64, test_batch_size=64)
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=2)
    cfg["save"]["path"]["base"] = str(run_dir)
    return resolve(cfg)


def test_bf16_fused_engine_eval_matches_jax_engine(tmp_path, xla_rounding):
    cfg = _small_config(tmp_path)
    mcfg = {k: v for k, v in cfg["model"].items() if k != "name"}
    setting = cfg["setting"]
    ds_kw = dict(cfg["dataset"]["test"]["synthetic"])
    jds, ds = jdatasets.Synthetic(**ds_kw), Synthetic(**ds_kw)
    args = (setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(setting["joint_to_ignore"]),
            np.array(setting["joint_to_equal"]), None, None, "all")

    # the port's initialisation with gates and biases moved off zero, then
    # the BatchNorm statistics of the test inputs (a float32 pass), so that
    # activations stay O(1) as in a trained model
    calib = get_model("dstdgcn", **dict(mcfg, dstdgcn=dict(
        mcfg["dstdgcn"], st_gcnn_dropout=0.0, compute_dtype=None)))
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
    _, want = jeng.test(JaxLoader(jds.arrays(), 64), *args)

    got = {}
    for dtype in ("auto", None):
        model = get_model("dstdgcn", **dict(mcfg, dstdgcn=dict(
            mcfg["dstdgcn"], compute_dtype=dtype)))
        eng = PredictionEngine(cfg["engine"], model, device="cpu")
        eng.init()
        load_flax_variables(eng.model, variables)
        got[dtype] = eng.test(Loader(ds.arrays(), 64), *args)[1]
        assert model.resolve_knobs(64)["compute_dtype"] == (
            "bfloat16" if dtype else None)
    assert np.all(np.isfinite(got["auto"])) and got["auto"].shape == (8,)
    # per-frame MPJPE within 1e-5 relative of the JAX engine's (measured
    # 2.0e-6).  The model's share of this cut's MPJPE is small: bf16 moves
    # it only 3.7e-6 from float32, too little to tell rounding points
    # apart, which test_bf16_fused_eval_forward_matches_jax holds.  Here:
    # the dtype resolved per batch reaches the fused path on both sides
    # (the port's bf16 sweep differs from its float32 one).
    gap = np.max(np.abs(got["auto"] - got[None]) / np.abs(got[None]))
    err = np.max(np.abs(got["auto"] - want) / np.abs(want))
    assert err <= 1e-5 and gap > 0, (err, gap)


def test_fused_bf16_slice_config_yaml_equals_dict_and_runs_on_cpu(tmp_path):
    import yaml
    path = os.path.join(REPO, "dstdgcn_tpu_torch", "configs",
                        "synthetic_h36m_tpu_fused.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert raw == configs.SYNTHETIC_H36M_TPU_FUSED
    # the model and engine blocks of the JAX flagship TPU config, but for
    # use_pallas and fused_inference
    tpu = jget_config(os.path.join(REPO, "configs", "dstdgcn_h36m_tpu.yaml"))
    assert raw["model"]["dstdgcn"] == dict(tpu["model"]["dstdgcn"])
    assert raw["model"]["use_pallas"] is True
    engine = dict(tpu["engine"], fused_inference=True)
    assert raw["engine"] == {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in engine.items()}
    assert raw["train_batch_size"] == raw["test_batch_size"] == 128
    assert raw["mode"] == "test"
    assert raw["dataset"]["test"]["synthetic"]["num_sequences"] == 4 * 128
    model = get_config(path)["model"]["dstdgcn"]
    assert (model["num_feature"], model["num_layers"]) == (64, 5)

    # cut to CPU size, through the entry point: "auto" pinned to the batch
    # hint resolves to bf16, testing_loss.csv holds finite values
    tfused.reset_launch_counts()
    runner, (avg, per_frame) = run(_small_config(tmp_path), "cpu")
    model = runner.engine.model
    assert model.auto_batch_hint == 64
    assert model.resolve_knobs(1)["compute_dtype"] == "bfloat16"
    assert runner.engine.fused_inference
    with open(tmp_path / "testing_loss.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and len(rows[1]) == 1 + len(per_frame) == 9
    assert all(np.isfinite(float(v)) for v in rows[1])
    assert set(tfused.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", ["dstd_chain", "dstd_encoder_chain"])
def test_chain_wrappers_take_bf16_refuse_float16_and_launch_nothing_on_cpu(
        name):
    rng = np.random.RandomState(9)
    blocks = _blocks(rng, 2)
    layers = blocks if name == "dstd_chain" else [
        blk + (np.stack([np.ones((V, C)), np.zeros((V, C))]).astype(
            np.float32),) * 2 + (np.asarray([0.25, 0.1], np.float32),)
        for blk in blocks]
    x = torch.from_numpy(rng.randn(N, T, V, C).astype(np.float32))
    wrapper = getattr(tfused, name)
    oracle = (tfused._chain_oracle if name == "dstd_chain"
              else tfused._encoder_oracle)
    tfused.reset_launch_counts()
    counts = tfused.launch_counts()
    assert counts[f"{name}_bf16"] == 0 and len(counts) == 12
    with torch.no_grad():
        for given in (_torch(layers), tfused.pack_chain(_torch(layers))):
            out = wrapper(x, given, "right", torch.bfloat16)
            assert out.dtype == torch.float32
            assert torch.equal(out, oracle(x, _torch(layers), "right",
                                           torch.bfloat16))
            assert torch.equal(wrapper(x, given, "right", torch.float32),
                               wrapper(x, given, "right"))
        with pytest.raises(NotImplementedError, match="float16"):
            wrapper(x, _torch(layers), "right", torch.float16)
    assert set(tfused.launch_counts().values()) == {0}
