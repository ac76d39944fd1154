"""The port's bf16 compute dtype and "auto" knobs on the CPU, against the
JAX package.

* ``ops/dstd.py::kernel_spatial`` / ``kernel_temporal`` (the plain version
  of the fused kernels' bf16 contract, which the wrappers run on CPU
  tensors) against the JAX kernels' float32 output before their final cast
  (``kernels/fused.py::_pallas_forward`` with ``dtype=jnp.bfloat16``, the
  Pallas kernels interpreted as ``tests/test_kernels.py`` runs them);
* the 11 gradients of ``ops/dstd_bwd.py`` with ``dtype`` against
  ``kernels/fused_bwd.py::spatial_bwd`` / ``temporal_bwd`` at bf16;
* ``models/autotune.py`` against the JAX package's table, and the flagship
  bf16 training config, its YAML and a run of it on the CPU at a small
  width.

The model at bf16 against flax and the lockstep with the JAX engine are in
``tests/test_torch_bf16_model.py``.

Each tolerance is stated beside the gap it must resolve: the distance
between the JAX package's bf16 and float32 results in the same test.  An
op's bound sits below a quarter of its gap, a model's below half, so a test
tells the kernels' rounding points from float32 math and from the XLA
path's rounding (``ops/dstd.py::dstd_spatial`` with a ``dtype``, which
rounds q/k and the adjacency too).
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.kernels import fused as jfused
from dstdgcn_tpu.kernels import fused_bwd as jfused_bwd
from dstdgcn_tpu.models import autotune as jautotune
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.models import DSTDGCN, autotune
from dstdgcn_tpu_torch.ops import dstd as tops
from dstdgcn_tpu_torch.ops import dstd_bwd as tbwd

torch.set_num_threads(2)

#: one op, kernel path against the JAX kernel, max |port - JAX| over the
#: peak |output|.  The measured bf16-versus-float32 gap of these cases is
#: 2.6e-3 to 3.8e-3 of the peak; the port's plain version sits 0.7e-4 to
#: 4.5e-4 from the JAX kernel (an intermediate that the two sum in another
#: order can round to a neighbouring bf16 value), and the XLA path's
#: rounding 3.7e-3 to 5.7e-3.  The bound is asserted below a quarter of
#: each case's gap.
OP_TOL = 6e-4
#: the 11 gradients, max |port - JAX| over max(max |JAX|, 1) per gradient
#: (the JAX backward tests' norm): the gap is 0.6e-3 to 1.3e-2 per
#: gradient and 4.7e-3 to 1.3e-2 for an op's largest, the port 2e-7 to
#: 6.6e-4 (dx, which sums three rounded products).  ``dalpha`` sums
#: N*T*V*V products dA * dyn that cancel, so its error is not bounded
#: relative to |dalpha| itself; relative to
#: max(|dalpha|, 1) it is (1.8e-6 to 6.1e-5 here), as for the other
#: gradients.  The bound is asserted below a quarter of the op's largest
#: gap, and each gradient's error below a quarter of its own.
GRAD_TOL = 8e-4
NAMES = ("dx", "dbase", "dalpha", "dwf", "dbf", "dwm1", "dbm1", "dwm2",
         "dbm2", "dwrm", "dbrm")
#: (N, T, V, C): the flagship frame and joint counts at a narrow width
SHAPE = (4, 35, 22, 16)
SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=2, layout="h36m")


def _case(mode, seed=0):
    """Seeded (x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)."""
    n, t, v, c = SHAPE
    rng = np.random.RandomState(seed)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)

    def mk(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    return [rng.randn(n, t, v, c).astype(np.float32),
            rng.randn(n, t, v, c).astype(np.float32), mk(k, pair, pair),
            np.asarray([0.7], np.float32), mk(k, c, c), mk(k, c),
            mk(k, c, 2), mk(k, 2), mk(k, c, 2), mk(k, 2), mk(k, 2, ref, ref),
            mk(k, ref)]


def _jax_kernel_out(mode, x, weights, agg, dtype):
    """The JAX kernel's float32 output, before its final cast to dtype."""
    body, prep, pad_t = ((jfused._spatial_kernel, jfused._prep_spatial, False)
                         if mode == "spatial" else
                         (jfused._temporal_kernel, jfused._prep_temporal,
                          True))
    return np.asarray(jfused._pallas_forward(
        body, prep, pad_t, jnp.asarray(x), *[jnp.asarray(a) for a in weights],
        agg, dtype))


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_bf16_op_matches_the_jax_kernel(mode, agg):
    x, _, *weights = _case(mode)
    want16 = _jax_kernel_out(mode, x, weights, agg, jnp.bfloat16)
    want32 = _jax_kernel_out(mode, x, weights, agg, None)
    targs = [torch.from_numpy(a) for a in [x] + weights]
    got = getattr(tops, f"kernel_{mode}")(*targs, agg, torch.bfloat16)
    assert got.dtype == torch.float32
    peak = np.abs(want32).max()
    gap = np.abs(want16 - want32).max() / peak
    err = np.abs(got.numpy() - want16).max() / peak
    assert OP_TOL < gap / 4, (OP_TOL, gap)
    assert err <= OP_TOL, (err, gap)
    # the XLA path's rounding points are another function: as far from the
    # kernel as bf16 is from float32
    xla = getattr(tops, f"dstd_{mode}")(*targs, None, agg, torch.bfloat16)
    assert np.abs(xla.float().numpy() - want16).max() / peak > 4 * OP_TOL
    # the wrapper on a CPU tensor: that function, cast to bf16, no launch
    tfused.reset_launch_counts()
    out = getattr(tfused, f"dstd_{mode}")(*targs, None, agg, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.to(torch.bfloat16))
    assert not any(tfused.launch_counts().values())


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_bf16_gradients_match_the_jax_backward_kernel(mode, agg):
    x, g, *weights = _case(mode, seed=1)
    res = tuple(jnp.asarray(a) for a in [x] + weights)
    jbwd = getattr(jfused_bwd, f"{mode}_bwd")
    want16 = [np.asarray(a) for a in jbwd(res, jnp.asarray(g), agg,
                                          jnp.bfloat16)]
    want32 = [np.asarray(a) for a in jbwd(res, jnp.asarray(g), agg, None)]
    tx, tg, *tw = [torch.from_numpy(a) for a in [x, g] + weights]
    got = getattr(tbwd, f"dstd_{mode}_bwd")(tx, tg, *tw, agg=agg,
                                            dtype=torch.bfloat16)
    op_gap = 0.0
    for name, a, b, c in zip(NAMES, got, want16, want32):
        a = a.numpy().reshape(b.shape)
        norm = max(np.abs(b).max(), 1.0)
        err, gap = np.abs(a - b).max() / norm, np.abs(b - c).max() / norm
        assert a.dtype == np.float32
        assert err <= GRAD_TOL and err < gap / 4, (name, err, gap)
        op_gap = max(op_gap, gap)
    assert GRAD_TOL < op_gap / 4, op_gap
    # through the wrapper's autograd Function on CPU tensors: bf16 x and
    # cotangent in, the gradients in the primals' dtypes
    xb = tx.to(torch.bfloat16).requires_grad_()
    leaves = [a.clone().requires_grad_() for a in tw]
    out = getattr(tfused, f"dstd_{mode}")(xb, *leaves, None, agg,
                                          torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert "DSTDFunction" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, [xb] + leaves, tg.to(torch.bfloat16))
    assert grads[0].dtype == torch.bfloat16
    assert all(gr.dtype == torch.float32 for gr in grads[1:])
    want = getattr(tbwd, f"dstd_{mode}_bwd")(
        tx.to(torch.bfloat16), tg.to(torch.bfloat16), *tw, agg=agg,
        dtype=torch.bfloat16)
    assert torch.equal(grads[0], want[0].to(torch.bfloat16))
    for gr, w in zip(grads[1:], want[1:]):
        assert torch.equal(gr, w)


# -- the "auto" knobs (models/autotune.py) ---------------------------------

@pytest.mark.parametrize("batch", [1, 2, 32, 63, 64, 100, 128, 256, 511,
                                   512, 1024, 4096])
def test_auto_table_matches_jax(batch):
    assert autotune.resolve_auto(batch) == jautotune.resolve_auto(batch)
    assert autotune.per_chip_batch(batch) == batch
    for name in autotune.AUTO_KNOBS:
        assert autotune.resolve_knob(name, "auto", batch) == \
            jautotune.resolve_knob(name, "auto", batch)
    assert autotune.AUTO_KNOBS == jautotune.AUTO_KNOBS


def test_auto_policy_regimes_and_boundaries():
    # the JAX package's tests/test_autotune.py cases on the port's copy
    for n in (1, 2, 32, 63):
        assert autotune.resolve_auto(n) == dict(
            compute_dtype=None, agg_group_spatial=None,
            agg_group_temporal=None)
    for n in (64, 128, 256):
        assert autotune.resolve_auto(n) == dict(
            compute_dtype="bfloat16", agg_group_spatial=5,
            agg_group_temporal=2)
    for n in (512, 1024, 4096):
        assert autotune.resolve_auto(n)["compute_dtype"] == "bfloat16"
        assert autotune.resolve_auto(n)["agg_group_spatial"] is None
    assert autotune.resolve_knob("agg_group_spatial", 7, 128) == 7
    assert autotune.resolve_knob("agg_group_spatial", None, 128) is None
    assert autotune.resolve_knob("agg_group_spatial", "auto", 128) == 5
    assert autotune.resolve_knob("compute_dtype", "auto", 1) is None


def test_batch_hint_overrides_the_batch():
    # a ragged last batch (40) keeps the knobs of the configured batch
    assert autotune.resolve_knob("compute_dtype", "auto", 40) is None
    assert autotune.resolve_knob("compute_dtype", "auto", 40,
                                 128) == "bfloat16"
    assert autotune.resolve_knob("agg_group_spatial", "auto", 40, 128) == 5
    model = DSTDGCN(**dict(SMALL, compute_dtype="auto",
                           agg_group_spatial="auto"), auto_batch_hint=128)
    assert model.resolve_knobs(3) == dict(compute_dtype="bfloat16",
                                          agg_group_spatial=5,
                                          agg_group_temporal=None)
    assert model.active_dtype == "bfloat16"


def _small_tpu_config(run_dir):
    """The flagship bf16 training config cut to CPU size: 8 features, 1
    encoder layer, 128 train sequences (one step of 128 per epoch) and 32
    test sequences evaluated at batch 32, whose knobs the train batch pins
    (without the hint batch 32 would resolve to float32)."""
    cfg = configs.synthetic_h36m_tpu_train()
    cfg["dataset"]["train"]["synthetic"]["num_sequences"] = 128
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 32
    cfg["test_batch_size"] = 32
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1)
    cfg["save"]["path"]["base"] = str(run_dir)
    return cfg


def test_tpu_config_trains_on_cpu_with_knobs_from_the_hint(tmp_path):
    cfg = _small_tpu_config(tmp_path)
    runner, history = run(cfg, "cpu")
    model = runner.engine.model
    assert model.auto_batch_hint == 128
    assert model.resolve_knobs(32) == dict(compute_dtype="bfloat16",
                                           agg_group_spatial=5,
                                           agg_group_temporal=2)
    assert model.active_dtype == "bfloat16"   # the eval batches of 32 too
    with open(tmp_path / "training_loss.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 4 and len(history) == 2
    assert all(np.isfinite(float(v)) for row in rows[1:] for v in row)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["best.ckpt",
                                                            "last.ckpt"]
    # every parameter stayed float32 and the Adam state with it
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    state = runner.engine.optimizer.state_dict()["state"]
    assert {v.dtype for s in state.values() for k, v in s.items()
            if k != "step"} == {torch.float32}


def test_tpu_config_yaml_equals_dict():
    import yaml
    from dstdgcn_tpu.utils.config import get_config as jget_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "dstdgcn_tpu_torch", "configs",
                        "synthetic_h36m_tpu_train.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert raw == configs.SYNTHETIC_H36M_TPU_TRAIN
    # the model and engine blocks of the JAX flagship TPU config, but for
    # use_pallas and max_iter
    tpu = jget_config(os.path.join(repo, "configs", "dstdgcn_h36m_tpu.yaml"))
    assert raw["model"]["dstdgcn"] == dict(tpu["model"]["dstdgcn"])
    assert raw["model"]["use_pallas"] is True
    engine = dict(tpu["engine"], max_iter=-1)
    assert raw["engine"] == {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in engine.items()}
    assert raw["train_batch_size"] == raw["test_batch_size"] == 128
    assert autotune.resolve_auto(128)["compute_dtype"] == "bfloat16"
