"""The configurations the JAX package runs through its kernels at shapes
the port's other CPU tests do not use, on the CPU, against the JAX package:
the CMU and 3DPW TPU profiles (``configs/dstdgcn_{cmu,3dpw}_tpu.yaml``,
bf16 at batch 128) and the fast variant through the kernels
(``agg="left"``, T = 10 + 10).

Inputs are made from numpy seeds and weights are bridged
(``utils/bridge.py``), so both packages run the same parameters; the JAX
side runs with ``use_pallas=True``, its Pallas kernels interpreted on the
CPU, the port's wrappers their plain versions.  Widths are cut to 8
features and 2 layers at a few samples; T and V are the real ones.
Tolerances are ROADMAP.md's holding rules, each over the peak of the
float32 result (or max(|g|, 1) for a gradient): 2e-2 for a bf16 model,
1e-4 for a float32 one, and each bf16 result is also held nearer to the
JAX bf16 result than the float32 one is (the bf16-versus-float32 gap), so
that the test tells the dtypes apart.  The float32 side of a model-level
gap is the port's own float32 run, which lies within 3e-6 of the JAX one
at these shapes (1e-4 is held where it is the result under test).  The
JAX package runs once per case, compiled whole with XLA's excess precision
off (``_exact_jit``: its bf16 roundings kept, each interpreted kernel
lowered once); the two lockstep steps' lowering of their interpreted
Pallas kernels (about 12 s each) and the seeded trees' bf16 steps of 64 on
the CPU (about 2 s a step) are most of the file's time (about 75 s):

* the bf16 one-op kernels' plain versions (``ops/dstd.py::kernel_spatial``
  / ``kernel_temporal``, what the card's kernels are held to) against the
  JAX Pallas kernels at CMU's (35, 25) and 3DPW's (40, 23), at the bf16 op
  tests' OP_TOL, below a quarter of the gap (to the port's float32
  version);
* the bf16 model at ``layout="cmu"`` (T = 35, V = 25) and ``"3dpw"`` (T =
  40, V = 23), eval and train mode;
* ``models/infer.py::fused_eval_forward`` at bf16 at both layouts, and at
  float32 for the fast model;
* one train step in lockstep with the JAX engine (SGD at a learning rate
  of 1, so the parameters' move is the gradient) of the fast model and of
  the CMU model at bf16, dropout 0: the loss by the rules above, the fast
  model's gradients within 1e-4 of max(|g|, 1) of the JAX ones or, past
  that, as near the float64 gradient as twice the JAX package's own
  distance to it (the rule of ``chip_smoke.py``'s train-step checks:
  float32 summation order alone moves a q/k weight's gradient by about
  1e-4 here, and the two packages' orders differ), the bf16 gradients in the
  relative L2 norm over all parameters below half of their own
  bf16-versus-float32 gap (at one step of two samples bf16 moves them 13%
  from float32, past any fixed bound of a few 1e-2);
* the three new configs: YAML against dict, and the model and engine
  blocks against the JAX YAML each derives from, minus the listed cuts;
* "auto" resolving to bf16 at the configured 128 and to float32 at the JAX
  YAMLs' own 32, through the runner's hint, for a train batch and a ragged
  eval batch;
* seeded CMU and 3DPW trees through ``main.run`` at the cut width for 2
  steps of 64 (bf16 as at 128), writing the JAX runner's files.
"""

import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke as cs
from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.engine.engine import TrainState
from dstdgcn_tpu.kernels import fused as jfused
from dstdgcn_tpu.models import DSTDGCN as JaxDSTDGCN
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu.models import infer as jinfer
from dstdgcn_tpu.ops import dstd as jdstd
from dstdgcn_tpu.runner.action_runner import _HORIZON_HEADS_LONG
from dstdgcn_tpu.data.datasets import define_actions
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.models import DSTDGCN, JointBatchNorm, get_model
from dstdgcn_tpu_torch.models import infer as tinfer
from dstdgcn_tpu_torch.ops import dstd as tops
from dstdgcn_tpu_torch.runner import get_runner
from dstdgcn_tpu_torch.utils.bridge import (flatten_tree, load_flax_variables,
                                            to_flax_variables)
from dstdgcn_tpu_torch.utils.config import EasyDict, resolve
from dstdgcn_tpu_torch.utils.logging import setup_logger

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: ROADMAP.md's holding rules: a bf16 model, a float32 model
BF16_TOL = 2e-2
F32_TOL = 1e-4
#: one bf16 op's plain version against the JAX kernel, over the peak of the
#: float32 output (``tests/test_torch_bf16.py``'s bound)
OP_TOL = 6e-4
#: (input frames, output frames, joints) of each profile's layout
LAYOUTS = {"cmu": (10, 25, 25), "3dpw": (10, 30, 23)}


def _small(layout, fast=False):
    """The model at the cut width: 8 features, 2 layers, dropout 0, the
    layout's own T and V (the fast variant: H36M, T = 10 + 10)."""
    t_in, t_out, v = (10, 10, 22) if fast else LAYOUTS[layout]
    return dict(input_channels=6, input_time_frame=t_in,
                output_time_frame=t_out, st_gcnn_dropout=0.0,
                joints_to_consider=v, num_feature=8, num_layers=2,
                layout=layout)


def _input(layout, n, seed, fast=False):
    kw = _small(layout, fast)
    t = kw["input_time_frame"] + kw["output_time_frame"]
    return (np.random.RandomState(seed).randn(
        n, t, kw["joints_to_consider"], 3) * 2).astype(np.float32)


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


@functools.lru_cache(maxsize=None)
def _bridged(layout, fast=False):
    """An input and a trained-like port model: its initialisation with noise
    on every parameter (gates and biases off zero) and BatchNorm statistics
    set by a float32 train-mode pass; returned with its flax variables,
    which the JAX functions read."""
    x = _input(layout, 2, seed=1, fast=fast)
    model = DSTDGCN(**_small(layout, fast), fast=fast)
    gen = torch.Generator().manual_seed(2)
    for mod in model.modules():
        if isinstance(mod, JointBatchNorm):
            mod.momentum = 1.0
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
        model.train()(torch.from_numpy(x))
    return x, to_flax_variables(model.eval())


def _held(got, want, want32, tol):
    """(error, gap): max |got - want| and max |want - want32| over the peak
    |want32| (the float32 result); the error within ``tol`` and below the
    gap."""
    peak = np.abs(want32).max()
    err = np.abs(np.asarray(got) - want).max() / peak
    gap = np.abs(want - want32).max() / peak
    assert err <= tol and err < gap, (err, gap)
    return err, gap


def _exact_jit(fn, *args):
    """``fn`` jitted and run on ``args`` with XLA's excess precision off, so
    that every bf16 rounding the JAX package writes is kept (XLA:CPU drops
    an f32 -> bf16 -> f32 round trip otherwise, as a jit with the default
    options would).  One lowering of each interpreted kernel: called
    eagerly, the JAX package traces and lowers every kernel call anew,
    which was most of this file's time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_kernel_out(mode, x, weights, agg, dtype):
    """The JAX kernel's float32 output, before its final cast to dtype."""
    body, prep, pad_t = ((jfused._spatial_kernel, jfused._prep_spatial, False)
                         if mode == "spatial" else
                         (jfused._temporal_kernel, jfused._prep_temporal,
                          True))
    return np.asarray(_exact_jit(
        lambda x, *w: jfused._pallas_forward(body, prep, pad_t, x, *w, agg,
                                             dtype),
        jnp.asarray(x), *[jnp.asarray(a) for a in weights]))


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("layout", ["cmu", "3dpw"])
def test_bf16_op_matches_the_jax_kernel_at_the_profile_shapes(layout, mode,
                                                              agg):
    t_in, t_out, v = LAYOUTS[layout]
    t, c = t_in + t_out, 8
    rng = np.random.RandomState(4)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)

    def mk(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    x = rng.randn(2, t, v, c).astype(np.float32)
    weights = [mk(k, pair, pair), np.asarray([0.7], np.float32), mk(k, c, c),
               mk(k, c), mk(k, c, 2), mk(k, 2), mk(k, c, 2), mk(k, 2),
               mk(k, 2, ref, ref), mk(k, ref)]
    want = _jax_kernel_out(mode, x, weights, agg, jnp.bfloat16)
    got, want32 = (getattr(tops, f"kernel_{mode}")(
        *[torch.from_numpy(a) for a in [x] + weights], agg, dtype).numpy()
        for dtype in (torch.bfloat16, None))
    peak = np.abs(want32).max()
    err = np.abs(got - want).max() / peak
    gap = np.abs(want - want32).max() / peak
    assert err <= OP_TOL < gap / 4, (err, gap)


@functools.lru_cache(maxsize=None)
def _jax_bf16_model(layout):
    """The JAX bf16 model's (eval-mode, train-mode) outputs on
    ``_bridged(layout)``, from one ``_exact_jit`` of both."""
    x, variables = _bridged(layout)
    jmodel = JaxDSTDGCN(**_small(layout), use_pallas=True,
                        compute_dtype="bfloat16")

    def both(params, x):
        return (jmodel.apply(params, x, train=False),
                jmodel.apply(params, x, train=True,
                             mutable=["batch_stats"])[0])

    return tuple(np.asarray(a) for a in _exact_jit(both, variables,
                                                   jnp.asarray(x)))


#: the bf16 model against the JAX one: each op agrees (the test above) but
#: the two sum in other orders, so an op's float32 output can differ in its
#: last bit and the next op's bf16 rounding of it flip, which the blocks
#: spread; measured (2 samples) 6.7e-3 and 1.3e-2 (CMU, eval and train)
#: and 9.5e-3 and 7.9e-3 (3DPW) against gaps of 2.4e-2, 2.2e-2, 4.6e-2 and
#: 2.2e-2
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", ["cmu", "3dpw"])
def test_bf16_model_matches_jax_at_the_profile_layouts(layout, train):
    x, variables = _bridged(layout)
    kw = dict(_small(layout), use_pallas=True)
    want = _jax_bf16_model(layout)[int(train)]
    outs = {}
    for dtype in ("bfloat16", None):
        model = DSTDGCN(**kw, compute_dtype=dtype).train(train)
        load_flax_variables(model, variables)
        with torch.no_grad():
            outs[dtype] = model(torch.from_numpy(x)).numpy()
    assert outs["bfloat16"].dtype == np.float32
    assert outs["bfloat16"].shape == x.shape
    _held(outs["bfloat16"], want, outs[None], BF16_TOL)


@pytest.fixture
def xla_rounding(monkeypatch):
    """The JAX XLA path's bf16 contractions as the TPU runs them: operands
    rounded to the dtype, products and sums in float32 (the fused forward's
    in and out layers are XLA ops, which XLA:CPU keeps in float32; a
    test-side emulation, the JAX package is not changed)."""
    monkeypatch.setattr(jdstd, "_cast_dot", lambda v, dt: v if dt is None
                        else v.astype(dt).astype(jnp.float32))


@pytest.mark.parametrize("layout", ["cmu", "3dpw"])
def test_bf16_fused_eval_forward_matches_jax(layout, xla_rounding):
    x, variables = _bridged(layout)
    want = np.asarray(_exact_jit(functools.partial(
        jinfer.fused_eval_forward, num_layers=2, dtype=jnp.bfloat16),
        _to(variables, jnp.asarray), jnp.asarray(x)))
    model = DSTDGCN(**_small(layout)).eval()
    load_flax_variables(model, variables)
    tfused.reset_launch_counts()
    with torch.no_grad():
        got, got32 = (tinfer.fused_eval_forward(
            model, torch.from_numpy(x), dtype=dtype)
            for dtype in (torch.bfloat16, None))
    assert got.dtype == torch.float32
    assert set(tfused.launch_counts().values()) == {0}
    _held(got.numpy(), want, got32.numpy(), BF16_TOL)


def test_fast_fused_eval_forward_matches_jax_and_the_model():
    x, variables = _bridged("h36m", fast=True)
    want = np.asarray(_exact_jit(functools.partial(
        jinfer.fused_eval_forward, num_layers=2, fast=True),
        _to(variables, jnp.asarray), jnp.asarray(x)))
    model = get_model("dstdgcn_fast", use_pallas=True,
                      dstdgcn_fast=_small("h36m", fast=True)).eval()
    load_flax_variables(model, variables)
    assert {m.agg for m in model.modules() if hasattr(m, "wrm")} == {"left"}
    with torch.no_grad():
        got = tinfer.fused_eval_forward(model, torch.from_numpy(x))
        standard = model(torch.from_numpy(x))
    assert got.shape == x.shape == (2, 20, 22, 3)
    norm = max(np.abs(want).max(), 1.0)
    assert np.abs(got.numpy() - want).max() <= F32_TOL * norm
    assert np.abs(got.numpy() - standard.numpy()).max() <= F32_TOL * norm


#: the lockstep engines: plain SGD (the JAX package's solver block, the
#: port's ``engine/solver.py``) at a learning rate of 1, so that each
#: parameter's move in one step is its gradient; one pass a step (no
#: inverse pass: it would double the JAX step's compile time and test the
#: same kernels)
LOCK_ENGINE = dict(learn=dict(opt="adam", lr=1.0, weight_decay=0, gamma=1.0,
                              step_size=1),
                   solver=dict(optimizer_name="sgd", weight_decay=0.0),
                   loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                   use_weight=False, inverse=False, max_iter=-1)


def _variables(name, mcfg):
    """The seeded variables of both engines: the port's initialisation (the
    JAX package's initializers; a JAX one would trace the interpreted
    kernels) with noise on every parameter (gates and biases off zero)."""
    variables = to_flax_variables(get_model(name, **mcfg))
    rng = np.random.RandomState(3)
    return {"params": _to(variables["params"], lambda a: (
        np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(np.float32)),
        "batch_stats": variables["batch_stats"]}


def _port_step(name, mcfg, init, batch):
    """One port train step from ``init``: (total, {parameter: move})."""
    eng = PredictionEngine(dict(LOCK_ENGINE), get_model(name, **mcfg),
                           device="cpu")
    eng.init()
    load_flax_variables(eng.model, init)
    assert eng.set_epoch_lr(0) == 1.0
    total = float(eng.train_step(*batch)["total"])
    before = flatten_tree(init["params"])
    after = flatten_tree(to_flax_variables(eng.model)["params"])
    return total, {k: before[k] - after[k] for k in before}


def _lockstep(name, kw, batch, dtype):
    """One train step of both engines from the same seeded weights:
    (JAX total, port total, {parameter: (JAX move, port move)}, the
    initial variables)."""
    mcfg = {name: kw, "use_pallas": True, "compute_dtype": dtype}
    jeng = JaxEngine(dict(LOCK_ENGINE), jax_get_model(name, **mcfg))
    init = _variables(name, mcfg)
    params = init["params"]
    state = TrainState(params=_to(params, jnp.asarray),
                       batch_stats=_to(init["batch_stats"], jnp.asarray),
                       opt_state=jeng.tx.init(params),
                       dropout_key=jax.random.key(0))
    args = (state, *(jnp.asarray(a) for a in batch),
            jnp.asarray(1.0, jnp.float32))
    step = jeng._build_train_step(None, None, None).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jstate, jl = step(*args)
    total, moved = _port_step(name, mcfg, init, batch)
    before = flatten_tree(params)
    jafter = flatten_tree(_to(jstate.params, np.asarray))
    moves = {k: (before[k] - jafter[k], moved[k]) for k in before}
    return float(jl["total"]), total, moves, init


def _grad64(name, kw, init, batch):
    """The float64 gradient of one pass (the port's plain path in float64)
    at ``init``: {parameter: gradient}."""
    model = get_model(name, **{name: kw}).double()
    load_flax_variables(model, init)
    model.double().train()
    eng = PredictionEngine(dict(LOCK_ENGINE), model, device="cpu")
    b64 = [torch.as_tensor(a, dtype=torch.float64) for a in batch]
    sum(eng._one_pass(b64[0], b64[2], None, None, None).values()).backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return flatten_tree(to_flax_variables(model)["params"])


def _grad_held(moves, grads64, tol):
    """{parameter: held}: the port's gradient within ``tol`` of max(|g|,
    1) of the JAX one, or within max(tol, twice the JAX gradient's
    distance) of the float64 gradient, over the same norm."""
    held = {}
    for k, (a, b) in moves.items():
        norm = max(np.abs(a).max(), 1.0)
        near = np.abs(b - a).max() / norm <= tol
        held[k] = near or np.abs(b - grads64[k]).max() / norm <= max(
            tol, 2 * np.abs(a - grads64[k]).max() / norm)
    return held


def _grad_l2(moves):
    """The gradients' distance in the L2 norm over all parameters, over the
    norm of the JAX gradients."""
    num = sum(((b - a) ** 2).sum() for a, b in moves.values())
    return float(np.sqrt(num / sum((a ** 2).sum()
                                   for a, _ in moves.values())))


def test_fast_model_train_step_matches_jax_engine():
    kw = _small("h36m", fast=True)
    ds = Synthetic(layout="h36m", num_sequences=2, input_n=10, output_n=10,
                   mode="train")
    batch = ds.arrays()[:3]
    jtotal, total, moves, init = _lockstep("dstdgcn_fast", kw, batch, None)
    assert abs(total - jtotal) <= F32_TOL * abs(jtotal)
    assert len(moves) == len(flatten_tree(to_flax_variables(get_model(
        "dstdgcn_fast", dstdgcn_fast=kw))["params"]))
    held = _grad_held(moves, _grad64("dstdgcn_fast", kw, init, batch),
                      F32_TOL)
    assert all(held.values()), [k for k, h in held.items() if not h]


def test_cmu_bf16_train_step_matches_jax_engine():
    kw = _small("cmu")
    ds = Synthetic(layout="cmu", num_sequences=2, input_n=10, output_n=25,
                   mode="train")
    batch = ds.arrays()[:3]
    jtotal, total, moves, init = _lockstep("dstdgcn", kw, batch, "bfloat16")
    total32, moved32 = _port_step("dstdgcn", {"dstdgcn": kw,
                                              "use_pallas": True}, init,
                                  batch)
    # the loss within the rule (a mean over every output: bf16 moves it by
    # about 1e-6, below the two packages' own float32 differences, so it
    # cannot tell the dtypes apart); the gradients below half their gap
    err = abs(total - jtotal) / abs(jtotal)
    assert err <= BF16_TOL, err
    assert abs(total32 - jtotal) / abs(jtotal) <= BF16_TOL
    gerr = _grad_l2(moves)
    ggap = _grad_l2({k: (moves[k][0], moved32[k]) for k in moves})
    print(f"bf16 lockstep: loss {err:.3g}, gradients {gerr:.3g} against a "
          f"gap of {ggap:.3g} (L2)")
    assert gerr < ggap / 2, (gerr, ggap)


PORT_CONFIGS = {"real_cmu_tpu_train": "dstdgcn_cmu_tpu.yaml",
                "real_3dpw_tpu_train": "dstdgcn_3dpw_tpu.yaml",
                "synthetic_h36m_fast_train": "dstdgcn_fast_multihost.yaml"}


def _yaml(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_config_yaml_equals_dict(name):
    raw = _yaml("dstdgcn_tpu_torch", "configs", f"{name}.yaml")
    assert raw == getattr(configs, name.upper()) == getattr(configs, name)()


@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_config_blocks_are_the_jax_configs_but_for_the_cuts(name):
    raw = getattr(configs, name)()
    shipped = _yaml("configs", PORT_CONFIGS[name])
    key = shipped["model"]["name"]
    assert raw["model"][key] == shipped["model"][key]
    assert raw["model"]["use_pallas"] is True
    assert "use_pallas" not in shipped["model"]
    width = raw["model"][key]
    if name == "synthetic_h36m_fast_train":
        assert (width["num_feature"], width["num_layers"]) == (16, 2)
        assert "parallel" not in raw and "parallel" in shipped
        assert raw["engine"] == shipped["engine"]
        for block in ("runner", "dataset", "setting", "train_batch_size",
                      "test_batch_size", "epoch", "mode"):
            assert raw[block] == shipped[block], block
        return
    assert (width["num_feature"], width["num_layers"]) == (64, 5)
    assert width["compute_dtype"] == "auto"
    assert width["st_gcnn_dropout"] == 0.1
    assert raw["engine"]["prng_impl"] == "rbg"
    # the cuts: batch 128, one epoch of 4 steps, the data paths
    assert raw["train_batch_size"] == raw["test_batch_size"] == 128
    assert shipped["train_batch_size"] == shipped["test_batch_size"] == 32
    assert raw["epoch"] == 1 and raw["engine"]["max_iter"] == 4
    assert raw["engine"] == dict(shipped["engine"], max_iter=4)
    for block in ("runner", "setting", "mode"):
        assert raw[block] == shipped[block], block
    data = raw["dataset"]["name"]
    for split in ("train", "test"):
        got = dict(raw["dataset"][split][data])
        want = dict(shipped["dataset"][split][data])
        assert got.pop("data_path") and want.pop("data_path")
        assert got == want


def _runner_model(name, batch, tmp_path):
    """The model a runner builds for ``real_<name>_tpu_train`` at a
    configured batch of ``batch`` (test mode: nothing is read)."""
    cfg = resolve(getattr(configs, f"real_{name}_tpu_train")())
    cfg.update(train_batch_size=batch, test_batch_size=batch, mode="test")
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1)
    cfg["save"]["path"]["base"] = str(tmp_path)
    cfg["logger"] = setup_logger("profiles", str(tmp_path))
    return get_runner(cfg["runner"], EasyDict(cfg),
                      device="cpu").engine.model


@pytest.mark.parametrize("name", ["cmu", "3dpw"])
def test_auto_resolves_to_bf16_at_128_and_float32_at_32(name, tmp_path):
    """The runner pins "auto" to the configured train batch: at 128 a train
    batch and a ragged eval batch (66 windows, a CMU action's) run bf16, at
    the JAX YAMLs' own 32 both run float32."""
    t_in, t_out, v = LAYOUTS[name]
    x = torch.from_numpy(np.random.RandomState(0).randn(
        66, t_in + t_out, v, 3).astype(np.float32))
    for batch, dtype in ((128, "bfloat16"), (32, None)):
        model = _runner_model(name, batch, tmp_path / str(batch))
        assert model.auto_batch_hint == batch
        for n in (batch, 66):
            assert model.resolve_knobs(n)["compute_dtype"] == dtype
        with torch.no_grad():
            model.eval()(x)
        assert model.active_dtype == dtype
        assert {m.compute_dtype for m in model.modules()
                if hasattr(m, "wrm")} == {dtype}


def _heads(name):
    if name == "3dpw":
        return ["test_loss"] + [f"3d{(f + 1) * 40}"
                                for f in (4, 9, 14, 19, 24)]
    return ["test_loss"] + _HORIZON_HEADS_LONG + [
        act + h for act in define_actions("all", name)
        for h in _HORIZON_HEADS_LONG]


@pytest.mark.parametrize("name", ["cmu", "3dpw"])
def test_profile_runs_on_a_seeded_tree(name, tmp_path):
    """``main.run`` on the profile at the cut width, 2 steps of 64 (where
    "auto" resolves to bf16 as at 128; the batch halves the CPU time):
    "auto" resolves to bf16, and the run writes the JAX runner's
    ``training_loss.csv`` (the best row appended) and both checkpoints."""
    root = str(tmp_path / "data")
    paths = (cs.write_cmu_tree(root, seed=8, files=(1, 1),
                               frames=(120, 100)) if name == "cmu"
             else cs.write_pw3d_tree(root, seed=9, files=(3, 1),
                                     frames=(70, 50)))
    cfg = configs.set_data_paths(getattr(configs, f"real_{name}_tpu_train")(),
                                 *paths)
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=2)
    cfg.update(train_batch_size=64, test_batch_size=64)
    cfg["engine"]["max_iter"] = 2
    cfg["save"]["path"]["base"] = str(tmp_path / "run")
    tfused.reset_launch_counts()
    runner, history = run(cfg, "cpu")
    model = runner.engine.model
    assert model.auto_batch_hint == 64
    assert model.active_dtype == "bfloat16"
    assert len(runner.engine.train_step_seconds) == 2
    with open(tmp_path / "run" / "training_loss.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "lr", "train_loss"] + _heads(name)
    assert len(rows) == 3 and rows[1] == rows[2]
    got = np.array([float(v) for v in rows[1]])
    np.testing.assert_array_equal(got, history[0])
    assert np.all(np.isfinite(got))
    for ckpt in ("last.ckpt", "best.ckpt"):
        assert (tmp_path / "run" / "checkpoints" / ckpt).is_file()
    # on CPU tensors the wrappers run the plain ops and count no launch
    assert set(tfused.launch_counts().values()) == {0}
