"""The port's parallel layer (``dstdgcn_tpu_torch/parallel/``) against the
JAX package's, over spawned gloo ranks on the CPU.

Each launch starts one process a rank (this file run as a script, with the
``DSTDGCN_*`` variables and a ``file://`` rendezvous under the test's
``tmp_path``); the ranks import only ``dstdgcn_tpu_torch`` and write their
results to ``.npz`` / ``.json`` files, and this process holds them against
the JAX functions on its virtual 8-device mesh (``tests/conftest.py``) and
against the port's plain ops.  Two launches serve every multi-rank test:

* 2 ranks: the three ``shard.py`` ops on a graph=2 mesh; ``JointBatchNorm``
  over the data group (with and without ``axis_name``); a data-parallel
  train step of a small model; the ``graph`` and ``model`` axes refused
  through the runner (ROADMAP items 4b, 4c);
* 4 ranks: the three ops on a graph=4 mesh and the order of the ring's
  posts, waits and round computes (the counterpart of
  ``dstdgcn_tpu/parallel/hlo_check.py``).

Tolerances: op outputs within 1e-5 of the JAX functions; gradients within
1e-5 max(|g|, 1) of autograd through ``ops/dstd.py``; BatchNorm within
1e-5 of one rank on the whole batch; the train step's losses within 1e-4
relative and its Adam moments by ``tests/test_parallel.py``'s rule; both
ranks' state after the step bit-equal.
"""

import json
import logging
import os
import pathlib
import subprocess
import sys
import time
from collections.abc import Mapping

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
#: seconds a whole launch may take before its ranks are killed
LAUNCH_TIMEOUT = 180
OPS = ("spatial_edge", "spatial_ring", "temporal_edge")
WEIGHTS = ("wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm")
#: the small model of tests/test_parallel.py's train-step test
STEP_MODEL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
                  st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
                  num_layers=1, layout="h36m")
STEP_CFG = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                           step_size=5),
                loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                use_weight=False, inverse=True, max_iter=-1)
BN_SHAPE = (8, 5, 6, 4)          # N, T, V, C
BN_AXES = {"none": None, "data": "data"}


# -- the inputs (numpy, seeded as tests/test_parallel.py seeds them) ---------

def _op_case(seed, mode):
    rng = np.random.RandomState(seed)
    if mode == "spatial":
        n, t, v, cin, co, k, alpha = 3, 7, 8, 6, 5, 2, 0.7
        x = rng.randn(n, t, v, cin).astype(np.float32)
        base = (rng.randn(k, v, v) * 0.3).astype(np.float32)
        ref = t
    else:
        n, t, v, cin, co, k, alpha = 3, 6, 8, 5, 5, 1, 0.5
        x = rng.randn(n, t, v, cin).astype(np.float32)
        base = (rng.randn(k, t, t) * 0.3).astype(np.float32)
        ref = v
    red = 2
    case = dict(x=x, base=base, alpha=np.asarray(alpha, np.float32),
                wf=rng.randn(k, cin, co) * 0.2, bf=rng.randn(k, co) * 0.1,
                wm1=rng.randn(k, cin, red) * 0.2, bm1=rng.randn(k, red) * 0.1,
                wm2=rng.randn(k, cin, red) * 0.2, bm2=rng.randn(k, red) * 0.1,
                wrm=rng.randn(k, red, ref, ref) * 0.2,
                brm=rng.randn(k, ref) * 0.1)
    case = {key: np.asarray(val, np.float32) for key, val in case.items()}
    case["g"] = np.random.RandomState(seed + 10).randn(
        n, t, v, co).astype(np.float32)
    return case


def _op_cases():
    return {"spatial_edge": _op_case(0, "spatial"),
            "spatial_ring": _op_case(4, "spatial"),
            "temporal_edge": _op_case(1, "temporal")}


def _step_batch():
    rng = np.random.RandomState(0)
    batch = rng.randn(8, 8, 66).astype(np.float32)
    targets = rng.randn(8, 8, 66).astype(np.float32)
    return batch, batch[:, ::-1].copy(), targets


def _bn_case():
    rng = np.random.RandomState(7)
    return dict(x=(rng.randn(*BN_SHAPE) * 2 + 0.5).astype(np.float32),
                g=rng.randn(*BN_SHAPE).astype(np.float32),
                scale=(1 + 0.1 * rng.randn(*BN_SHAPE[2:])).astype(np.float32),
                bias=(0.1 * rng.randn(*BN_SHAPE[2:])).astype(np.float32))


def _flatten(tree, prefix="", leaf=np.asarray):
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}.", leaf))
        else:
            out[f"{prefix}{key}"] = leaf(val)
    return out


def _nest(flat):
    out = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


# -- the rank side (run as a script: imports only dstdgcn_tpu_torch) ---------

def _gather(t, dim, group):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim).numpy()


def _shard_results(mesh, cases):
    """Each op on this rank's joint slice with a cotangent: the gathered
    output and x gradient, and every other leaf's gradient summed over the
    ranks."""
    import torch.distributed as dist
    from dstdgcn_tpu_torch.parallel import shard
    fns = dict(spatial_edge=shard.dstd_spatial_edge_partitioned,
               spatial_ring=shard.dstd_spatial_ring,
               temporal_edge=shard.dstd_temporal_edge_partitioned)
    group, n, i = mesh.group("graph"), mesh.shape["graph"], \
        mesh.index("graph")
    res = {}
    for op, fn in fns.items():
        case = {k: torch.from_numpy(v) for k, v in cases[op].items()}
        vl = case["x"].shape[2] // n
        cut = slice(i * vl, (i + 1) * vl)
        x = case["x"][:, :, cut].clone().requires_grad_()
        leaves = {k: case[k].clone().requires_grad_()
                  for k in ("base", "alpha") + WEIGHTS}
        y = fn(mesh, x, leaves["base"], leaves["alpha"],
               *[leaves[k] for k in WEIGHTS])
        (y * case["g"][:, :, cut]).sum().backward()
        res[f"{op}/out"] = _gather(y.detach(), 2, group)
        res[f"{op}/dx"] = _gather(x.grad, 2, group)
        for k, t in leaves.items():
            total = t.grad.clone()
            dist.all_reduce(total, group=group)
            res[f"{op}/d{k}"] = total.numpy()
    return res


def _ring_order(mesh, case):
    """The ring op once more, recording its posts, round computes and
    waits in order; each post says whether what it sends descends from a
    round's compute (its autograd graph holds a tanh or a round's
    output)."""
    from dstdgcn_tpu_torch.parallel import collectives, shard
    events, outputs = [], set()
    post, wait, round_ = (collectives.RingShift.post,
                          collectives.RingShift.wait, shard._ring_round)

    def reaches_compute(t):
        seen, stack = set(), [t.grad_fn]
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if node in outputs or "Tanh" in type(node).__name__:
                return True
            stack.extend(f for f, _ in node.next_functions)
        return False

    def posted(self, *tensors):
        events.append(dict(kind="post", depends=any(
            reaches_compute(t) for t in tensors)))
        return post(self, *tensors)

    def waited(self, received):
        events.append(dict(kind="wait"))
        return wait(self, received)

    def computed(*args):
        out = round_(*args)
        outputs.add(out.grad_fn)
        events.append(dict(kind="compute"))
        return out

    collectives.RingShift.post, collectives.RingShift.wait = posted, waited
    shard._ring_round = computed
    try:
        c = {k: torch.from_numpy(v).requires_grad_() for k, v in case.items()}
        vl = c["x"].shape[2] // mesh.shape["graph"]
        i = mesh.index("graph")
        shard.dstd_spatial_ring(mesh, c["x"][:, :, i * vl:(i + 1) * vl],
                                c["base"], c["alpha"],
                                *[c[k] for k in WEIGHTS])
    finally:
        collectives.RingShift.post, collectives.RingShift.wait = post, wait
        shard._ring_round = round_
    return events


def _bn_results(mesh, case):
    """JointBatchNorm over the data group on this rank's contiguous share
    of the batch, with and without ``axis_name``."""
    import torch.distributed as dist
    from dstdgcn_tpu_torch.models import JointBatchNorm
    from dstdgcn_tpu_torch.parallel import activation_sharding_context
    group, n, i = mesh.group("data"), mesh.shape["data"], mesh.index("data")
    share = BN_SHAPE[0] // n
    cut = slice(i * share, (i + 1) * share)
    res = {}
    for label, axis in BN_AXES.items():
        bn = JointBatchNorm(BN_SHAPE[2], BN_SHAPE[3], axis_name=axis)
        with torch.no_grad():
            bn.scale.copy_(torch.from_numpy(case["scale"]))
            bn.bias.copy_(torch.from_numpy(case["bias"]))
        x = torch.from_numpy(case["x"][cut]).requires_grad_()
        with activation_sharding_context(mesh):
            out = bn.train()(x)
        (out * torch.from_numpy(case["g"][cut])).sum().backward()
        res[f"bn/{label}/out"] = _gather(out.detach(), 0, group)
        res[f"bn/{label}/dx"] = _gather(x.grad, 0, group)
        for name in ("scale", "bias"):
            total = getattr(bn, name).grad.clone()
            dist.all_reduce(total, group=group)
            res[f"bn/{label}/d{name}"] = total.numpy()
        res[f"bn/{label}/mean"] = bn.mean.numpy().copy()
        res[f"bn/{label}/var"] = bn.var.numpy().copy()
    return res


def _step_results(mesh, flat_vars):
    """One data-parallel train step of the small model from the JAX
    weights on this rank's share (``idx[rank::world]``) of the global
    batch: the losses, the state after the step and the Adam moments."""
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    from dstdgcn_tpu_torch.utils.bridge import load_flax_variables
    model = get_model("dstdgcn", dstdgcn=STEP_MODEL)
    eng = PredictionEngine(STEP_CFG, model, device="cpu", mesh=mesh)
    eng.init(seed=0)
    load_flax_variables(model, _nest(flat_vars))
    i, n = mesh.index("data"), mesh.shape["data"]
    losses = eng.train_step(*[a[i::n] for a in _step_batch()])
    res = {f"step/loss/{k}": v.numpy() for k, v in losses.items()}
    res.update({f"step/state/{k}": v.numpy().copy()
                for k, v in model.state_dict().items()})
    for name, p in model.named_parameters():
        state = eng.optimizer.state[p]
        res[f"step/mu/{name}"] = state["exp_avg"].numpy().copy()
        res[f"step/nu/{name}"] = state["exp_avg_sq"].numpy().copy()
    return res


def _refusals(tmp, rank):
    """The runner with ``parallel: {graph: 2}`` and ``{model: 2}``: the
    NotImplementedError messages."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.runner import get_runner
    from dstdgcn_tpu_torch.utils.config import EasyDict, resolve
    msgs = {}
    for axis in ("graph", "model"):
        cfg = configs.synthetic_h36m_train()
        cfg["parallel"] = {axis: 2}
        cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1)
        cfg["save"]["path"]["base"] = str(tmp / f"refused_{axis}_{rank}")
        opts = EasyDict(resolve(cfg))
        opts["logger"] = logging.getLogger(f"refused_{rank}")
        try:
            get_runner("synthetic", opts, device="cpu")
        except NotImplementedError as e:
            msgs[axis] = str(e)
    return msgs


def _rank_main(scenario, tmp):
    from dstdgcn_tpu_torch.parallel import distributed, make_mesh
    torch.set_num_threads(1)
    rank, world = distributed.initialize(None, device="cpu")
    inputs = dict(np.load(tmp / "inputs.npz"))
    cases = {op: {k.split("/", 1)[1]: v for k, v in inputs.items()
                  if k.startswith(op + "/")} for op in OPS}
    res = _shard_results(make_mesh(graph=world), cases)
    extra = {}
    if scenario == "pair":
        dmesh = make_mesh(data=world)
        bn = {k.split("/", 1)[1]: v for k, v in inputs.items()
              if k.startswith("bn/")}
        res.update(_bn_results(dmesh, bn))
        res.update(_step_results(dmesh, {
            k.split("/", 1)[1]: v for k, v in inputs.items()
            if k.startswith("var/")}))
        extra["refusals"] = _refusals(tmp, rank)
    else:
        extra["ring_order"] = _ring_order(make_mesh(graph=world),
                                          cases["spatial_ring"])
    np.savez(tmp / f"rank{rank}.npz", **res)
    (tmp / f"rank{rank}.json").write_text(json.dumps(extra))


# -- the launcher --------------------------------------------------------------

def _start(world, scenario, tmp):
    """Start ``scenario`` on ``world`` ranks."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DSTDGCN_COORDINATOR=f"file://{tmp}/rendezvous",
               DSTDGCN_NUM_PROCESSES=str(world))
    return [subprocess.Popen(
        [sys.executable, __file__, scenario, str(tmp)],
        env=dict(env, DSTDGCN_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs, tmp, deadline):
    """Wait for the ranks of :func:`_start` until ``deadline`` (killing
    them on a failure or past it); every rank's (npz, json)."""
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
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, \
            f"rank {r} of {len(procs)} failed:\n{log[-6000:]}"
    return [(dict(np.load(tmp / f"rank{r}.npz")),
             json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(len(procs))]


def _jax_step(batch, inv, targets):
    """The JAX engine's single-device step on the global batch: its
    initial variables (flat), losses and Adam moments (flat, by name)."""
    import jax
    import jax.numpy as jnp
    from dstdgcn_tpu.engine import PredictionEngine as JEngine
    from dstdgcn_tpu.models import DSTDGCN as JDSTDGCN
    jeng = JEngine(dict(STEP_CFG), JDSTDGCN(**STEP_MODEL))
    jeng.init(batch[:1], seed=0)
    variables = _flatten({"params": jax.tree.map(np.asarray,
                                                 jeng.state.params),
                          "batch_stats": jax.tree.map(
                              np.asarray, jeng.state.batch_stats)})
    step = jeng._build_train_step(None, None, None)
    state, losses = step(jeng.state, jnp.asarray(batch), jnp.asarray(inv),
                         jnp.asarray(targets), jnp.asarray(1e-3))
    moments = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state.opt_state)[0]:
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        for which in ("mu", "nu"):
            if which in keys:
                rest = keys[keys.index(which) + 1:]
                moments[f"{which}/" + ".".join(map(str, rest))] = \
                    np.asarray(leaf)
    return variables, {k: float(v) for k, v in losses.items()}, moments


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches, run side by side while this process takes the JAX
    engine's step and the JAX ops: {"pair": (ranks, JAX losses, JAX
    moments), "quad": ranks, "jax_ops": {(op, ranks): output}}."""
    import jax
    from dstdgcn_tpu.models import DSTDGCN as JDSTDGCN
    ops = {f"{op}/{k}": v for op, case in _op_cases().items()
           for k, v in case.items()}
    variables = _flatten(jax.tree.map(np.asarray, JDSTDGCN(**STEP_MODEL).init(
        {"params": jax.random.key(0)}, np.zeros((1, 8, 22, 3), np.float32),
        train=False)))
    tmp = {name: tmp_path_factory.mktemp(name) for name in ("pair", "quad")}
    np.savez(tmp["pair"] / "inputs.npz", **ops,
             **{f"bn/{k}": v for k, v in _bn_case().items()},
             **{f"var/{k}": v for k, v in variables.items()})
    np.savez(tmp["quad"] / "inputs.npz", **ops)
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    procs = {"pair": _start(2, "pair", tmp["pair"]),
             "quad": _start(4, "quad", tmp["quad"])}
    try:
        jvars, jlosses, jmoments = _jax_step(*_step_batch())
        jax_ops = {(op, n): _jax_op(op, n, case)
                   for op, case in _op_cases().items() for n in (2, 4)}
    finally:
        ranks = {name: _finish(p, tmp[name], deadline)
                 for name, p in procs.items()}
    assert jvars.keys() == variables.keys()
    for key, val in variables.items():
        np.testing.assert_array_equal(jvars[key], val, err_msg=key)
    return {"pair": (ranks["pair"], jlosses, jmoments), "quad": ranks["quad"],
            "jax_ops": jax_ops}


@pytest.fixture(scope="module")
def pair(launches):
    return launches["pair"]


@pytest.fixture(scope="module")
def quad(launches):
    return launches["quad"]


# -- the tests -------------------------------------------------------------------

def _jax_op(op, n, case):
    import jax.numpy as jnp
    from dstdgcn_tpu.parallel import (dstd_spatial_edge_partitioned,
                                      dstd_spatial_ring,
                                      dstd_temporal_edge_partitioned,
                                      make_mesh)
    fn = dict(spatial_edge=dstd_spatial_edge_partitioned,
              spatial_ring=dstd_spatial_ring,
              temporal_edge=dstd_temporal_edge_partitioned)[op]
    return np.asarray(fn(make_mesh(graph=n), jnp.asarray(case["x"]),
                         jnp.asarray(case["base"]),
                         jnp.asarray(case["alpha"]),
                         *[jnp.asarray(case[k]) for k in WEIGHTS]))


def _plain_grads(op, case):
    """Autograd through the port's plain op on the whole input."""
    from dstdgcn_tpu_torch.ops import dstd
    fn = dstd.dstd_spatial if op.startswith("spatial") else dstd.dstd_temporal
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in case.items() if k != "g"}
    y = fn(leaves["x"], leaves["base"], leaves["alpha"],
           *[leaves[k] for k in WEIGHTS])
    (y * torch.from_numpy(case["g"])).sum().backward()
    return {f"d{k}": t.grad.numpy() for k, t in leaves.items()}


def _held(got, want, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    return float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("ranks", [2, 4])
def test_shard_op_matches_jax_and_plain_gradients(op, ranks, launches):
    results = launches["pair"][0] if ranks == 2 else launches["quad"]
    res = results[0][0]
    case = _op_cases()[op]
    np.testing.assert_allclose(res[f"{op}/out"],
                               launches["jax_ops"][(op, ranks)],
                               rtol=1e-5, atol=1e-5)
    want = _plain_grads(op, case)
    for name, g in want.items():
        assert _held(res[f"{op}/{name}"], g, 1e-5), (
            op, ranks, name, float(np.abs(res[f"{op}/{name}"] - g).max()))


def test_ring_posts_before_compute_and_sends_no_round_result(quad):
    """Every rank: round r's shift is posted before round r's compute and
    waited for after it, and no sent tensor descends from a round's
    compute (so the transfer can run under the round's math)."""
    for _, extra in quad:
        kinds = [e["kind"] for e in extra["ring_order"]]
        # 4 ranks: rounds 0-2 post, compute, wait; round 3 only computes
        assert kinds == ["post", "compute", "wait"] * 3 + ["compute"], kinds
        assert not any(e.get("depends") for e in extra["ring_order"])


@pytest.mark.parametrize("label", list(BN_AXES))
def test_joint_batchnorm_over_two_ranks_matches_one_rank(pair, label):
    from dstdgcn_tpu_torch.models import JointBatchNorm
    (r0, _), (r1, _) = pair[0]
    case = _bn_case()
    bn = JointBatchNorm(BN_SHAPE[2], BN_SHAPE[3])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = bn.train()(x)
    (out * torch.from_numpy(case["g"])).sum().backward()
    want = dict(out=out.detach().numpy(), dx=x.grad.numpy(),
                dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.mean.numpy(), var=bn.var.numpy())
    for name, w in want.items():
        np.testing.assert_allclose(r0[f"bn/{label}/{name}"], w, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name in ("mean", "var"):
        np.testing.assert_array_equal(r0[f"bn/{label}/{name}"],
                                      r1[f"bn/{label}/{name}"])


def test_data_parallel_step_matches_the_jax_single_device_step(pair):
    (r0, _), (r1, _) = pair[0]
    jlosses, jmoments = pair[1], pair[2]
    assert "joint" in jlosses
    for name, want in jlosses.items():
        np.testing.assert_allclose(float(r0[f"step/loss/{name}"]), want,
                                   rtol=1e-4, err_msg=name)
    assert {k for k in r0 if k.startswith(("step/mu/", "step/nu/"))} == {
        f"step/{k}" for k in jmoments}
    for key, a in jmoments.items():
        b = r0[f"step/{key}"]
        if a.dtype.kind == "f" and a.size > 1:
            assert np.max(np.abs(a - b)) < max(2e-3 * np.abs(a).max(),
                                               1e-8), key
    # every rank steps the same averaged gradient from the same weights
    state = [k for k in r0 if k.startswith("step/state/")]
    assert state
    for key in state:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_graph_and_model_axes_over_two_processes_are_refused(pair):
    for _, extra in pair[0]:
        assert "item 4b" in extra["refusals"]["graph"]
        assert "item 4c" in extra["refusals"]["model"]


@pytest.mark.parametrize("data", [2, 4])
def test_per_chip_batch_matches_jax_under_a_data_mesh(data):
    from dstdgcn_tpu.models import autotune as jtune
    from dstdgcn_tpu.parallel import activation_sharding_context as jctx
    from dstdgcn_tpu.parallel import make_mesh as jmesh
    from dstdgcn_tpu_torch.models import autotune
    from dstdgcn_tpu_torch.parallel import Mesh, activation_sharding_context
    sizes = [1, 3, 16, 32, 63, 64, 128, 256, 512, 1024]
    with jctx(jmesh(data=data)):
        want = [jtune.per_chip_batch(b) for b in sizes]
    mesh = Mesh({"data": data, "graph": 1}, {}, {})
    with activation_sharding_context(mesh):
        got = [autotune.per_chip_batch(b) for b in sizes]
        # the runner's hint is the global batch, read per chip
        hinted = autotune.resolve_knob("compute_dtype", "auto", 16,
                                       batch_hint=64 * data)
    assert got == want
    assert hinted == "bfloat16"
    assert [autotune.per_chip_batch(b) for b in sizes] == sizes


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_sharding_gives_the_jax_specs(model):
    import jax
    from dstdgcn_tpu.models import DSTDGCN as JDSTDGCN
    from dstdgcn_tpu.parallel import make_mesh as jmesh
    from dstdgcn_tpu.parallel import param_sharding as jsharding
    from dstdgcn_tpu_torch.models import get_model
    from dstdgcn_tpu_torch.parallel import Mesh, param_sharding
    variables = jax.tree.map(np.asarray, JDSTDGCN(**STEP_MODEL).init(
        {"params": jax.random.key(0)}, np.zeros((1, 8, 22, 3), np.float32),
        train=False))
    jmesh_ = jmesh(data=8 // model, graph=1, model=model)
    want = _flatten(jsharding(jmesh_, variables),
                    leaf=lambda s: tuple(s.spec))
    shape = {"data": 8 // model, "graph": 1}
    if model > 1:
        shape["model"] = model
    mesh = Mesh(shape, {}, {})
    assert _flatten(param_sharding(mesh, variables),
                    leaf=lambda s: s) == want
    # the port's flat names (a state dict) give each leaf the same spec
    flat = param_sharding(mesh, get_model("dstdgcn", dstdgcn=STEP_MODEL)
                          .state_dict())
    by_name = {k.split(".", 1)[1]: v for k, v in want.items()}
    assert flat == {k: by_name[k] for k in flat}
    assert (model > 1) == any("model" in s for s in flat.values())


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1], pathlib.Path(sys.argv[2]))
