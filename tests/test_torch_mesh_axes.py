"""The graph and model mesh axes of the port's engine against the JAX
engine's single-device step, over spawned gloo ranks on the CPU.

GSPMD gives the JAX engine its single-device semantics at the same global
batch under any mesh (``tests/test_parallel.py``); the port runs the same
meshes as explicit collectives (``parallel/``, ``models/layers.py``,
``engine/engine.py``).  Two launches serve every test, each one process a
rank (this file run as a script, ``file://`` rendezvous under the test's
``tmp_path``), each running all the scenarios of its rank count:

* 2 ranks: graph=2 at V = 22 and at V = 25 (the CMU layout, an uneven
  split: joints 0-12 and 13-24), model=2, the fast variant under graph=2,
  ``remat: True`` under graph=2;
* 4 ranks: data=2 x graph=2, model=4, data=2 x model=2, graph=2 x model=2,
  ``use_pallas: True`` under data=2 x graph=2 (``inverse: False``, as the
  JAX test of the fused kernels under a mesh has it);

and the edge-partitioned ``shard.py`` ops, both aggregations, on V = 10
joints over all the launch's ranks (2: 5 + 5; 4: 3 + 3 + 3 + 1).  The
model is ``tests/test_parallel.py``'s (8 features, 1 layer, T = 8, dropout
0), loaded with the JAX engine's initial variables; the global batch is 8,
each rank taking its data index's share.

Tolerances: the losses within 1e-4 relative of the JAX single-device step;
the Adam moments by ``tests/test_parallel.py``'s rule; the state after the
step bit-equal on every rank; ``engine.test``'s per-frame MPJPE (one
scenario of each axis and one of both), and with ``engine.fused_inference``
(which runs whole on each rank), within 1e-4 relative of one process on the
whole batches; the ops' outputs within 1e-5 of the JAX op on the
whole input and their gradients within 1e-5 max(|g|, 1) of autograd
through ``ops/dstd.py``.
"""

import json
import os
import pathlib
import subprocess
import sys
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
#: seconds a whole launch may take before its ranks are killed
LAUNCH_TIMEOUT = 240
WEIGHTS = ("wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm")
CFG = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                      step_size=5),
           loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
           use_weight=False, inverse=True, max_iter=-1)
#: the JAX single-device steps the scenarios are held against: the model
#: (tests/test_parallel.py's, at the layout's joints) and engine options
REFS = {"h36m": dict(v=22, layout="h36m"),
        "cmu": dict(v=25, layout="cmu"),
        "fast": dict(v=22, layout="h36m", fast=True),
        "pallas": dict(v=22, layout="h36m", use_pallas=True, inverse=False)}
#: scenario -> (ranks, mesh, reference, port-only model options, eval)
SCENARIOS = {
    "graph": (2, dict(data=1, graph=2), "h36m", {}, True),
    "graph_cmu": (2, dict(data=1, graph=2), "cmu", {}, False),
    "model": (2, dict(data=1, model=2), "h36m", {}, True),
    "fast_graph": (2, dict(data=1, graph=2), "fast", {}, False),
    "remat_graph": (2, dict(data=1, graph=2), "h36m", dict(remat=True),
                    False),
    "data_graph": (4, dict(data=2, graph=2), "h36m", {}, False),
    "model4": (4, dict(data=1, model=4), "h36m", {}, False),
    "data_model": (4, dict(data=2, model=2), "h36m", {}, False),
    "graph_model": (4, dict(data=1, graph=2, model=2), "h36m", {}, True),
    "pallas_data_graph": (4, dict(data=2, graph=2), "pallas", {}, False),
}
OP_V = 10
OP_CASES = [(mode, agg) for mode in ("spatial", "temporal")
            for agg in ("left", "right")]
EVAL_FRAMES = [1, 3]


def _model_kwargs(ref):
    r = REFS[ref]
    return dict(input_channels=6, input_time_frame=4, output_time_frame=4,
                st_gcnn_dropout=0.0, joints_to_consider=r["v"],
                num_feature=8, num_layers=1, layout=r["layout"])


def _engine_cfg(ref):
    return dict(CFG, inverse=REFS[ref].get("inverse", True))


# -- the inputs (numpy, seeded) ---------------------------------------------

def _batch(v):
    rng = np.random.RandomState(0)
    batch = rng.randn(8, 8, 3 * v).astype(np.float32)
    targets = rng.randn(8, 8, 3 * v).astype(np.float32)
    return batch, batch[:, ::-1].copy(), targets


def _eval_batches(v):
    """Two global test batches of 8 sequences: (inputs, inverse inputs,
    targets, whole sequences)."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(2):
        seq = rng.randn(8, 8, 3 * v).astype(np.float32)
        out.append((seq, seq[:, ::-1].copy(), seq, seq))
    return out


def _op_case(mode, seed):
    rng = np.random.RandomState(seed)
    n, t, v, cin, co = 3, 6, OP_V, 5, 4
    k, ref = (2, t) if mode == "spatial" else (1, v)
    pair = v if mode == "spatial" else t
    red = 2
    case = dict(x=rng.randn(n, t, v, cin), base=rng.randn(k, pair, pair) * .3,
                alpha=np.asarray(0.6), wf=rng.randn(k, cin, co) * 0.2,
                bf=rng.randn(k, co) * 0.1, wm1=rng.randn(k, cin, red) * 0.2,
                bm1=rng.randn(k, red) * 0.1, wm2=rng.randn(k, cin, red) * 0.2,
                bm2=rng.randn(k, red) * 0.1,
                wrm=rng.randn(k, red, ref, ref) * 0.2,
                brm=rng.randn(k, ref) * 0.1, g=rng.randn(n, t, v, co))
    return {key: np.asarray(val, np.float32) for key, val in case.items()}


def _op_cases():
    return {f"{mode}_{agg}": _op_case(mode, 30 + i)
            for i, (mode, agg) in enumerate(OP_CASES)}


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
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

def _port_engine(ref, flat_vars, mesh=None, **extra):
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    from dstdgcn_tpu_torch.utils.bridge import load_flax_variables
    name = "dstdgcn_fast" if REFS[ref].get("fast") else "dstdgcn"
    model = get_model(name, **{name: _model_kwargs(ref)},
                      use_pallas=REFS[ref].get("use_pallas", False), **extra)
    eng = PredictionEngine(_engine_cfg(ref), model, device="cpu", mesh=mesh)
    eng.init(seed=0)
    load_flax_variables(model, _nest(flat_vars))
    return eng


def _test_sweep(eng, v, share=(0, 1)):
    i, n = share
    loader = [tuple(a[i::n] for a in b) for b in _eval_batches(v)]
    _, per_frame = eng.test(loader, input_n=4, eval_frame=EVAL_FRAMES,
                            dim_used=np.arange(3 * v))
    return per_frame


def _scenario(name, inputs):
    """One scenario on this rank: the step's losses, the state after it,
    the Adam moments and, for an eval scenario, the test sweep."""
    from dstdgcn_tpu_torch.parallel import make_mesh
    _, shape, ref, extra, evaluate = SCENARIOS[name]
    mesh = make_mesh(**shape)
    flat_vars = {k.split("/", 2)[2]: v for k, v in inputs.items()
                 if k.startswith(f"var/{ref}/")}
    eng = _port_engine(ref, flat_vars, mesh, **extra)
    i, n = mesh.index("data"), mesh.shape["data"]
    v = REFS[ref]["v"]
    losses = eng.train_step(*[a[i::n] for a in _batch(v)])
    res = {f"{name}/loss/{k}": t.numpy() for k, t in losses.items()}
    res.update({f"{name}/state/{k}": t.numpy().copy()
                for k, t in eng.model.state_dict().items()})
    for pname, p in eng.model.named_parameters():
        state = eng.optimizer.state[p]
        res[f"{name}/mu/{pname}"] = state["exp_avg"].numpy().copy()
        res[f"{name}/nu/{pname}"] = state["exp_avg_sq"].numpy().copy()
    if evaluate:
        res[f"{name}/mpjpe"] = _test_sweep(eng, v, (i, n))
        eng.fused_inference = True      # whole on each rank
        res[f"{name}/mpjpe_fused"] = _test_sweep(eng, v, (i, n))
    return res


def _gather(t, dim, group):
    import torch.distributed as dist
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, t.detach().numpy(), group=group)
    return np.concatenate(parts, dim)


def _shard_results(mesh):
    """Each edge-partitioned op on this rank's joint range of OP_V joints
    with a cotangent: the gathered output and x gradient, and every other
    leaf's gradient summed over the ranks."""
    import torch.distributed as dist
    from dstdgcn_tpu_torch.parallel import shard
    group = mesh.group("graph")
    rows = mesh.joints(OP_V)
    res = {}
    for key, case in _op_cases().items():
        mode, agg = key.split("_")
        fn = (shard.dstd_spatial_edge_partitioned if mode == "spatial"
              else shard.dstd_temporal_edge_partitioned)
        case = {k: torch.from_numpy(v) for k, v in case.items()}
        x = case["x"][:, :, rows].clone().requires_grad_()
        leaves = {k: case[k].clone().requires_grad_()
                  for k in ("base", "alpha") + WEIGHTS}
        y = fn(mesh, x, leaves["base"], leaves["alpha"],
               *[leaves[k] for k in WEIGHTS], agg=agg)
        (y * case["g"][:, :, rows]).sum().backward()
        res[f"op/{key}/out"] = _gather(y, 2, group)
        res[f"op/{key}/dx"] = _gather(x.grad, 2, group)
        for k, t in leaves.items():
            total = t.grad.clone()
            dist.all_reduce(total, group=group)
            res[f"op/{key}/d{k}"] = total.numpy()
    return res


def _rank_main(tmp):
    from dstdgcn_tpu_torch.parallel import distributed, make_mesh
    torch.set_num_threads(1)
    rank, world = distributed.initialize(None, device="cpu")
    inputs = dict(np.load(tmp / "inputs.npz"))
    res = _shard_results(make_mesh(graph=world))
    meshes = {}
    for name, (ranks, *_) in SCENARIOS.items():
        if ranks == world:
            res.update(_scenario(name, inputs))
            meshes[name] = SCENARIOS[name][1]
    np.savez(tmp / f"rank{rank}.npz", **res)
    (tmp / f"rank{rank}.json").write_text(json.dumps(meshes))


# -- the launcher -----------------------------------------------------------

def _start(world, tmp):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DSTDGCN_COORDINATOR=f"file://{tmp}/rendezvous",
               DSTDGCN_NUM_PROCESSES=str(world))
    return [subprocess.Popen(
        [sys.executable, __file__, str(tmp)],
        env=dict(env, DSTDGCN_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs, tmp, deadline):
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


def _jax_engine(ref):
    from dstdgcn_tpu.engine import PredictionEngine as JEngine
    from dstdgcn_tpu.models import DSTDGCN as JDSTDGCN
    r = REFS[ref]
    model = JDSTDGCN(**_model_kwargs(ref), fast=r.get("fast", False),
                     use_pallas=r.get("use_pallas", False))
    eng = JEngine(_engine_cfg(ref), model)
    eng.init(_batch(r["v"])[0][:1], seed=0)
    return eng


def _jax_variables(eng):
    import jax
    return _flatten({"params": jax.tree.map(np.asarray, eng.state.params),
                     "batch_stats": jax.tree.map(np.asarray,
                                                 eng.state.batch_stats)})


def _jax_step(eng, ref):
    """The JAX engine's single-device step on the global batch: losses and
    Adam moments (flat, by name)."""
    import jax
    import jax.numpy as jnp
    step = eng._build_train_step(None, None, None)
    state, losses = step(eng.state, *[jnp.asarray(a) for a in
                                      _batch(REFS[ref]["v"])],
                         jnp.asarray(1e-3))
    moments = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state.opt_state)[0]:
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        for which in ("mu", "nu"):
            if which in keys:
                rest = keys[keys.index(which) + 1:]
                moments[f"{which}/" + ".".join(map(str, rest))] = \
                    np.asarray(leaf)
    return {k: float(v) for k, v in losses.items()}, moments


def _jax_op(key, case):
    import jax.numpy as jnp
    from dstdgcn_tpu.ops import dstd as jops
    mode, agg = key.split("_")
    fn = jops.dstd_spatial if mode == "spatial" else jops.dstd_temporal
    return np.asarray(fn(*[jnp.asarray(case[k]) for k in
                           ("x", "base", "alpha") + WEIGHTS], agg=agg))


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches, run while this process takes the JAX engine's steps
    and ops: {"ranks": {2: [rank results], 4: [...]}, "jax": {reference:
    (losses, moments)}, "vars": {reference: flat variables}, "ops": {case:
    JAX output}}."""
    engines = {ref: _jax_engine(ref) for ref in REFS}
    variables = {ref: _jax_variables(eng) for ref, eng in engines.items()}
    inputs = {f"var/{ref}/{k}": v for ref, flat in variables.items()
              for k, v in flat.items()}
    tmp = {w: tmp_path_factory.mktemp(f"axes{w}") for w in (2, 4)}
    for path in tmp.values():
        np.savez(path / "inputs.npz", **inputs)
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    procs = {w: _start(w, path) for w, path in tmp.items()}
    try:
        # the steps' compiles release the GIL: one thread a reference
        with ThreadPoolExecutor(len(REFS)) as pool:
            jobs = {ref: pool.submit(_jax_step, eng, ref)
                    for ref, eng in engines.items()}
            ops = {key: _jax_op(key, case)
                   for key, case in _op_cases().items()}
            steps = {ref: job.result() for ref, job in jobs.items()}
    finally:
        ranks = {w: _finish(p, tmp[w], deadline) for w, p in procs.items()}
    return dict(ranks=ranks, jax=steps, vars=variables, ops=ops)


# -- the tests --------------------------------------------------------------

def _ranks(launches, name):
    return launches["ranks"][SCENARIOS[name][0]]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_step_matches_the_jax_single_device_step(launches, name):
    ranks = _ranks(launches, name)
    jlosses, jmoments = launches["jax"][SCENARIOS[name][2]]
    r0 = ranks[0]
    assert "joint" in jlosses
    for loss, want in jlosses.items():
        np.testing.assert_allclose(float(r0[f"{name}/loss/{loss}"]), want,
                                   rtol=1e-4, err_msg=loss)
    got = {k[len(name) + 1:] for k in r0
           if k.startswith((f"{name}/mu/", f"{name}/nu/"))}
    assert got == set(jmoments)
    for key, a in jmoments.items():
        b = r0[f"{name}/{key}"]
        if a.dtype.kind == "f" and a.size > 1:
            assert np.max(np.abs(a - b)) < max(2e-3 * np.abs(a).max(),
                                               1e-8), key


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_holds_the_same_state_after_the_step(launches, name):
    ranks = _ranks(launches, name)
    keys = [k for k in ranks[0] if k.startswith(f"{name}/state/")]
    assert keys
    for other in ranks[1:]:
        for key in keys:
            np.testing.assert_array_equal(ranks[0][key], other[key],
                                          err_msg=key)
        for loss in (k for k in ranks[0] if k.startswith(f"{name}/loss/")):
            assert ranks[0][loss] == other[loss], loss


@pytest.mark.parametrize("name", [n for n, s in SCENARIOS.items() if s[4]])
def test_eval_sweep_matches_one_process(launches, name):
    """``engine.test`` under the mesh after the step, standard and fused,
    against one process with the same state on the whole batches."""
    ranks = _ranks(launches, name)
    ref = SCENARIOS[name][2]
    eng = _port_engine(ref, launches["vars"][ref])
    eng.model.load_state_dict({
        k.split("/", 2)[2]: torch.from_numpy(v) for k, v in ranks[0].items()
        if k.startswith(f"{name}/state/")})
    want = _test_sweep(eng, REFS[ref]["v"])
    assert want.shape == (len(EVAL_FRAMES),) and np.all(np.isfinite(want))
    for rank in ranks:
        np.testing.assert_allclose(rank[f"{name}/mpjpe"], want, rtol=1e-4)
        np.testing.assert_allclose(rank[f"{name}/mpjpe_fused"], want,
                                   rtol=1e-4)


def _plain_grads(key, case):
    from dstdgcn_tpu_torch.ops import dstd
    mode, agg = key.split("_")
    fn = dstd.dstd_spatial if mode == "spatial" else dstd.dstd_temporal
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in case.items() if k != "g"}
    y = fn(leaves["x"], leaves["base"], leaves["alpha"],
           *[leaves[k] for k in WEIGHTS], agg=agg)
    (y * torch.from_numpy(case["g"])).sum().backward()
    return {f"d{k}": t.grad.numpy() for k, t in leaves.items()}


@pytest.mark.parametrize("key", [f"{m}_{a}" for m, a in OP_CASES])
@pytest.mark.parametrize("world", [2, 4])
def test_shard_op_matches_jax_and_plain_gradients(launches, key, world):
    res = launches["ranks"][world][0]
    np.testing.assert_allclose(res[f"op/{key}/out"], launches["ops"][key],
                               rtol=1e-5, atol=1e-5)
    for name, g in _plain_grads(key, _op_cases()[key]).items():
        got = res[f"op/{key}/{name}"]
        scale = max(float(np.abs(g).max()), 1.0)
        assert float(np.abs(got - g).max()) <= 1e-5 * scale, (key, world,
                                                              name)


def test_uneven_split_is_gspmds():
    from dstdgcn_tpu_torch.parallel import Mesh
    from dstdgcn_tpu_torch.parallel.mesh import split
    assert split(25, 2) == [(0, 13), (13, 25)]
    assert split(23, 2) == [(0, 12), (12, 23)]
    assert split(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert split(22, 4) == [(0, 6), (6, 12), (12, 18), (18, 22)]
    mesh = Mesh({"data": 1, "graph": 2, "model": 2}, {},
                {"data": 0, "graph": 1, "model": 1})
    assert mesh.joints(25) == slice(13, 25)
    assert mesh.channels(64) == slice(32, 64)
    # a width the model axis does not divide is replicated
    assert mesh.channels(3) == slice(0, 3)
    assert [mesh.coords_of(r) for r in range(4)] == [
        dict(data=0, graph=g, model=m) for g in (0, 1) for m in (0, 1)]


@pytest.mark.parametrize("graph,model", [(2, 1), (1, 2), (2, 2)])
def test_dropout_blocks_tile_one_mask(graph, model):
    """Under a graph or model axis each rank keeps its block of the mask
    one process draws for the whole activation (V = 25, an uneven split),
    so the ranks of one data index never reuse one local mask."""
    from dstdgcn_tpu_torch.models.layers import Dropout
    from dstdgcn_tpu_torch.parallel import Mesh, activation_sharding_context
    n, t, v, c = 3, 4, 25, 8
    whole = Dropout(0.4, torch.Generator().manual_seed(11), (v, c)).train()(
        torch.ones(n, t, v, c))
    seen = torch.zeros(n, t, v, c)
    for gi in range(graph):
        for mi in range(model):
            shape = {"data": 1, "graph": graph}
            if model > 1:
                shape["model"] = model
            mesh = Mesh(shape, {}, {"data": 0, "graph": gi, "model": mi})
            rows, cols = mesh.joints(v), mesh.channels(c)
            x = torch.ones(n, t, rows.stop - rows.start,
                           cols.stop - cols.start)
            drop = Dropout(0.4, torch.Generator().manual_seed(11), (v, c))
            with activation_sharding_context(mesh):
                got = drop.train()(x)
            assert torch.equal(got, whole[:, :, rows, cols])
            seen[:, :, rows, cols] += 1
    assert torch.equal(seen, torch.ones_like(seen))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(pathlib.Path(sys.argv[1]))
