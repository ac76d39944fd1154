"""Graph WaveNet (``models/gwnet.py``) against the plain reference
(``references/gwnet.py``) on the CPU at a small size (V 40, batch 2, widths
8 / 8 / 16 / 32, 8 layers, 16 x 16 blocks, so the node count is padded to
48), and the pieces it runs on: the road graph and its node order, the
transposed-pattern backward of ``block_spmm``, the masked MAE, the engine's
float32 and dropout rules, the traffic series and the runner.

Tolerances: outputs and the loss within 1e-5 of max(|reference|, 1), each
gradient within 1e-4 of the reference's norm.  Both paths compute in
float32 and differ only in the order of their sums (the SpMM over the
reordered, padded nodes against the dense einsum in the caller's order,
the node-major products against the einsum's), a few units of float32
rounding through 8 layers; a fault that drops one block or one hop is
larger by orders (``test_a_dropped_block_is_seen``).
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dstdgcn_tpu_torch.data import traffic  # noqa: E402
from dstdgcn_tpu_torch.engine import PredictionEngine  # noqa: E402
from dstdgcn_tpu_torch.engine.losses import masked_mae_error  # noqa: E402
from dstdgcn_tpu_torch.graphs import road  # noqa: E402
from dstdgcn_tpu_torch.kernels import sparse  # noqa: E402
from dstdgcn_tpu_torch.models import GWNet, get_model  # noqa: E402
from references import gwnet as ref  # noqa: E402

V, N, SEED = 40, 2, 1234
HP = dict(joints_to_consider=V, input_time_frame=12, output_time_frame=12,
          in_dim=3, residual_channels=8, dilation_channels=8,
          skip_channels=16, end_channels=32, kernel_size=2, blocks=4,
          layers=2, dropout=0.3, embedding=10, order=2, block=16)
GRAPH = dict(freeways=4, extent_km=10.0, reach_km=3.0)
ENGINE = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=1e-4, gamma=1.0,
                         step_size=1),
              loss=dict(mae=["mmae", 1]), n_out=1, transform="no",
              inverse=False, clip=5, precision="float32", max_iter=-1)


def _adjacency():
    return road.road_graph(V, 5, **GRAPH)


def _model(**kw):
    return get_model("gwnet", gwnet=dict(HP, adjacency=_adjacency(), **kw))


def _batch(seed=0):
    """(x normalised, y raw, scaler) of N windows of a seeded series."""
    series = traffic.traffic_series(V, 80, seed)
    splits, scaler = traffic.split_windows(series, 12, 12)
    x, y = splits["train"]
    return torch.from_numpy(x[:N]), torch.from_numpy(y[:N]), scaler


def _supports():
    return [torch.from_numpy(s) for s in ref.transitions(_adjacency())]


def _engine(model):
    eng = PredictionEngine(copy.deepcopy(ENGINE), model, None, device="cpu")
    eng.init(SEED)
    return eng


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1.0)
    return float((got - want).abs().max()) <= tol * scale


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


# -- the model against the reference ------------------------------------------


def test_parameters_are_the_references_draw():
    eng = _engine(_model())
    want = ref.init_params(HP, SEED)
    got = dict(eng.model.named_parameters())
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k


def test_forward_loss_and_gradients_match_the_reference():
    eng = _engine(_model())
    x, y, scaler = _batch()
    losses = eng.compute_gradients(x, x[:, :0], y, None, scaler)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in ref.init_params(HP, SEED).items()}
    gen = torch.Generator().manual_seed(SEED + 1)
    pred = ref.forward(p, HP, _supports(), x, gen)
    loss = ref.masked_mae(pred * scaler.std + scaler.mean, y)
    # the last layer's graph convolution and BatchNorm reach no output
    # (model.py sums the skips alone after the last layer): zero gradients
    grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(
        p.items(), torch.autograd.grad(loss, list(p.values()),
                                       allow_unused=True))}
    assert _close(losses["total"], loss.detach(), 1e-5)
    for k, param in eng.model.named_parameters():
        if grads[k].norm() == 0:
            assert param.grad.norm() == 0, k
        else:
            assert _rel(param.grad, grads[k]) <= 1e-4, k
    # the outputs of the same forward, the dropout masks drawn again
    eng.generator.manual_seed(SEED + 1)
    eng.model.train()
    with torch.no_grad():
        out = eng.model(x)
        want = ref.forward({k: v.detach() for k, v in p.items()}, HP,
                           _supports(), x,
                           torch.Generator().manual_seed(SEED + 1))
    assert out.shape == (N, 12, V)
    assert _close(out, want, 1e-5)


def test_one_adam_step_matches_the_reference():
    eng = _engine(_model())
    x, y, scaler = _batch(1)
    p0 = {k: v.detach().clone() for k, v in eng.model.named_parameters()}
    eng.train_step(x, x[:, :0], y, None, scaler)
    got = dict(eng.model.named_parameters())
    want = ref.train_steps(ref.init_params(HP, SEED), HP, _supports(),
                           [(x, y)], (scaler.mean, scaler.std), "cpu",
                           gen=torch.Generator().manual_seed(SEED + 1))
    for k in p0:
        step, ref_step = got[k].detach() - p0[k], want["p_end"][k] - p0[k]
        # Adam's first step is lr * g / (|g| + eps) elementwise: an element
        # whose gradient is near round-off moves by a different fraction of
        # lr in either path, so the update is held to 1e-3 of its norm
        assert _rel(step, ref_step) <= 1e-3, k


def test_a_dropped_block_is_seen():
    """One active block of the forward road support left out moves the
    output by far more than the tolerance."""
    model = _model()
    eng = _engine(model)
    x = _batch()[0]
    eng.model.eval()
    with torch.no_grad():
        whole = eng.model(x)
        rows, cols = model.support_blocks[0]
        # a block of a row that keeps another (each row needs one)
        drop = int(np.flatnonzero(np.bincount(rows)[rows] > 1)[0])
        keep = np.arange(len(rows)) != drop
        model.support_blocks[0] = (rows[keep], cols[keep])
        broken = eng.model(x)
    assert not _close(broken, whole, 1e-3)


# -- node order ---------------------------------------------------------------


def test_node_order_round_trips_to_the_callers():
    model = _model()
    order, inverse = model.order, model.inverse
    assert sorted(order.tolist()) == list(range(V))
    assert torch.equal(order[inverse], torch.arange(V))
    x = torch.randn(3, 12, V, 3)
    assert torch.equal(x.index_select(2, order).index_select(2, inverse), x)


def test_outputs_follow_the_callers_node_order():
    """Relabelling the sensors relabels the prediction: the same graph and
    weights with the nodes permuted give the permuted output."""
    adj = _adjacency()
    perm = np.random.default_rng(3).permutation(V)
    a = get_model("gwnet", gwnet=dict(HP, adjacency=adj, dropout=0.0))
    b = get_model("gwnet", gwnet=dict(HP, adjacency=adj[perm][:, perm],
                                      dropout=0.0))
    with torch.no_grad():
        for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
            pb.copy_(pa[perm] if k == "nodevec1" else
                     pa[:, perm] if k == "nodevec2" else pa)
    x = torch.randn(N, 12, V, 3)
    a.train(), b.train()
    with torch.no_grad():
        assert _close(b(x[:, :, perm]), a(x)[:, :, perm], 1e-5)


def test_rcm_gathers_the_edges_into_few_blocks():
    adj = road.road_graph(400, 9, freeways=8, extent_km=20.0, reach_km=3.0)
    p_f = road.transitions(adj)[0]
    order = road.rcm_order(adj)
    shuffled = len(road.block_list(p_f.T, 16)[0])
    ordered = len(road.block_list(p_f[order][:, order].T, 16)[0])
    assert ordered < shuffled / 2


# -- the graph ----------------------------------------------------------------


def test_road_graph_is_seeded_and_thresholded():
    a, b = road.road_graph(V, 5, **GRAPH), road.road_graph(V, 5, **GRAPH)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, road.road_graph(V, 6, **GRAPH))
    assert np.all(np.diag(a) == 1.0)
    off = a[a > 0]
    assert off.min() >= road.KAPPA and off.max() <= 1.0
    assert not np.array_equal(a != 0, (a != 0).T) or np.allclose(a, a.T)


def test_transitions_are_row_stochastic():
    p_f, p_b = road.transitions(_adjacency())
    assert np.allclose(p_f.sum(1), 1, atol=1e-6)
    assert np.allclose(p_b.sum(1), 1, atol=1e-6)
    want_f, want_b = ref.transitions(_adjacency())
    assert np.allclose(p_f, want_f, atol=1e-7)
    assert np.allclose(p_b, want_b, atol=1e-7)


@pytest.mark.parametrize("block", [8, 16, 128])
def test_block_list_covers_every_nonzero(block):
    m = road.transitions(_adjacency())[0]
    rows, cols = road.block_list(m, block)
    vp = road.padded(V, block)
    pat = sparse.pattern(rows, cols, block, vp, vp)
    mask = pat.mask(torch.device("cpu")).numpy()[:V, :V]
    assert np.all(mask[m != 0] == 1)


# -- the sparse backward ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_block_spmm_transposed_dx_equals_the_masked_dense_backward(seed):
    rng = np.random.default_rng(seed)
    v, block, c = 48, 8, 5
    rows, cols = sparse.active_blocks(rng.random((6, 6)) < 0.3)
    adj = torch.from_numpy(rng.standard_normal((2, v, v)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, v, c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, v, c)).astype(np.float32))
    pat = sparse.pattern(rows, cols, block, v, v)
    x1 = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(sparse.block_spmm(adj, x1, rows, cols, block),
                                x1, g)
    want = torch.bmm((adj * pat.mask(adj.device)).transpose(1, 2), g)
    assert torch.allclose(dx, want, atol=1e-5, rtol=1e-5)
    t = pat.transposed()
    assert t is pat.transposed() and t.v == v
    assert set(zip(t.rows.tolist(), t.cols.tolist())) >= set(
        zip(cols.tolist(), rows.tolist()))
    # with the adjacency's gradient wanted, both stay the dense products
    adj1 = adj.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    d_adj, dx2 = torch.autograd.grad(
        sparse.block_spmm(adj1, x2, rows, cols, block), (adj1, x2), g)
    assert torch.allclose(dx2, want, atol=1e-5, rtol=1e-5)
    m = pat.mask(adj.device)
    assert torch.allclose(d_adj, torch.bmm(g, x.transpose(1, 2)) * m,
                          atol=1e-5, rtol=1e-5)


def test_block_spmm_dx_reads_the_callers_transposed_adjacency():
    """Given ``adj_t``, the backward reads it and builds none: a model's
    transposed support, built once, is the one ``d_x`` uses."""
    rows, cols = sparse.active_blocks(np.eye(4, dtype=bool))
    pat = sparse.pattern(rows, cols, 4, 16, 16)
    adj = torch.randn(1, 16, 16)
    adj_t = (adj * pat.mask(adj.device)).transpose(1, 2).contiguous()
    g = torch.randn(1, 16, 3)
    dx = []
    for given in (None, adj_t, 2 * adj_t):
        x = torch.randn(1, 16, 3, requires_grad=True)
        out = sparse.block_spmm(adj, x, rows, cols, 4, adj_t=given)
        dx.append(torch.autograd.grad(out, x, g)[0])
    assert torch.allclose(dx[1], dx[0], atol=1e-6)
    assert torch.allclose(dx[2], 2 * dx[0], atol=1e-5)


# -- the loss and the engine --------------------------------------------------


def test_masked_mae_ignores_zero_targets():
    target = torch.tensor([[0.0, 2.0, 0.0, 4.0]])
    pred = torch.tensor([[9.0, 1.0, -7.0, 5.0]])
    assert float(masked_mae_error(pred, target)) == pytest.approx(1.0)
    assert float(ref.masked_mae(pred, target)) == pytest.approx(1.0)
    assert float(masked_mae_error(pred, torch.zeros(1, 4))) == 0.0


def test_float32_precision_turns_tf32_off():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        _engine(_model())
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_every_dropout_draws_from_the_engines_generator():
    eng = _engine(_model())
    assert eng.model.dropout.generator is eng.generator
    assert isinstance(get_model("gwnet", gwnet=dict(
        HP, adjacency=_adjacency())), GWNet)


def test_traffic_series_is_seeded_and_windows_are_scaled():
    a, b = traffic.traffic_series(V, 60, 2), traffic.traffic_series(V, 60, 2)
    assert np.array_equal(a, b) and a.shape == (60, V, 3)
    assert not np.array_equal(a, traffic.traffic_series(V, 60, 3))
    missing = float((a[..., 0] == 0).mean())
    assert 0.02 < missing < 0.1
    splits, scaler = traffic.split_windows(a, 12, 12)
    x, y = splits["train"]
    assert x.shape[1:] == (12, V, 3) and y.shape[1:] == (12, V)
    assert np.allclose(scaler.inverse(x[0, :, :, 0]), a[:12, :, 0],
                       atol=1e-3)
    assert np.array_equal(y[0], a[12:24, :, 0])


def test_synthetic_gwnet_config_trains_through_main(tmp_path):
    import yaml

    from dstdgcn_tpu_torch import main
    path = REPO / "dstdgcn_tpu_torch/configs/synthetic_gwnet_gla_train.yaml"
    cfg = yaml.safe_load(path.read_text())
    assert cfg["model"]["gwnet"]["joints_to_consider"] == 3834
    assert cfg["engine"]["precision"] == "float32"
    cfg["model"]["gwnet"].update(
        joints_to_consider=V, residual_channels=8, dilation_channels=8,
        skip_channels=16, end_channels=32, block=16,
        graph=dict(GRAPH, seed=21))
    cfg["train_batch_size"] = cfg["test_batch_size"] = 8
    cfg["dataset"]["traffic"]["days"] = 0.25
    runner, history = main.run(cfg, "cpu", run_dir=str(tmp_path))
    assert len(history) == cfg["epoch"]
    rows = (tmp_path / "training_loss.csv").read_text().splitlines()
    assert rows[0].startswith("epoch,lr,train_loss,test_loss")
    assert len(rows) == 1 + cfg["epoch"] + 1
    assert (tmp_path / "checkpoints" / "best.ckpt").is_file()
    assert all(np.isfinite(h).all() for h in history)
    # the test mode from the best checkpoint: the test windows' row
    cfg["mode"] = "test"
    cfg["model"].update(load=True, ckpt=str(tmp_path / "checkpoints" /
                                            "best.ckpt"))
    _, row = main.run(cfg, "cpu", run_dir=str(tmp_path / "test"))
    rows = (tmp_path / "test" / "testing_loss.csv").read_text().splitlines()
    assert rows[0] == "test_loss,mae3,mae6,mae12" and len(rows) == 2
    assert np.isfinite(row).all()


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_transposed_dx_at_the_gla_pattern():
    """Kernel 7's d_x on the transposed pattern of the GLA-sized graph's
    forward support (V 3,834 padded to 3,840, block 128) against the
    float64 plain run: within twice the plain float32 run's distance, or
    1e-6 of the largest element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    v, block, feats = 3834, 128, 2048
    adj = road.road_graph(v, 2 ** 31 + 5)
    order = road.rcm_order(adj)
    vp = road.padded(v, block)
    m = np.zeros((vp, vp), np.float32)
    m[:v, :v] = road.transitions(adj)[0][order][:, order].T
    rows, cols = road.block_list(m, block)
    a = torch.from_numpy(m)[None].to(dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, vp, feats, generator=gen).to(dev).requires_grad_(True)
    g = torch.randn(1, vp, feats, generator=gen).to(dev)
    sparse.reset_launch_counts()
    (dx,) = torch.autograd.grad(sparse.block_spmm(a, x, rows, cols, block),
                                x, g)
    assert sparse.launch_counts()["block_spmm"] == 2
    want64 = torch.bmm(a.double().transpose(1, 2), g.double())
    plain = torch.bmm(a.transpose(1, 2), g)
    err = float((dx.double() - want64).abs().max())
    floor = float((plain.double() - want64).abs().max())
    assert err <= max(2 * floor, 1e-6 * float(want64.abs().max())), (
        err, floor)
