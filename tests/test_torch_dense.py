"""Graph WaveNet's dense adaptive hop (``kernels/dense.py::dense_hop``,
``csrc/dense_hop.cu``).

On the CPU the wrapper runs the plain ``torch.mm`` products, so its forward
and both gradients equal autograd through ``torch.mm(adp.t(), x)`` bit for
bit; it raises on inputs the kernels do not take and on copies of another
adjacency, the model builds those copies once a step, and it calls the
wrapper for every adaptive hop (16 forward, 14 ``d_x`` and 14 ``d_adp``
products a training step at 8 layers of two hops).

On the card (marker ``cuda``): each product against the float64 product at
V 3,834 (the forecast configuration's) and a small ragged V 200, at F 2,048
and 24,576 (its shortest and longest layer at batch 64), within twice the
plain float32 ``torch.mm``'s distance from float64 or 1e-6 of the largest
element: 3xTF32 carries float32's accuracy, and two right float32 sums of
thousands of terms differ by their rounding alone (``torch.mm`` with TF32
off sums on the CUDA cores, in another order), while one TF32 pass errs
far beyond either; then a GWNet training step through the kernels against
the same step on the plain products.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dstdgcn_tpu_torch.graphs import road  # noqa: E402
from dstdgcn_tpu_torch.kernels import build, dense  # noqa: E402
from dstdgcn_tpu_torch.models import GWNet  # noqa: E402

#: a tiny Graph WaveNet at the published depth (8 layers of two hops)
TINY = dict(joints_to_consider=40, input_time_frame=12, output_time_frame=12,
            in_dim=3, residual_channels=8, dilation_channels=8,
            skip_channels=16, end_channels=32, blocks=4, layers=2,
            dropout=0.0, order=2, block=16)
GRAPH = dict(freeways=4, extent_km=10.0, reach_km=3.0)


def _inputs(v, f, seed, device="cpu"):
    """The model's adaptive support softmax(relu(E1 E2)) of seeded
    embeddings, and x and g standard normal."""
    gen = torch.Generator().manual_seed(seed)
    e1, e2 = torch.randn(v, 10, generator=gen), torch.randn(10, v,
                                                             generator=gen)
    adp = torch.softmax(torch.relu(e1 @ e2), 1)
    x, g = (torch.randn(v, f, generator=gen) for _ in range(2))
    return adp.to(device), x.to(device), g.to(device)


def _hop_grads(fn, adp, x, g, wants=(True, True)):
    """(out, d_adp, d_x) of ``fn(adp, x)`` with the cotangent g; a gradient
    that is not asked for is None."""
    a = adp.detach().clone().requires_grad_(wants[0])
    xr = x.detach().clone().requires_grad_(wants[1])
    out = fn(a, xr)
    asked = [t for t in (a, xr) if t.requires_grad]
    grads = iter(torch.autograd.grad(out, asked, g))
    return (out.detach(),) + tuple(next(grads) if t.requires_grad else None
                                   for t in (a, xr))


# -- the plain products on the CPU --------------------------------------------


@pytest.mark.parametrize("wants", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("v,f", [(37, 24), (200, 640), (256, 2048)])
def test_cpu_path_equals_autograd_through_mm(v, f, wants):
    adp, x, g = _inputs(v, f, seed=v + f)
    got = _hop_grads(dense.dense_hop, adp, x, g, wants)
    want = _hop_grads(lambda a, b: torch.mm(a.t(), b), adp, x, g, wants)
    for name, a, b in zip(("out", "d_adp", "d_x"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


def test_cpu_path_without_gradients_is_the_plain_product():
    adp, x, _ = _inputs(50, 16, seed=3)
    with torch.no_grad():
        assert torch.equal(dense.dense_hop(adp, x), dense.hop_dense(adp, x))


@pytest.mark.parametrize("case", ["float64", "bf16", "adp_transposed",
                                  "x_transposed", "rows", "not_square",
                                  "not_2d"])
def test_the_wrapper_raises_on_what_the_kernels_do_not_take(case):
    adp, x, _ = _inputs(12, 8, seed=1)
    bad = dict(float64=(adp.double(), x.double()),
               bf16=(adp, x.bfloat16()),
               adp_transposed=(adp.t(), x),
               x_transposed=(adp, x.t().contiguous().t()),
               rows=(adp, x[:10].contiguous()),
               not_square=(adp[:, :10].contiguous(), x),
               not_2d=(adp, x[None]))[case]
    with pytest.raises((TypeError, ValueError)):
        dense.dense_hop(*bad)


def test_operands_of_another_adjacency_are_refused():
    """The kernels' copies go with one adjacency: a call whose ``ops`` hold
    another one raises, and so does a backward after an in-place change."""
    adp, x, g = _inputs(20, 8, seed=2)
    ops = dense.Operands(adp)
    assert torch.equal(dense.dense_hop(adp, x, ops), dense.hop_dense(adp, x))
    with pytest.raises(ValueError):
        dense.dense_hop(adp.clone(), x, ops)
    with pytest.raises(ValueError):
        dense.dense_hop(adp[:10, :10].contiguous(), x[:10], ops)

    leaf = adp.clone().requires_grad_(True)
    src = leaf * 1.0
    out = dense.dense_hop(src, x, dense.Operands(src))
    with torch.no_grad():
        src.mul_(2.0)
    with pytest.raises(RuntimeError):
        out.backward(g)


@pytest.mark.parametrize("recording", [False, True])
def test_the_operands_are_built_once_a_step(monkeypatch, recording):
    """A training step of the tiny model builds one :class:`Operands` of
    its adaptive support, and every forward hop and ``d_x`` reads it, also
    while a profiler records (the ``gwnet.diffusion`` spans then hand each
    layer a view of the support)."""
    built, seen = [], []

    class Counted(dense.Operands):
        def __init__(self, adp):
            super().__init__(adp)
            built.append(self)

    monkeypatch.setattr(dense, "Operands", Counted)
    op = dense.dense_hop
    for name in ("forward", "d_x"):
        real = getattr(op, name)

        def read(ops, t, _real=real):
            seen.append(ops)
            return _real(ops, t)
        monkeypatch.setattr(op, name, read)
    model = GWNet(**TINY, adjacency=road.road_graph(40, 5, **GRAPH))
    model.train()
    x = torch.randn(2, 12, 40, 3, generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) if recording \
            else contextlib.nullcontext():
        model(x).abs().mean().backward()
    assert len(built) == 1
    assert len(seen) == 16 + 14
    assert all(ops is built[0] for ops in seen)


def test_the_model_runs_every_adaptive_hop_through_the_wrapper(monkeypatch):
    """A training step of the tiny model calls each product of the wrapper
    as often as a step of the forecast configuration launches them: 8
    layers of two hops forward, and the backward of every layer but the
    last (whose graph convolution reaches no output)."""
    calls = dict(forward=0, d_x=0, d_adp=0)
    op = dense.dense_hop
    for name in calls:
        real = getattr(op, name)

        def counted(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(op, name, counted)
    model = GWNet(**TINY, adjacency=road.road_graph(40, 5, **GRAPH))
    model.train()
    x = torch.randn(2, 12, 40, 3, generator=torch.Generator().manual_seed(0))
    model(x).abs().mean().backward()
    assert calls == dict(forward=16, d_x=14, d_adp=14)
    assert model.nodevec1.grad is not None
    assert float(model.nodevec1.grad.abs().max()) > 0


# -- on the card ----------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2048, 24576])
@pytest.mark.parametrize("v", [3834, 200])
def test_kernel_products_against_float64(v, f):
    dev = _needs_card()
    adp, x, g = _inputs(v, f, seed=v + f, device=dev)
    before = dense.dense_hop.launches
    got = _hop_grads(dense.dense_hop, adp, x, g)
    torch.cuda.synchronize()
    assert dense.dense_hop.launches - before == 3
    a64, x64, g64 = adp.double(), x.double(), g.double()
    want = (a64.t() @ x64, x64 @ g64.t(), a64 @ g64)
    plain = (adp.t() @ x, x @ g.t(), adp @ g)
    for name, k, p, w in zip(("out", "d_adp", "d_x"), got, plain, want):
        err = float((k.double() - w).abs().max())
        floor = float((p.double() - w).abs().max())
        assert err <= max(2 * floor, 1e-6 * float(w.abs().max())), (
            name, err, floor)


@pytest.mark.cuda
def test_kernel_errors_raise_and_never_fall_back(monkeypatch):
    dev = _needs_card()
    adp, x, _ = _inputs(64, 16, seed=4, device=dev)
    with pytest.raises(ValueError):
        dense.dense_hop(adp, x[:, :14].contiguous())

    class Refusing:
        def dense_hop_f32(self, *args):
            return 1

        def dstd_error_string(self, err):
            return b"refused"

    monkeypatch.setattr(build, "library", lambda name: Refusing())
    with pytest.raises(RuntimeError):
        dense.dense_hop(adp, x)


@pytest.mark.cuda
def test_gwnet_training_step_through_the_kernels(monkeypatch):
    """A training step of Graph WaveNet at the forecast configuration's
    graph and widths (batch 2, dropout 0) through the kernels against the
    same step on the plain float32 products: the loss within 1e-5 of
    max(|plain|, 1) and each gradient within 1e-4 of the plain gradient's
    norm (``tests/test_torch_gwnet.py``'s tolerances of the model against
    its reference: the two paths differ in the order of their sums), with
    exactly 16 forward and 28 backward launches.  A plain gradient under
    1e-3 of the median leaf's norm is rounding noise (the graph
    convolutions' biases, which a training-mode BatchNorm follows, have
    none in exact arithmetic; the benchmark's ``grad_gap`` leaves such
    leaves out): the kernel's gradient there is held under that floor."""
    dev = _needs_card()
    adj = road.road_graph(3834, 21)
    model = GWNet(joints_to_consider=3834, dropout=0.0,
                  adjacency=adj).to(dev)
    plain_model = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 12, 3834, 3, generator=gen).to(dev)
    y = torch.randn(2, 12, 3834, generator=gen).to(dev)

    def step(m):
        m.train()
        loss = (m(x) - y).abs().mean()
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in m.named_parameters()
                               if p.grad is not None}

    dense.reset_launch_counts()
    loss, grads = step(model)
    torch.cuda.synchronize()
    assert dense.launch_counts() == {"dense_hop": 44}
    with monkeypatch.context() as mp:
        mp.setattr(dense, "dense_hop",
                   lambda a, b, ops: dense.hop_dense(a, b))
        plain_loss, plain_grads = step(plain_model)
    assert dense.launch_counts() == {"dense_hop": 44}
    assert abs(float(loss - plain_loss)) <= 1e-5 * max(
        abs(float(plain_loss)), 1.0)
    assert grads.keys() == plain_grads.keys()
    floor = 1e-3 * float(np.median([float(w.norm())
                                    for w in plain_grads.values()]))
    compared = 0
    for k, want in plain_grads.items():
        scale = float(want.norm())
        if scale < floor:
            assert float(grads[k].norm()) < floor, k
            continue
        assert float((grads[k] - want).norm()) <= 1e-4 * scale, k
        compared += 1
    assert compared > len(plain_grads) // 2
    assert np.isfinite(float(loss))


@pytest.mark.cuda
def test_a_profiled_step_copies_the_adjacency_once_each_way(monkeypatch):
    """A training step at the forecast configuration's graph and widths
    while a profiler records (as in the benchmark's traced steps): one
    :class:`Operands` a step, holding one padded copy of each orientation
    of the adjacency, and the 44 product launches."""
    dev = _needs_card()
    built = []

    class Counted(dense.Operands):
        def __init__(self, adp):
            super().__init__(adp)
            built.append(self)

    monkeypatch.setattr(dense, "Operands", Counted)
    model = GWNet(joints_to_consider=3834, dropout=0.0,
                  adjacency=road.road_graph(3834, 21)).to(dev)
    model.train()
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 12, 3834, 3, generator=gen).to(dev)
    dense.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model(x).abs().mean().backward()
        torch.cuda.synchronize()
    assert dense.launch_counts() == {"dense_hop": 44}
    assert len(built) == 1
    assert sorted(built[0]._padded) == [False, True]
