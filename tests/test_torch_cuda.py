"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  On a machine with the card:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.  Tolerance
1e-4: the kernels sum in another order than the plain ops; TF32 is off for
the plain side.  Backward kernels and model gradients are held per tensor
at 1e-4 max(max |plain|, 1), since a weight gradient sums every row of the
batch.  The bf16 variants are held against the plain versions of their
contract (``ops/dstd.py::kernel_spatial``, ``ops/dstd_bwd.py`` with the
dtype) at BF16_TOL, each check below half of its own bf16-versus-float32
gap: two right implementations that sum in another order can round an
intermediate to neighbouring bf16 values.  The tile cases (``TILE_CASES``,
at bf16 and at float32) hold an output past its bound if it lies near the
float64 run of the contract (``F64_NOISE``; at the profiles' shapes one
row of a bf16 output may flip, ``_flip_rows``), and so are x's gradient in
the bf16 autograd test and the bf16 chain cases (``chip_smoke.py::
chain_held``, which phase 3 of ``chip_smoke.py`` holds its chain checks
by).  The float32 chain gradient is held the same way against a wider
population of right float32 orders (``chip_smoke.py::rounded_chain``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dstdgcn_tpu_torch.kernels import fused
from dstdgcn_tpu_torch.ops import dstd as plain
from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

WEIGHTS = ("wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm")
GRADIENTS = ("dx", "dbase", "dalpha", "dwf", "dbf", "dwm1", "dbm1", "dwm2",
             "dbm2", "dwrm", "dbrm")
#: bf16 kernel against its plain version: forward over the peak |output|,
#: backward per gradient over max(max |plain|, 1)
BF16_TOL = dict(forward=1e-3, backward=1.5e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(mode, n, t, v, cin, co, device, seed=0):
    rng = np.random.RandomState(seed)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    mk = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    arrs = [rng.randn(n, t, v, cin).astype(np.float32), mk(k, pair, pair),
            np.asarray([0.7], np.float32), mk(k, cin, co), mk(k, co),
            mk(k, cin, 2), mk(k, 2), mk(k, cin, 2), mk(k, 2),
            mk(k, 2, ref, ref), mk(k, ref)]
    return [torch.from_numpy(a).to(device) for a in arrs]


@pytest.mark.parametrize("cin,co", [(6, 64), (64, 64), (64, 3), (3, 3),
                                    (5, 7)])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_kernel_matches_plain(cuda, mode, agg, cin, co):
    args = _inputs(mode, 4, 35, 22, cin, co, cuda)
    before = fused.launch_counts()[f"dstd_{mode}"]
    got = getattr(fused, f"dstd_{mode}")(*args, None, agg)
    torch.cuda.synchronize()
    assert fused.launch_counts()[f"dstd_{mode}"] == before + 1
    want = getattr(plain, f"dstd_{mode}")(*args, None, agg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tile", [1, 3, 8])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_kernel_tiles_and_ragged_shapes(cuda, mode, tile):
    # T=9: at tile 1 the 9 spatial blocks of a sample exceed one cluster,
    # so the wrapper raises the tile to 2
    args = _inputs(mode, 3, 9, 7, 5, 4, cuda, seed=1)
    got = getattr(fused, f"dstd_{mode}")(*args, None, "right", tile=tile)
    want = getattr(plain, f"dstd_{mode}")(*args, None, "right")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _inputs("spatial", 2, 8, 6, 4, 4, cuda)
    # bf16 runs its kernel (the bf16 tests below); float16 has none
    out = fused.dstd_spatial(*args, None, "right", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        fused.dstd_spatial(*args, None, "right", torch.float16)
    with pytest.raises(NotImplementedError):
        fused.dstd_spatial_bwd(args[0], out.float(), *args[1:],
                               dtype=torch.float16)
    bad = list(args)                      # bf16 is for x and g only
    bad[3] = bad[3].to(torch.bfloat16)
    with pytest.raises(TypeError):
        fused.dstd_spatial(*bad, None, "right", torch.bfloat16)
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(TypeError):
        fused.dstd_spatial(*bad)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2)
    with pytest.raises(ValueError):
        fused.dstd_spatial(*bad)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        fused.dstd_spatial(*bad)


def _assert_grads_close(got, want, tol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = float((a - b).abs().max())
        assert err <= tol * max(float(b.abs().max()), 1.0), err


@pytest.mark.parametrize("cin,co", [(6, 64), (64, 64), (64, 3), (3, 3),
                                    (5, 7)])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_backward_kernel_matches_plain(cuda, mode, agg, cin, co):
    args = _inputs(mode, 4, 35, 22, cin, co, cuda)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        4, 35, 22, co).astype(np.float32)).to(cuda)
    kernel = getattr(fused, f"dstd_{mode}_bwd")
    before = kernel.launches
    got = kernel(args[0], g, *args[1:], agg=agg)
    again = kernel(args[0], g, *args[1:], agg=agg)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 * fused.BWD_LAUNCHES
    # partial sums reduced in a fixed order: the same bits every call
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = getattr(plain_bwd, f"dstd_{mode}_bwd")(args[0], g, *args[1:],
                                                  agg=agg)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("tile", [1, 3, 8])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_backward_kernel_tiles_and_ragged_shapes(cuda, mode, tile):
    args = _inputs(mode, 3, 9, 7, 5, 4, cuda, seed=1)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        3, 9, 7, 4).astype(np.float32)).to(cuda)
    got = getattr(fused, f"dstd_{mode}_bwd")(args[0], g, *args[1:],
                                             tile=tile)
    want = getattr(plain_bwd, f"dstd_{mode}_bwd")(args[0], g, *args[1:])
    _assert_grads_close(got, want)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_autograd_through_the_kernels(cuda, mode):
    """The autograd Function: forward and backward kernels against
    autograd of the plain op, non-contiguous cotangent included."""
    args = [a.requires_grad_() for a in _inputs(mode, 4, 35, 22, 8, 8,
                                                cuda, seed=3)]
    fused.reset_launch_counts()
    out = getattr(fused, f"dstd_{mode}")(*args, None, "right")
    g = torch.randn_like(out).transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, args, g)
    want = torch.autograd.grad(
        getattr(plain, f"dstd_{mode}")(*args, None, "right"), args, g)
    counts = fused.launch_counts()
    assert counts[f"dstd_{mode}"] == 1
    assert counts[f"dstd_{mode}_bwd"] == fused.BWD_LAUNCHES
    _assert_grads_close(got, want)


def test_model_train_step_kernel_path_matches_plain_path(cuda):
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import DSTDGCN
    small = dict(input_channels=6, input_time_frame=10, output_time_frame=25,
                 st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=16,
                 num_layers=2, layout="h36m")
    cfg = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               inverse=True, max_iter=-1)
    engines = [PredictionEngine(cfg, DSTDGCN(**small, use_pallas=flag),
                                device="cuda") for flag in (True, False)]
    for eng in engines:
        eng.init()
    rng = np.random.RandomState(4)
    batch = [rng.randn(8, 35, 66).astype(np.float32) * 100 for _ in range(3)]
    fused.reset_launch_counts()
    losses = [float(eng.compute_gradients(*batch)["total"])
              for eng in engines]
    counts = fused.launch_counts()
    assert counts["dstd_spatial"] == counts["dstd_temporal"] == 8
    assert counts["dstd_spatial_bwd"] == 8 * fused.BWD_LAUNCHES
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    _assert_grads_close([p.grad for p in engines[0].model.parameters()],
                        [p.grad for p in engines[1].model.parameters()])


def _bf16_held(name, got, want, want32, norm):
    """max |got - want| / norm within BF16_TOL[name], below half of the
    bf16-versus-float32 gap max |want - want32| / norm."""
    err = float((got - want).abs().max()) / norm
    gap = float((want - want32).abs().max()) / norm
    assert err <= BF16_TOL[name] < gap / 2, (err, gap)


@pytest.mark.parametrize("cin,co", [(6, 64), (64, 64), (64, 3)])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_bf16_kernel_matches_plain(cuda, mode, agg, cin, co):
    args = _inputs(mode, 4, 35, 22, cin, co, cuda)
    op = getattr(fused, f"dstd_{mode}")
    fused.reset_launch_counts()
    got = op.launch(*args, agg=agg, dtype=torch.bfloat16)
    out = op(args[0].to(torch.bfloat16), *args[1:], None, agg,
             torch.bfloat16)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    assert counts[f"dstd_{mode}_bf16"] == 2 and counts[f"dstd_{mode}"] == 0
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.to(torch.bfloat16))   # x rounds exactly
    want = getattr(plain, f"kernel_{mode}")(*args, agg, torch.bfloat16)
    want32 = getattr(plain, f"dstd_{mode}")(*args, None, agg)
    _bf16_held("forward", got, want, want32, float(want32.abs().max()))


#: (N, T, V, tile, Ci, Co) of the bf16 backward cases (tile None: the
#: wrapper's): a small batch at H36M's shape; the training cells' batch
#: 128 at H36M's (35, 22) and CMU's (35, 25), and 3DPW's (40, 23), at the
#: model's channel pairs (6->64, 64->64, 64->3 spatial; 3->3 temporal);
#: and a pair axis of 25 at tile 4 in both ops (past one 16-row tile and
#: not a multiple of 8, with a last tile of one output index)
BF16_BWD_CASES = (
    [(4, 35, 22, None, cin, co) for cin, co in ((6, 64), (64, 64), (64, 3))]
    + [(n, t, v, tile, cin, co)
       for n, t, v, tile in ((128, 35, 22, None), (128, 35, 25, None),
                             (128, 40, 23, None), (3, 25, 25, 4))
       for cin, co in ((6, 64), (64, 64), (64, 3), (3, 3))])


@pytest.mark.parametrize("n,t,v,tile,cin,co", BF16_BWD_CASES)
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_bf16_backward_kernel_matches_plain(cuda, mode, agg, n, t, v, tile,
                                            cin, co):
    """The bf16 backward against the plain contract: bf16 x and g give the
    same bits, BF16_TOL lies below half the bf16-versus-float32 gap, and at
    H36M's small batch every gradient lies within BF16_TOL.  The other
    shapes are held as the tile cases are (``_bf16_tile_held``: BF16_TOL,
    or F4's rule, at a profile shape the flip-row rule): there one rounding
    flip of a bf16 intermediate moves a dx element up to 2.6e-3 of
    max(|dx|, 1) from the plain contract, in the loaders' pass 2 and in
    the ldmatrix one alike (PERF.md)."""
    args = _inputs(mode, n, t, v, cin, co, cuda)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        n, t, v, co).astype(np.float32)).to(cuda)
    kernel = getattr(fused, f"dstd_{mode}_bwd")
    fused.reset_launch_counts()
    got = kernel(args[0], g, *args[1:], agg=agg, dtype=torch.bfloat16,
                 tile=tile)
    again = kernel(args[0].to(torch.bfloat16), g.to(torch.bfloat16),
                   *args[1:], agg=agg, dtype=torch.bfloat16, tile=tile)
    torch.cuda.synchronize()
    assert fused.launch_counts()[f"dstd_{mode}_bwd_bf16"] == \
        2 * fused.BWD_LAUNCHES
    assert fused.launch_counts()[f"dstd_{mode}_bwd"] == 0
    # x and g round exactly; the reduction's order is fixed
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = getattr(plain_bwd, f"dstd_{mode}_bwd")
    want = ref(args[0], g, *args[1:], agg=agg, dtype=torch.bfloat16)
    want32 = ref(args[0], g, *args[1:], agg=agg)
    norms = [max(float(b.abs().max()), 1.0) for b in want]
    errs = [float((a - b).abs().max()) / nrm
            for a, b, nrm in zip(got, want, norms)]
    gap = max(float((b - c).abs().max()) / nrm
              for b, c, nrm in zip(want, want32, norms))
    assert BF16_TOL["backward"] < gap / 2, gap
    if (n, t, v) == (4, 35, 22):
        assert max(errs) <= BF16_TOL["backward"], errs
    else:
        ok, repeat, held, ratios = _bf16_tile_held(
            (mode, tile, n, t, v, cin, co, agg), cuda, passes=("backward",))
        assert repeat and all(ok.values()), (held, ratios)


#: (mode, tile, N, T, V, Ci, Co, agg): ragged shapes at every tile, then
#: the edges of the tensor-core tiles of the backward kernels (16 x 8 x 16
#: bf16, 16 x 8 x 8 3xTF32).  Spatial: V of 7, 22, 23 and 25 joints (the
#: pair axis, rows and depth of the dA and dxf products; 22 H36M, 23 3DPW,
#: 25 CMU) by T of 20, 35 and 40 frames (the mixing axis and the feature
#: rows: the fast model's 10 + 10, H36M's and CMU's 35, 3DPW's 40).
#: Temporal: T of 9, 35 and 40 frames (the pair axis: rows and depth of dA
#: and dxf, and the T*T depth of dwrm, split over warps) by V of 7, 22, 23
#: and 25 joints (the mixing axis: dwrm's columns, a ragged last tile of
#: output joints).  Both: one and three samples, channel pairs below,
#: across and at the 16-wide depth, tiles 1, 5 and 8 (the feature rows,
#: tile x the pair axis), both aggregations.  Run at bf16 and at float32.
TILE_CASES = (
    [(mode, tile, 3, 9, 7, 5, 4, "right") for mode in ("spatial", "temporal")
     for tile in (1, 3, 8)]
    + [("spatial", tile, n, t, v, cin, co, agg) for t in (20, 35, 40)
       for v in (7, 22, 23, 25)
       for n in (1, 3) for cin, co in ((3, 3), (6, 64), (64, 3))
       for tile in (1, 5, 8) for agg in ("right", "left")]
    + [("temporal", tile, n, t, v, cin, co, agg) for t in (9, 35, 40)
       for v in (7, 22, 23, 25) for n in (1, 3)
       for cin, co in ((3, 3), (6, 64), (64, 3)) for tile in (1, 5, 8)
       for agg in ("right", "left")])
#: a bf16 tile case's output that lies farther than BF16_TOL from the
#: plain contract is still held if its distance to the float64 run of the
#: same contract (the same rounding points) is within BF16_TOL or within
#: F64_NOISE times the plain contract's own distance to that run, the
#: larger of its two runs in two summation orders (on the card and on the
#: CPU).  At some 64->3 temporal edges a rounding flip moves a bf16
#: intermediate and the output by up to 1.74e-3, past BF16_TOL (ROADMAP.md,
#: F4): in one summation order and not in another, so the kernel, the plain
#: contract on the card and the same on the CPU are runs of the same
#: rounding noise, and the float64 run is the function they all round.
#: The float32 cases are held the same way at 1e-4: dalpha sums products
#: that cancel, and float32 summation order alone moves it by up to
#: 7.0e-5 of max(|g|, 1) from float64 at these shapes (the plain version on
#: the card), so two right float32 orders can lie 1.1e-4 apart.  F64_NOISE
#: is the factor ``chip_smoke.py`` phases 7 and 9 use for the train steps.
#: Measured on the H100 over the tile cases (``bwd_profile.py --cases``,
#: PERF.md): where a right kernel lies past the bound, its distance to the
#: float64 run is at most 1.00 (bf16) and 0.57 (float32) times the plain
#: contract's, but for the one flip of F9 (``_bf16_tile_held``).  Over the
#: 870 bf16 cases a 5b or 6b whose dx misses joint 0 lies 111 times or
#: more past the card test's rule, one whose dx is 1% off 2.30 times or
#: more (2.85 at the shapes before the profiles'), 0.5% off 1.15 times or
#: more; a dx rounded to bf16 once more (at most 0.39% of an element)
#: passes on 57 cases, all within F4's rule (the flip-row rule holds no
#: faulty case that F4's rule refuses).
F64_NOISE = 2.0


def _tile_case(mode, tile, n, t, v, cin, co, agg, device, dtype, bwd=None,
               fwd=None, passes=("forward", "backward"), rows=False):
    """One tile case (seeded inputs, seed 1; cotangent seed 2) through the
    kernels at ``dtype`` (None: float32) in ``passes``: {output: (distance
    to the plain contract, the kernel's distance to the contract's float64
    run, the plain contract's own distance to it on ``device`` and on the
    CPU)} for the forward (over the peak |output|) and each of the
    backward's 11 gradients (over max(max |.|, 1)), and whether two calls
    of each pass gave the same bits.  ``bwd`` replaces the backward kernel
    and ``fwd`` the forward launch (a broken one, say).  With ``rows`` (a
    bf16 case) it returns as well {output: worst row ratio} of the
    flip-row rule (``_flip_rows``) for the forward and dx, the outputs
    laid out in (sample, frame, joint) rows of channels, over the plain
    contract's runs on the card, on the CPU and on x moved by one float32
    rounding (``chip_smoke.ROUNDING_RUNS`` runs, x + x d, d uniform in
    +-2^-24 from ``chip_smoke.rounding_deltas``, seeded: F7's
    population)."""
    args = _inputs(mode, n, t, v, cin, co, device, seed=1)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        n, t, v, co).astype(np.float32)).to(device)
    wide = [a.double() for a in args]
    on_cpu = [a.cpu() for a in [g] + args]

    def dist(a, b, norm):
        return float((a.double() - b.double().to(a.device)).abs().max()) \
            / norm

    def held(got, want, want_cpu, want64, norm, norm64):
        return (dist(got, want, norm), dist(got, want64, norm64),
                dist(want, want64, norm64), dist(want_cpu, want64, norm64))

    # x moved by one float32 rounding, once a run of the population
    moved = [args[0] + args[0] * d for (d,) in cs.rounding_deltas(
        torch, args[0].shape, 1, seed=1, device=device)] if rows else []

    out, ratios, same = {}, {}, True
    if "forward" in passes:
        fwd = fwd or getattr(fused, f"dstd_{mode}").launch
        got = fwd(*args, agg=agg, dtype=dtype, tile=tile)
        same = torch.equal(got, fwd(*args, agg=agg, dtype=dtype, tile=tile))
        ref = getattr(plain, f"kernel_{mode}")
        want, want64 = ref(*args, agg, dtype), ref(*wide, agg, dtype)
        want_cpu, norm64 = ref(*on_cpu[1:], agg, dtype), float(
            want64.abs().max())
        out["forward"] = held(got, want, want_cpu, want64,
                              float(want.abs().max()), norm64)
        if rows:
            ratios["forward"] = _flip_rows(
                got, want, float(want.abs().max()), want64, norm64,
                want_cpu, [ref(x, *args[1:], agg, dtype) for x in moved],
                BF16_TOL["forward"])
    if "backward" not in passes:
        return (out, same, ratios) if rows else (out, same)
    bwd = bwd or getattr(fused, f"dstd_{mode}_bwd")
    grads = bwd(args[0], g, *args[1:], agg=agg, dtype=dtype, tile=tile)
    again = bwd(args[0], g, *args[1:], agg=agg, dtype=dtype, tile=tile)
    ref = getattr(plain_bwd, f"dstd_{mode}_bwd")
    want = ref(args[0], g, *args[1:], agg=agg, dtype=dtype)
    want_cpu = ref(on_cpu[1], on_cpu[0], *on_cpu[2:], agg=agg, dtype=dtype)
    want64 = ref(wide[0], g.double(), *wide[1:], agg=agg, dtype=dtype)
    for name, a, b, b_cpu, c in zip(GRADIENTS, grads, want, want_cpu,
                                    want64):
        out[name] = held(a, b, b_cpu, c, max(float(b.abs().max()), 1.0),
                         max(float(c.abs().max()), 1.0))
    if rows:
        ratios["dx"] = _flip_rows(
            grads[0], want[0], max(float(want[0].abs().max()), 1.0),
            want64[0], max(float(want64[0].abs().max()), 1.0), want_cpu[0],
            [ref(x, g, *args[1:], agg=agg, dtype=dtype)[0] for x in moved],
            BF16_TOL["backward"])
    same = same and all(torch.equal(a, b) for a, b in zip(grads, again))
    return (out, same, ratios) if rows else (out, same)


def _f4_ratio(dtype, name, err, kernel64, *plain64):
    """A tile case's output by F4's rule, as the smaller of two ratios (held
    at 1 or below): its distance to the plain contract over its bound
    (float32 1e-4, bf16 BF16_TOL), and its distance to the contract's
    float64 run over max(bound, F64_NOISE x the plain contract's own
    distance to that run in its two summation orders, ``plain64``)."""
    tol = 1e-4 if dtype is None else BF16_TOL[
        "forward" if name == "forward" else "backward"]
    return min(err / tol, kernel64 / max(tol, F64_NOISE * max(plain64)))


def _held(dtype, name, *dists):
    """Whether a tile case holds one output by F4's rule."""
    return _f4_ratio(dtype, name, *dists) <= 1


def _flip_rows(got, want, norm, want64, norm64, want_cpu, runs, tol):
    """The flip-row rule's ratio (held at 1 or below).  Over the (sample,
    frame, joint) rows, each row by F4's rule (``_f4_ratio``: ``got``
    against the plain contract ``want`` over ``norm``, or against its
    float64 run ``want64`` over ``norm64`` beside the plain contract's own
    row on the card and on the CPU, ``want_cpu``), except the worst row,
    which may lie as far from ``want64`` as max(``tol``, F64_NOISE x the
    farthest that any run of the plain contract lies anywhere: the two
    summation orders and ``runs``, those on x moved by one float32
    rounding).  One rounding flip, of the size right runs show; every
    other row as F4 holds the whole output."""
    def rows(a, b, scale):
        return (a.double().to(b.device) - b.double()).abs().amax(-1) / scale

    k64 = rows(got, want64, norm64)
    orders = torch.maximum(rows(want, want64, norm64),
                           rows(want_cpu, want64, norm64))
    per_row = torch.minimum(rows(got, want, norm) / tol,
                            k64 / (F64_NOISE * orders).clamp(min=tol))
    flip = max(float(orders.max()), *(float(rows(r, want64, norm64).max())
                                      for r in runs))
    worst = int(per_row.argmax())
    rest = per_row.flatten().clone()
    rest[worst] = 0.0
    return max(float(rest.max()), min(float(per_row.flatten()[worst]), float(
        k64.flatten()[worst]) / max(tol, F64_NOISE * flip)))


def _profile_shape(mode, t, v):
    """Whether a tile case lies at a shape of the CMU, 3DPW and fast
    profiles that the earlier cases lacked: 3DPW's 23 joints, or the
    spatial op at the fast model's 20 frames or 3DPW's 40."""
    return v == 23 or (mode == "spatial" and t in (20, 40))


def _bf16_tile_held(case, device, bwd=None, fwd=None,
                    passes=("forward", "backward")):
    """A bf16 tile case: ({output: held}, whether two calls gave the same
    bits, the distances, {output: flip-row ratio}).  Each output is held by
    F4's rule (``_held``).  At a profile shape (``_profile_shape``) the
    forward or dx past it is held, failing that, by the
    flip-row rule (F9, ``_flip_rows``): a rounding flip of a bf16
    intermediate in one (sample, frame, joint) row moves that row's dx
    over all channels by a bf16 step, and at T = 40 the plain contract's
    two summation orders do not span such flips (the kernel lay 1.79e-3
    from float64 on one case, all in one row, the plain contract on the
    card 6.8e-4, on x moved by one float32 rounding up to 1.87e-3 in other
    rows), so one row may flip as far as such runs do and every other row
    is held by F4's rule.  The cases at the earlier shapes keep F4's rule
    alone."""
    held, repeat = _tile_case(*case, device, torch.bfloat16, bwd, fwd, passes)
    ok = {name: _held(torch.bfloat16, name, *d) for name, d in held.items()}
    ratios = {}
    if not all(ok.values()) and _profile_shape(case[0], *case[3:5]):
        _, _, ratios = _tile_case(*case, device, torch.bfloat16, bwd, fwd,
                                  passes, rows=True)
        for name, ratio in ratios.items():
            ok[name] = ok[name] or ratio <= 1
    return ok, repeat, held, ratios


@pytest.mark.parametrize("mode,tile,n,t,v,cin,co,agg", TILE_CASES)
def test_bf16_kernels_tiles_and_ragged_shapes(cuda, mode, tile, n, t, v, cin,
                                              co, agg):
    ok, repeat, held, ratios = _bf16_tile_held(
        (mode, tile, n, t, v, cin, co, agg), cuda)
    assert repeat
    assert all(ok.values()), (held, ratios)


@pytest.mark.parametrize("mode,tile,n,t,v,cin,co,agg", TILE_CASES)
def test_float32_backward_kernels_tiles_and_ragged_shapes(
        cuda, mode, tile, n, t, v, cin, co, agg):
    held, repeat = _tile_case(mode, tile, n, t, v, cin, co, agg, cuda, None,
                              passes=("backward",))
    assert repeat
    assert all(_held(None, name, *d) for name, d in held.items()), held


#: the float32 temporal forward kernel at its default tile, 4 joints a
#: block: a cluster of 6 at V = 22 (two joints in rank 5) and of 7 at the
#: CMU's 25 (one joint in rank 6)
TEMPORAL_TILE4_CASES = [
    ("temporal", 4, n, t, v, cin, co, agg) for t in (9, 35, 40)
    for v in (22, 25) for n in (1, 3)
    for cin, co in ((3, 3), (6, 64), (64, 3)) for agg in ("right", "left")]


@pytest.mark.parametrize("mode,tile,n,t,v,cin,co,agg",
                         TILE_CASES + TEMPORAL_TILE4_CASES)
def test_float32_forward_kernels_tiles_and_ragged_shapes(
        cuda, mode, tile, n, t, v, cin, co, agg):
    """The float32 forward kernels at the tile cases: both ops' projection,
    mixing and aggregation run on float64 tensor-core products (16 x 8 x 8
    tiles, each as four 8 x 8 x 4: V of 7, 22 and 25 joints are ragged
    rows and depths of the spatial aggregation and of the temporal
    mixing's depth R V, T of 9, 35 and 40 frames of the spatial mixing's
    depth R T and of the temporal aggregation), a sample's blocks as one
    cluster (the wrapper raises a tile whose blocks would not fit in
    one)."""
    held, repeat = _tile_case(mode, tile, n, t, v, cin, co, agg, cuda, None,
                              passes=("forward",))
    assert repeat
    assert all(_held(None, name, *d) for name, d in held.items()), held


#: the cotangent of test_bf16_autograd_through_the_kernels: drawn from a
#: generator seeded with it (torch seeds its global generator anew in
#: every process, so a global draw tested another cotangent in every run;
#: ROADMAP.md, F6)
AUTOGRAD_SEED = 11


def _bf16_autograd_case(mode, seed, device, bwd=None):
    """The autograd Function at bf16 on one cotangent draw (a generator
    on ``device`` seeded with ``seed``): a bf16 x at (4, 35, 22, 8), the
    bf16 kernels both ways, the gradients in the primals' dtypes (x bf16,
    weights float32).  Returns the launch counts; whether the gradients
    come in those dtypes; x's gradient as ``_held`` reads it (its distance
    to the plain backward's with the dtype, over max(|plain|, 1); the
    kernel path's and the plain contract's on ``device`` and on the CPU
    distances to the contract's float64 run, over max(|float64|, 1): the
    bf16 gradient autograd returns in each, the float64 one as it is); and
    each weight gradient's distance to the plain one over max(|plain|, 1).
    ``bwd`` replaces the backward kernel (a broken one, say)."""
    args = _inputs(mode, 4, 35, 22, 8, 8, device, seed=3)
    x = args[0].to(torch.bfloat16).requires_grad_()
    weights = [a.requires_grad_() for a in args[1:]]
    op = getattr(fused, f"dstd_{mode}")
    kept = op.bwd
    op.bwd = bwd or kept
    try:
        fused.reset_launch_counts()
        out = op(x, *weights, None, "right", torch.bfloat16)
        g = torch.randn(out.shape, device=device, generator=torch.Generator(
            device).manual_seed(seed)).to(out.dtype)
        got = torch.autograd.grad(out, [x] + weights, g)
        counts = fused.launch_counts()
    finally:
        op.bwd = kept
    typed = got[0].dtype == torch.bfloat16 and all(
        a.dtype == torch.float32 for a in got[1:])
    ref = getattr(plain_bwd, f"dstd_{mode}_bwd")
    plain_args = [w.detach() for w in weights]
    want = ref(x.detach(), g, *plain_args, dtype=torch.bfloat16)
    want_cpu = ref(x.detach().cpu(), g.cpu(), *[w.cpu() for w in plain_args],
                   dtype=torch.bfloat16)
    want64 = ref(x.detach().double(), g.double(),
                 *[w.double() for w in plain_args], dtype=torch.bfloat16)

    def dist(a, b, norm):
        return float((a.double() - b.double().to(a.device)).abs().max()) \
            / norm

    dx = want[0].to(torch.bfloat16)
    norm = max(float(dx.float().abs().max()), 1.0)
    norm64 = max(float(want64[0].abs().max()), 1.0)
    held = (dist(got[0], dx, norm), dist(got[0], want64[0], norm64),
            dist(dx, want64[0], norm64),
            dist(want_cpu[0].to(torch.bfloat16), want64[0], norm64))
    rest = [dist(a, b, max(float(b.abs().max()), 1.0))
            for a, b in zip(got[1:], want[1:])]
    return counts, typed, held, rest


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_bf16_autograd_through_the_kernels(cuda, mode):
    """A bf16 activation in, the bf16 kernels both ways, the gradients in
    the primals' dtypes (x bf16, weights float32), against the plain
    backward with the same dtype on the same seeded cotangent: x's
    gradient, rounded to bf16, held as the tile cases hold theirs (one
    bf16 step at |dx| in [32, 64) is 0.25, past BF16_TOL of its peak), the
    weight gradients within BF16_TOL."""
    counts, typed, dx, rest = _bf16_autograd_case(mode, AUTOGRAD_SEED, cuda)
    assert counts[f"dstd_{mode}_bf16"] == 1
    assert counts[f"dstd_{mode}_bwd_bf16"] == fused.BWD_LAUNCHES
    assert counts[f"dstd_{mode}"] == counts[f"dstd_{mode}_bwd"] == 0
    assert typed
    assert _held(torch.bfloat16, "backward", *dx), dx
    assert max(rest) <= BF16_TOL["backward"], rest


def test_bf16_model_train_step_kernel_path_matches_plain_path(cuda):
    """A small bf16 model, one train step on both paths (kernel path: the
    bf16 kernels; plain path: the same Function's plain versions on the
    CPU), loss and every gradient."""
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import DSTDGCN
    small = dict(input_channels=6, input_time_frame=10, output_time_frame=25,
                 st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=16,
                 num_layers=2, layout="h36m", use_pallas=True,
                 compute_dtype="auto", auto_batch_hint=64)
    cfg = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               inverse=True, max_iter=-1)
    engines = [PredictionEngine(cfg, DSTDGCN(**small), device=dev)
               for dev in ("cuda", "cpu")]
    for eng in engines:
        eng.init()
    rng = np.random.RandomState(4)
    batch = [rng.randn(8, 35, 66).astype(np.float32) * 100 for _ in range(3)]
    fused.reset_launch_counts()
    losses = [float(eng.compute_gradients(*batch)["total"])
              for eng in engines]
    counts = fused.launch_counts()
    assert engines[0].model.active_dtype == "bfloat16"
    assert counts["dstd_spatial_bf16"] == counts["dstd_temporal_bf16"] == 8
    assert counts["dstd_spatial_bwd_bf16"] == 8 * fused.BWD_LAUNCHES
    assert counts["dstd_spatial"] == counts["dstd_spatial_bwd"] == 0
    assert losses[0] == pytest.approx(losses[1], rel=1e-3)
    _assert_grads_close([p.grad.cpu() for p in engines[0].model.parameters()],
                        [p.grad for p in engines[1].model.parameters()],
                        2e-2)


def _chain_layers(count, t, v, c, device, encoder, seed=0):
    """Seeded chain blocks ((spatial, temporal) pairs) or encoder layers
    (with affines and PReLU slopes), scaled by fan-in so that activations
    stay O(1) over the chain instead of growing 10x per block."""
    rng = np.random.RandomState(seed)

    def nrm(std, *shape):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).to(device)

    layers = []
    for _ in range(count):
        parts = []
        for k, ref, pair in ((2, t, v), (1, v, t)):
            parts.append((nrm(1.0 / pair, k, pair, pair),
                          torch.tensor([0.5], device=device),
                          nrm(c ** -0.5, k, c, c), nrm(0.1, k, c),
                          nrm(c ** -0.5, k, c, 2), nrm(0.1, k, 2),
                          nrm(c ** -0.5, k, c, 2), nrm(0.1, k, 2),
                          nrm((2 * ref * pair) ** -0.5, k, 2, ref, ref),
                          nrm(0.1, k, ref)))
        if encoder:
            for _ in range(2):
                parts.append(torch.stack([1 + nrm(0.1, v, c),
                                          nrm(0.2, v, c)]))
            parts.append(torch.tensor([0.25, 0.1], device=device))
        layers.append(tuple(parts))
    return layers


def _assert_chain_close(got, want, tol=1e-4):
    """The JAX chain tests' norm: max |got - want| <= tol max(|want|, 1)."""
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1.0), err


# (N, T, C): full width, batch 1, a ragged batch, short sequences with the
# 22 joints (T < V: the temporal op sets the cluster), and C % 4 != 0
CHAIN_SHAPES = [(32, 35, 64), (1, 35, 64), (3, 35, 64), (3, 8, 64),
                (2, 10, 6)]


def _encoder_case(agg, n, t, v, c, device, count=5):
    """The float32 encoder kernel (``count`` seeded layers; x seeded by n)
    at (N, T, V, C): two launches, the same bits, within 1e-4 of
    max(|plain|, 1) of ``_encoder_oracle``."""
    layers = _chain_layers(count, t, v, c, device, encoder=True)
    x = torch.randn(n, t, v, c, device=device,
                    generator=torch.Generator(device).manual_seed(n))
    kernel = fused.dstd_encoder_chain
    before = kernel.launches
    with torch.no_grad():
        got = kernel(x, layers, agg)
        again = kernel(x, fused.pack_chain(layers), agg)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    _assert_chain_close(got, fused._encoder_oracle(x, layers, agg))


@pytest.mark.parametrize("n,t,c", CHAIN_SHAPES)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_encoder_chain_kernel_matches_plain(cuda, n, t, c, agg):
    _encoder_case(agg, n, t, 22, c, cuda)


@pytest.mark.parametrize("n,t,c", CHAIN_SHAPES)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_chain_kernel_matches_plain(cuda, n, t, c, agg):
    blocks = _chain_layers(5, t, 22, c, cuda, encoder=False, seed=1)
    x = torch.randn(n, t, 22, c, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(n))
    before = fused.dstd_chain.launches
    with torch.no_grad():
        got = fused.dstd_chain(x, blocks, agg)
    torch.cuda.synchronize()
    assert fused.dstd_chain.launches == before + 1
    _assert_chain_close(got, fused._chain_oracle(x, blocks, agg))


#: (tile, T, V) of the float32 chain kernel's tiles at C = 64: the
#: wrapper's tile is the smallest whose cluster of ceil(max(T, V) / tile)
#: blocks fits in 8, so the tile follows from the shape (tile 1: a cluster
#: of 8 one-index blocks; tile 5: the H36M shape, 7 blocks; tile 8: 197,936
#: bytes of shared memory a block, one block an SM)
CHAIN_TILES = [(1, 8, 7), (5, 35, 22), (8, 64, 22)]


@pytest.mark.parametrize("n", [1, 32])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("tile,t,v", CHAIN_TILES)
def test_float32_chain_kernel_at_its_tiles(cuda, tile, t, v, agg, n):
    """dstd_chain at float32 (the tensor-core body at 3xTF32) at the tile
    the wrapper picks: two five-layer launches and five one-layer launches
    give the same bits, within 1e-4 of max(|plain|, 1)."""
    from dstdgcn_tpu_torch.kernels import build
    blocks = _chain_layers(5, t, v, 64, cuda, encoder=False, seed=1)
    x = torch.randn(n, t, v, 64, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(n + tile))
    kernel = fused.dstd_chain
    assert kernel._tile(build.library("dstd_chain"), "f32", t, v, 64, 2, 1,
                        2) == tile
    before = kernel.launches
    with torch.no_grad():
        got = kernel(x, fused.pack_chain(blocks), agg)
        again = kernel(x, fused.pack_chain(blocks), agg)
        h = x
        for i in range(len(blocks)):
            h = kernel(h, fused.pack_chain(blocks[i:i + 1]), agg)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 + len(blocks)
    assert torch.equal(got, again) and torch.equal(got, h)
    _assert_chain_close(got, fused._chain_oracle(x, blocks, agg))


#: the draws of x and the cotangent (a generator seeded with each) of
#: test_chain_gradient_replays_the_op_kernels: the five of 100 seeded draws
#: on which the float32 chain gradient of an earlier version of the kernels
#: lay farther from float64 than the plain chain allows (agg left; draw
#: 1048: the plain float32 chain itself lies 1.25e-4 of max(|g|, 1) from
#: its float64 run; ROADMAP.md, F5).  The global generator, which torch
#: seeds anew in every process, gave every run another draw.
CHAIN_GRAD_SEEDS = (1044, 1048, 1049, 1053, 1079)


def _chain_grad_case(agg, seed, device, cpu=True, refs=None):
    """The float32 chain gradient at one draw (x and the cotangent from a
    generator seeded with ``seed``; 3 seeded blocks at (3, 35, 22, 64)):
    for each of its 61 gradients (x, then every weight) the kernel path's
    distance to autograd through the plain chain (over max(|plain|, 1)),
    its and the plain chain's distance to the plain chain's float64 run
    (over max(|.|, 1)), with ``cpu`` the plain chain's on the CPU (else
    the card's again), and the distances of ``chip_smoke.ROUNDING_RUNS``
    plain float32 chains that round each op's output once more
    (``chip_smoke.rounded_chain``, the rounding seeded with the draw), as
    ``_held`` reads them: the first four are the rule of two orders, the
    whole row the rule of right float32 orders (F7); the launch counts of
    the kernel path; and its gradients.  ``refs`` (a dict) keeps the plain
    chains' gradients of the draw for another call on it."""
    blocks = _chain_layers(3, 35, 22, 64, device, encoder=False, seed=2)
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(3, 35, 22, 64, device=device, generator=gen)
    g = torch.randn(3, 35, 22, 64, device=device, generator=gen)

    def grads(fn, dev, dtype):
        def leaf(a):
            return a.detach().to(dev, dtype).requires_grad_()
        xs = leaf(x)
        bs = [(tuple(map(leaf, sp)), tuple(map(leaf, tm)))
              for sp, tm in blocks]
        return torch.autograd.grad(
            fn(xs, bs, agg), [xs] + [a for sp, tm in bs for a in sp + tm],
            g.to(dev, dtype))

    def dist(a, b, norm):
        return float((a.double() - b.double().to(a.device)).abs().max()) \
            / norm

    fused.reset_launch_counts()
    got = grads(fused.dstd_chain, device, torch.float32)
    counts = fused.launch_counts()
    refs = {} if refs is None else refs
    if not refs:
        refs["plain"] = grads(fused._chain_oracle, device, torch.float32)
        refs["float64"] = grads(fused._chain_oracle, device, torch.float64)
        refs["cpu"] = (grads(fused._chain_oracle, "cpu", torch.float32)
                       if cpu else refs["plain"])
        refs["rounded"] = [
            grads(lambda xs, bs, agg, d=d: cs.rounded_chain(
                fused, xs, bs, agg, d), device, torch.float32)
            for d in cs.rounding_deltas(torch, x.shape, 2 * len(blocks),
                                        seed, device)]
    rows = []
    for i, (a, b, b_cpu, c) in enumerate(zip(got, refs["plain"], refs["cpu"],
                                             refs["float64"])):
        assert a.shape == b.shape
        norm = max(float(b.abs().max()), 1.0)
        norm64 = max(float(c.abs().max()), 1.0)
        rows.append((dist(a, b, norm), dist(a, c, norm64),
                     dist(b, c, norm64), dist(b_cpu, c, norm64),
                     *(dist(r[i], c, norm64) for r in refs["rounded"])))
    return rows, counts, got


@pytest.mark.parametrize("seed", CHAIN_GRAD_SEEDS)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_chain_gradient_replays_the_op_kernels(cuda, agg, seed):
    """dstd_chain's backward (the per-op forward and backward kernels)
    against autograd through the plain chain, x and every weight, each
    gradient held as the tile cases hold theirs (``_held``): within 1e-4
    of max(|plain|, 1), or near the plain chain's float64 run, within
    F64_NOISE times the farthest of the right float32 orders: the plain
    chain on the card and on the CPU and ``chip_smoke.ROUNDING_RUNS``
    plain chains that round each op's output once more.  The gate
    gradients (dalpha) sum products that cancel, so two right float32
    orders of the chain can lie farther apart than 1e-4, and two alone
    say how close they happened to land (F7)."""
    rows, counts, _ = _chain_grad_case(agg, seed, cuda)
    assert counts["dstd_chain"] == 1
    assert counts["dstd_spatial"] == counts["dstd_temporal"] == 3
    assert counts["dstd_spatial_bwd"] == 3 * fused.BWD_LAUNCHES
    for i, row in enumerate(rows):
        assert _held(None, "gradient", *row), (i, row)


#: the bf16 chain kernels against their plain versions (the oracles with
#: the dtype), max |kernel - plain| over the peak |plain float32 output|,
#: each against its own bf16-versus-float32 gap.  Two right implementations
#: can round an op's input to neighbouring bf16 values: each layer, on the
#: kernel's own input, within BF16_LAYER_FRAC of the layer's gap (measured
#: up to 0.09 of it here, 0.195 in chip_smoke.py).  Over five layers a flip
#: moves the next layers' inputs and their roundings flip in turn, so the
#: five-layer error is held within BF16_CHAIN_FRAC of its own gap (measured
#: up to 0.69).  Past its fraction a check still holds where the kernel lies
#: near the float64 run of the bf16 contract (``chip_smoke.chain_held``,
#: F64_NOISE times the plain contract's own distance to it): which of two
#: right orders a flip lands in depends on the input (ROADMAP.md, F7).
BF16_LAYER_FRAC = 0.3
BF16_CHAIN_FRAC = 0.9


def _bf16_chain_case(encoder, agg, n, t, v, c, device, call=None):
    """One bf16 chain case (5 seeded layers, seed 3; x seeded by n) at
    (N, T, V, C): {check: (error, gap, fraction, the kernel's and the plain
    contract's distance to the contract's float64 run)} for each layer on
    the kernel's own input (``layer<i>``, BF16_LAYER_FRAC) and for the five
    layers (``chain``, BF16_CHAIN_FRAC), each over the peak |plain float32
    output|, as ``chip_smoke.chain_held`` reads them; and whether the
    launches counted, two calls gave the same bits and the one-layer
    launches equal the five-layer one.  ``call`` replaces the kernel call
    (a broken one, say)."""
    layers = _chain_layers(5, t, v, c, device, encoder=encoder, seed=3)
    x = torch.randn(n, t, v, c, device=device,
                    generator=torch.Generator(device).manual_seed(n))
    name = "dstd_encoder_chain" if encoder else "dstd_chain"
    call = call or getattr(fused, name)
    ref = fused._encoder_oracle if encoder else fused._chain_oracle
    bf16 = torch.bfloat16

    def held(got, x, given, frac):
        want, want32 = ref(x, given, agg, bf16), ref(x, given, agg)
        want64 = ref(x.double(), cs.widened(given), agg, bf16)
        peak = float(want32.abs().max())
        return (float((got - want).abs().max()) / peak,
                float((want - want32).abs().max()) / peak, frac,
                float((got.double() - want64).abs().max()) / peak,
                float((want.double() - want64).abs().max()) / peak)

    out = {}
    fused.reset_launch_counts()
    with torch.no_grad():
        got = call(x, layers, agg, bf16)
        again = call(x, fused.pack_chain(layers), agg, bf16)
        h = x
        for i in range(len(layers)):      # layer by layer, its own input
            y = call(h, layers[i:i + 1], agg, bf16)
            out[f"layer{i}"] = held(y, h, layers[i:i + 1], BF16_LAYER_FRAC)
            h = y
        out["chain"] = held(got, x, layers, BF16_CHAIN_FRAC)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    same = (counts[f"{name}_bf16"] == 2 + len(layers) and counts[name] == 0
            and got.dtype == torch.float32 and torch.equal(got, again)
            and torch.equal(got, h))
    return out, same


@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("encoder", [True, False])
def test_bf16_chain_kernels_match_plain(cuda, encoder, agg, n):
    out, same = _bf16_chain_case(encoder, agg, n, 35, 22, 64, cuda)
    assert same
    assert all(cs.chain_held(*d) for d in out.values()), out


#: (N, T, V, C) of the encoder kernels' cluster edges (both dtypes): the
#: cluster is ceil(T / tile) = 7 blocks at T = 35, and the temporal op's
#: tiles of ceil(V / 7) = 4 joints leave rank 6 without output joints at
#: V = 22 and with one at V = 25 (the CMU joints), where ceil(V / tile) = 5
#: differs from the cluster; at 3DPW's T = 40 the cluster reaches
#: MAX_CLUSTER = 8 blocks of tile 5, and the temporal op's tiles of 3 of
#: V = 23 joints leave the last rank 2
ENCODER_EDGES = [(3, 35, 22, 64), (3, 35, 25, 64), (3, 40, 23, 64)]
#: (N, T, V, C, layers) of the fast model's encoder (2 layers of 16
#: features, T = 10 + 10, agg left): at T = 20 < V = 22 the joints set the
#: cluster, 8 blocks of tile ceil(22 / 8) = 3, the last with 1 joint; the
#: 20 frames fill 7 of them
FAST_ENCODER_EDGE = (3, 20, 22, 16, 2)


@pytest.mark.parametrize("n,t,v,c", ENCODER_EDGES)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_bf16_encoder_chain_kernel_at_cluster_edges(cuda, agg, n, t, v, c):
    out, same = _bf16_chain_case(True, agg, n, t, v, c, cuda)
    assert same
    assert all(cs.chain_held(*d) for d in out.values()), out


@pytest.mark.parametrize("n,t,v,c", ENCODER_EDGES)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_bf16_chain_kernel_at_cluster_edges(cuda, agg, n, t, v, c):
    """dstd_chain at bf16 at the same cluster edges (its tensor-core ops
    at the chain's cluster, as the encoder's)."""
    out, same = _bf16_chain_case(False, agg, n, t, v, c, cuda)
    assert same
    assert all(cs.chain_held(*d) for d in out.values()), out


@pytest.mark.parametrize("n,t,v,c", ENCODER_EDGES)
@pytest.mark.parametrize("agg", ["right", "left"])
def test_float32_encoder_chain_kernel_at_cluster_edges(cuda, agg, n, t, v,
                                                       c):
    _encoder_case(agg, n, t, v, c, cuda)


def test_float32_encoder_chain_kernel_at_the_fast_models_edge(cuda):
    n, t, v, c, count = FAST_ENCODER_EDGE
    _encoder_case("left", n, t, v, c, cuda, count)


@pytest.mark.parametrize("agg", ["right", "left"])
def test_bf16_chain_gradient_is_the_float32_chains(cuda, agg):
    """dstd_chain at bf16: one bf16 chain launch, and the backward replays
    the chain at float32 (the JAX package's VJP of its float32 oracle), so
    the gradients equal the float32 chain's bit for bit and no bf16 one-op
    kernel runs."""
    blocks = _chain_layers(3, 35, 22, 64, cuda, encoder=False, seed=2)
    x = torch.randn(3, 35, 22, 64, device=cuda)
    g = torch.randn(3, 35, 22, 64, device=cuda)
    grads, counts = {}, {}
    for dtype in (torch.bfloat16, None):
        leaves = [x.clone().requires_grad_()] + [
            a.clone().requires_grad_() for sp, tm in blocks for a in sp + tm]
        it = iter(leaves[1:])
        rebuilt = [(tuple(next(it) for _ in range(10)),
                    tuple(next(it) for _ in range(10))) for _ in blocks]
        fused.reset_launch_counts()
        grads[dtype] = torch.autograd.grad(
            fused.dstd_chain(leaves[0], rebuilt, agg, dtype), leaves, g)
        counts[dtype] = fused.launch_counts()
    replay = dict(dstd_spatial=3, dstd_temporal=3,
                  dstd_spatial_bwd=3 * fused.BWD_LAUNCHES,
                  dstd_temporal_bwd=3 * fused.BWD_LAUNCHES)
    zeros = {k: 0 for k in counts[None]}
    assert counts[torch.bfloat16] == {**zeros, **replay,
                                      "dstd_chain_bf16": 1}
    assert counts[None] == {**zeros, **replay, "dstd_chain": 1}
    assert all(torch.equal(a, b)
               for a, b in zip(grads[torch.bfloat16], grads[None]))


def test_chain_wrappers_reject_what_the_kernels_do_not_take(cuda):
    layers = _chain_layers(2, 10, 7, 8, cuda, encoder=True)
    blocks = [layer[:2] for layer in layers]
    x = torch.randn(2, 10, 7, 8, device=cuda)
    for fn, arg in ((fused.dstd_encoder_chain, layers),
                    (fused.dstd_chain, blocks)):
        # bf16 runs its kernel (the bf16 chain tests below); float16 has none
        with pytest.raises(NotImplementedError, match="float16"):
            fn(x, arg, "right", torch.float16)
        with pytest.raises(ValueError):       # 11 joints, weights for 7
            fn(torch.randn(2, 10, 11, 8, device=cuda), arg)
        with pytest.raises(ValueError):       # not contiguous
            fn(x.transpose(1, 2).contiguous().transpose(1, 2), arg)
        with pytest.raises(ValueError):       # T = 80: no cluster fits
            fn(torch.randn(1, 80, 7, 8, device=cuda),
               _chain_layers(1, 80, 7, 8, cuda, encoder=True)
               if fn is fused.dstd_encoder_chain else
               _chain_layers(1, 80, 7, 8, cuda, encoder=False))
    bad = [list(layer) for layer in layers]     # one layer's wf 8 -> 4
    bad[1][0] = bad[1][0][:2] + (bad[1][0][2][:, :, :4],) + bad[1][0][3:]
    with pytest.raises(ValueError):
        fused.dstd_encoder_chain(x, [tuple(layer) for layer in bad])
    with pytest.raises(RuntimeError, match="no gradient"):
        fused.dstd_encoder_chain(x.clone().requires_grad_(), layers)


# -- blocked sparse kernels (csrc/block_sparse.cu) --------------------------

# (n, v, vj, r, c, block, density): the JAX tests' sizes, the gradient
# size, a non-square SpMM, a ragged channel tile (C=200), a block of 96 (a
# ragged 64-row tile) and R=3, a non-square SpMM with C not a multiple of 4
# (37: x's 4-byte copies)
SPARSE_CASES = [(2, 32, 32, 4, 16, 8, 0.4), (2, 256, 256, 4, 16, 128, 0.5),
                (2, 256, 384, 4, 8, 128, 0.5), (3, 256, 256, 4, 200, 64, 0.3),
                (2, 384, 384, 3, 40, 96, 0.4),
                (2, 256, 512, 4, 37, 64, 0.5)]


def _sparse_case(n, v, vj, r, c, block, density, device, seed=0):
    from dstdgcn_tpu_torch.kernels import sparse
    rng = np.random.RandomState(seed)
    rows, cols = sparse.active_blocks(rng.rand(v // block, vj // block)
                                      < density)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device)

    return dict(rows=rows, cols=cols, block=block, adj=t(n, v, vj),
                xj=t(n, vj, c), q=t(n, v, r), k=t(n, v, r), w=t(r),
                x=t(n, v, c),
                mask=sparse.pattern(rows, cols, block, v, vj).mask(device))


def _spmm_held(got, adj, xj):
    """Whether an SpMM output holds against the plain float32 product
    ``spmm_dense(adj, xj)`` (adj already masked): every element within
    rtol = atol = 1e-5 of it, or, failing that, the kernel's max distance
    to the float64 product within F64_NOISE times the plain product's own,
    the larger of its runs on the card and on the CPU (F8 in ROADMAP.md:
    two float32-accurate orders of a sum of a few hundred products can
    lie 1e-5 apart at an element near 0).  (holds, the numbers)"""
    from dstdgcn_tpu_torch.kernels import sparse
    want = sparse.spmm_dense(adj, xj)
    past = ~torch.isclose(got, want, rtol=1e-5, atol=1e-5)
    want64 = sparse.spmm_dense(adj.double(), xj.double())

    def dist(a):
        return float((a.double() - want64.to(a.device)).abs().max())

    kernel64 = dist(got)
    plain64 = max(dist(want), dist(sparse.spmm_dense(adj.cpu(), xj.cpu())))
    held = not bool(past.any()) or kernel64 <= F64_NOISE * plain64
    return held, dict(past=int(past.sum()), kernel64=kernel64,
                      plain64=plain64)


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_kernels_match_plain(cuda, case):
    from dstdgcn_tpu_torch.kernels import sparse
    d = _sparse_case(*case, cuda)
    pat = (d["rows"], d["cols"], d["block"])
    sparse.reset_launch_counts()
    got = sparse.block_spmm(d["adj"], d["xj"], *pat)
    again = sparse.block_spmm(d["adj"], d["xj"], *pat)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    held, numbers = _spmm_held(got, d["adj"] * d["mask"], d["xj"])
    print(f"spmm {case}: {numbers}")
    assert held, numbers
    assert sparse.launch_counts()["block_spmm"] == 2
    if case[1] != case[2]:
        return
    qkw = (d["q"], d["k"], d["w"])
    scores = sparse.block_sddmm(*qkw, *pat)
    want = sparse.sddmm_dense(*qkw)
    sel = d["mask"].bool().expand_as(want)
    torch.testing.assert_close(scores[sel], want[sel], rtol=1e-5, atol=1e-5)
    got = sparse.block_sddmm_spmm(*qkw, d["x"], *pat)
    torch.testing.assert_close(
        got, sparse.sddmm_spmm_dense(*qkw, d["x"], d["mask"]), rtol=1e-4,
        atol=1e-4)
    assert sparse.launch_counts() == dict(block_spmm=2, block_sddmm=1,
                                          block_sddmm_spmm=1)


@pytest.mark.parametrize("case", SPARSE_CASES[1:3])
def test_sparse_autograd_functions_match_the_masked_oracle(cuda, case):
    from dstdgcn_tpu_torch.kernels import sparse
    d = _sparse_case(*case, cuda, seed=1)
    pat = (d["rows"], d["cols"], d["block"])
    leaves = [d["adj"].requires_grad_(), d["xj"].requires_grad_()]
    g = torch.randn(case[0], case[1], case[4], device=cuda)
    sparse.reset_launch_counts()
    got = torch.autograd.grad(sparse.block_spmm(*leaves, *pat), leaves, g)
    want = torch.autograd.grad(
        sparse.spmm_dense(leaves[0] * d["mask"], leaves[1]), leaves, g)
    _assert_grads_close(got, want)
    if case[1] == case[2]:
        leaves = [d[key].requires_grad_() for key in ("q", "k", "w", "x")]
        got = torch.autograd.grad(sparse.block_sddmm_spmm(*leaves, *pat),
                                  leaves, g)
        want = torch.autograd.grad(
            sparse.sddmm_spmm_dense(*leaves, d["mask"]), leaves, g)
        _assert_grads_close(got, want)
    counts = sparse.launch_counts()
    assert counts["block_spmm"] == 1 and counts["block_sddmm"] == 0
    assert counts["block_sddmm_spmm"] == int(case[1] == case[2])


#: (n, v, block, r, c, heavy row): one block row with every column block
#: active, the others their diagonal block alone (the heavy row's walk is
#: 8-16x the mean's); R = 32, the largest; C not a multiple of 8 (36: the
#: float4 path) or of 4 (37, 13: the scalar path), or past one 128-channel
#: tile (200)
SPARSE_SKEW = [(2, 1024, 64, 32, 36, 0), (2, 1024, 64, 32, 37, 5),
               (3, 512, 128, 3, 13, 3), (1, 2048, 128, 32, 200, 7)]


#: the SpMM's skewed cases, (n, v, vj, block, c, heavy row): those of
#: SPARSE_SKEW, and a non-square one (8 x 24 blocks, the heavy row's walk
#: 24 blocks)
SPMM_SKEW = [(n, v, v, block, c, heavy)
             for n, v, block, _, c, heavy in SPARSE_SKEW] + [
                 (2, 512, 1536, 64, 37, 3)]
#: the SDDMM's: those of SPARSE_SKEW, and a block of 6 (not a multiple of
#: 4: the scalar stores)
SDDMM_SKEW = [(n, v, block, r, heavy)
              for n, v, block, r, _, heavy in SPARSE_SKEW] + [
                  (2, 150, 6, 5, 4)]


def _skewed_pattern(v, vj, block, heavy):
    """(rows, cols) of a pattern with the diagonal blocks and every block
    of the heavy block row."""
    from dstdgcn_tpu_torch.kernels import sparse
    mask = np.eye(v // block, vj // block, dtype=bool)
    mask[heavy] = True
    return sparse.active_blocks(mask)


def _seeded(rng, device, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("n,v,vj,block,c,heavy", SPMM_SKEW)
def test_spmm_kernel_on_a_skewed_pattern(cuda, n, v, vj, block, c, heavy):
    """block_spmm on a skewed pattern: two calls give the same bits,
    within ``SPARSE_TOL`` = 1e-5 of max(|plain|, 1) of the masked dense
    product."""
    from dstdgcn_tpu_torch.kernels import sparse
    rows, cols = _skewed_pattern(v, vj, block, heavy)
    rng = np.random.RandomState(heavy)
    adj, xj = _seeded(rng, cuda, n, v, vj), _seeded(rng, cuda, n, vj, c)
    m = sparse.pattern(rows, cols, block, v, vj).mask(cuda)
    before = sparse.launch_counts()["block_spmm"]
    got = sparse.block_spmm(adj, xj, rows, cols, block)
    again = sparse.block_spmm(adj, xj, rows, cols, block)
    torch.cuda.synchronize()
    assert sparse.launch_counts()["block_spmm"] == before + 2
    assert torch.equal(got, again)
    want = sparse.spmm_dense(adj * m, xj)
    err = float((got - want).abs().max())
    assert err <= cs.SPARSE_TOL["block_spmm"] * max(
        float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("n,v,block,r,heavy", SDDMM_SKEW)
def test_sddmm_kernel_on_a_skewed_pattern(cuda, n, v, block, r, heavy):
    """block_sddmm on a skewed pattern, its active blocks only: two calls
    give the same bits, within ``SPARSE_TOL`` = 1e-5 of max(|plain|, 1)."""
    from dstdgcn_tpu_torch.kernels import sparse
    rows, cols = _skewed_pattern(v, v, block, heavy)
    rng = np.random.RandomState(heavy)
    q, k, w = (_seeded(rng, cuda, n, v, r), _seeded(rng, cuda, n, v, r),
               _seeded(rng, cuda, r))
    sel = sparse.pattern(rows, cols, block, v, v).mask(cuda).bool().expand(
        n, v, v)
    before = sparse.launch_counts()["block_sddmm"]
    got = sparse.block_sddmm(q, k, w, rows, cols, block)[sel]
    again = sparse.block_sddmm(q, k, w, rows, cols, block)[sel]
    torch.cuda.synchronize()
    assert sparse.launch_counts()["block_sddmm"] == before + 2
    assert torch.equal(got, again)
    want = sparse.sddmm_dense(q, k, w)[sel]
    err = float((got - want).abs().max())
    assert err <= cs.SPARSE_TOL["block_sddmm"] * max(
        float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("n,v,block,r,c,heavy", SPARSE_SKEW)
def test_fused_sparse_kernel_on_a_skewed_pattern(cuda, n, v, block, r, c,
                                                 heavy):
    """block_sddmm_spmm on a pattern whose active blocks per row lie far
    from their mean: two calls give the same bits, within
    ``SPARSE_TOL`` = 1e-4 of max(|plain|, 1) of the masked dense oracle."""
    from dstdgcn_tpu_torch.kernels import sparse
    nb = v // block
    mask = np.eye(nb, dtype=bool)
    mask[heavy] = True
    rows, cols = sparse.active_blocks(mask)
    rng = np.random.RandomState(heavy)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            cuda)

    q, k, w, x = t(n, v, r), t(n, v, r), t(r), t(n, v, c)
    m = sparse.pattern(rows, cols, block, v, v).mask(cuda)
    before = sparse.launch_counts()["block_sddmm_spmm"]
    got = sparse.block_sddmm_spmm(q, k, w, x, rows, cols, block)
    again = sparse.block_sddmm_spmm(q, k, w, x, rows, cols, block)
    torch.cuda.synchronize()
    assert sparse.launch_counts()["block_sddmm_spmm"] == before + 2
    assert torch.equal(got, again)
    want = sparse.sddmm_spmm_dense(q, k, w, x, m)
    err = float((got - want).abs().max())
    assert err <= cs.SPARSE_TOL["block_sddmm_spmm"] * max(
        float(want.abs().max()), 1.0), err


def test_sparse_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from dstdgcn_tpu_torch.kernels import sparse
    d = _sparse_case(*SPARSE_CASES[0], cuda)
    pat = (d["rows"], d["cols"], d["block"])
    qkw = (d["q"], d["k"], d["w"])
    with pytest.raises(TypeError):
        sparse.block_spmm(d["adj"].double(), d["xj"], *pat)
    with pytest.raises(TypeError):
        sparse.block_sddmm_spmm(d["q"].half(), d["k"], d["w"], d["x"], *pat)
    with pytest.raises(ValueError):       # not contiguous
        sparse.block_spmm(d["adj"].transpose(1, 2), d["xj"], *pat)
    with pytest.raises(ValueError):       # x on the CPU
        sparse.block_sddmm_spmm(*qkw, d["x"].cpu(), *pat)
    with pytest.raises(ValueError):       # unsorted block list
        sparse.block_sddmm(*qkw, d["rows"][::-1], d["cols"][::-1], 8)
    with pytest.raises(ValueError):       # V = 32 not a multiple of 12
        sparse.block_spmm(d["adj"], d["xj"], d["rows"], d["cols"], 12)
    rows, cols = sparse.active_blocks(np.ones((16, 16), bool))
    with pytest.raises(ValueError, match="multiple of 4"):   # block 2
        sparse.block_spmm(d["adj"], d["xj"], rows, cols, 2)
    big_r = [torch.randn(2, 32, sparse.MAX_R + 1, device=cuda)] * 2 + [
        torch.randn(sparse.MAX_R + 1, device=cuda)]
    with pytest.raises(ValueError, match="R="):
        sparse.block_sddmm(*big_r, *pat)
    with pytest.raises(RuntimeError, match="no gradient"):
        sparse.block_sddmm(d["q"].clone().requires_grad_(), d["k"], d["w"],
                           *pat)
