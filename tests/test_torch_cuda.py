"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  On a machine with the card:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.  Tolerance
1e-4: the kernels sum in another order than the plain ops; TF32 is off for
the plain side.  Backward kernels and model gradients are held per tensor
at 1e-4 max(max |plain|, 1), since a weight gradient sums every row of the
batch.
"""

import numpy as np
import pytest
import torch

from dstdgcn_tpu_torch.kernels import fused
from dstdgcn_tpu_torch.ops import dstd as plain
from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

WEIGHTS = ("wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm")


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
    with pytest.raises(NotImplementedError):
        fused.dstd_spatial(*args, None, "right", torch.bfloat16)
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
