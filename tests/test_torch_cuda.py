"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  On a machine with the card:
``python -m pytest tests/test_torch_cuda.py -q``.  Tolerance 1e-4: the
kernels sum in another order than the plain ops; TF32 is off for the plain
side.
"""

import numpy as np
import pytest
import torch

from dstdgcn_tpu_torch.kernels import fused
from dstdgcn_tpu_torch.ops import dstd as plain

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
