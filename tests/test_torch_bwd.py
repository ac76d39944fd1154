"""The port's DSTD-GC backward against autograd and the JAX package.

Three holds for each op, both aggregations, shapes with ragged T and V:

* the hand-derived plain backward (``ops/dstd_bwd.py``) against torch
  autograd of the plain forward (``ops/dstd.py``);
* the port's 11 gradients, from the plain backward and from autograd through
  the kernel wrappers' ``torch.autograd.Function`` on CPU tensors, against
  ``jax.vjp`` through ``dstdgcn_tpu.kernels.fused`` (its ``custom_vjp`` runs
  the Pallas backward kernels of ``kernels/fused_bwd.py`` in the Pallas
  interpreter, as ``tests/test_kernels.py`` runs them) and through the XLA
  path ``dstdgcn_tpu.ops.dstd`` (autodiff);
* ``torch.autograd.gradcheck`` of the Function's CPU path in float64.

Float32 tolerance: max |port - reference| <= 1e-5 max(max |reference|, 1)
per gradient (only the summation order differs; the norm of
``tests/test_kernels.py:209``, tightened to the per-op 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.kernels import fused as jfused
from dstdgcn_tpu.ops import dstd as joracle
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.ops import dstd as tops
from dstdgcn_tpu_torch.ops import dstd_bwd as tbwd

torch.set_num_threads(2)

TOL = 1e-5
#: (n, t, v, cin, co): the shape of tests/test_kernels.py:188 and two with
#: other ragged frame/joint counts and channel widths
SHAPES = [(3, 6, 5, 4, 4), (2, 7, 3, 5, 3), (4, 5, 9, 3, 6)]
NAMES = ("dx", "dbase", "dalpha", "dwf", "dbf", "dwm1", "dbm1", "dwm2",
         "dbm2", "dwrm", "dbrm")


def _case(mode, shape, seed=0, dtype=np.float32):
    """Seeded (x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)."""
    n, t, v, cin, co = shape
    rng = np.random.RandomState(seed)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)

    def mk(*s):
        return (rng.randn(*s) * 0.3).astype(dtype)

    return [rng.randn(n, t, v, cin).astype(dtype),
            rng.randn(n, t, v, co).astype(dtype), mk(k, pair, pair),
            np.asarray([0.7], dtype), mk(k, cin, co), mk(k, co),
            mk(k, cin, 2), mk(k, 2), mk(k, cin, 2), mk(k, 2),
            mk(k, 2, ref, ref), mk(k, ref)]


def _assert_close(got, want, names=NAMES):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= TOL * max(np.abs(b).max(), 1.0), (name, err)


def _jax_grads(fn, case, agg):
    x, g, *weights = [jnp.asarray(a) for a in case]
    out, vjp = jax.vjp(lambda *a: fn(*a, None, agg), x, *weights)
    assert out.shape == g.shape
    return vjp(g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_plain_backward_matches_autograd(mode, agg, shape):
    case = [torch.from_numpy(a) for a in _case(mode, shape)]
    x, g, *weights = case
    args = [a.clone().requires_grad_() for a in [x] + weights]
    out = getattr(tops, f"dstd_{mode}")(*args, None, agg)
    want = torch.autograd.grad(out, args, g)
    got = getattr(tbwd, f"dstd_{mode}_bwd")(x, g, *weights, agg=agg)
    _assert_close([a.numpy() for a in got], [a.numpy() for a in want])


@pytest.mark.parametrize("reference", ["pallas", "oracle"])
@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_port_gradients_match_jax(mode, agg, shape, reference):
    case = _case(mode, shape, seed=1)
    jmod = jfused if reference == "pallas" else joracle
    want = _jax_grads(getattr(jmod, f"dstd_{mode}"), case, agg)
    x, g, *weights = [torch.from_numpy(a) for a in case]
    got = getattr(tbwd, f"dstd_{mode}_bwd")(x, g, *weights, agg=agg)
    _assert_close([a.numpy() for a in got], want)
    # the same through the wrapper's autograd Function (CPU path): argument
    # order, dbase layout and alpha's shape as the JAX custom_vjp returns
    args = [a.clone().requires_grad_() for a in [x] + weights]
    tfused.reset_launch_counts()
    out = getattr(tfused, f"dstd_{mode}")(*args, None, agg)
    wired = torch.autograd.grad(out, args, g)
    assert wired[2].shape == (1,)
    _assert_close([a.numpy() for a in wired], want)
    assert set(tfused.launch_counts().values()) == {0}


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_function_gradcheck_float64(mode, agg):
    case = _case(mode, (2, 4, 3, 3, 2), seed=2, dtype=np.float64)
    x, _, *weights = case
    args = [torch.from_numpy(a).requires_grad_() for a in [x] + weights]
    fn = getattr(tfused, f"dstd_{mode}")
    assert torch.autograd.gradcheck(lambda *a: fn(*a, None, agg), args)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_wrapper_routes_without_grad_mask_and_dtype(mode):
    x, g, *weights = [torch.from_numpy(a) for a in
                      _case(mode, SHAPES[0], seed=3)]
    fn = getattr(tfused, f"dstd_{mode}")
    plain = getattr(tops, f"dstd_{mode}")
    args = [a.clone().requires_grad_() for a in [x] + weights]
    # no gradient wanted: one plain forward, no autograd graph
    with torch.no_grad():
        out = fn(*args)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), plain(x, *weights).numpy())
    # a python-float alpha takes alpha's shape () in its gradient
    args_f = [args[0], args[1], 0.7] + args[3:]
    out = fn(*args_f)
    grads = torch.autograd.grad(out, [args[0]], g)
    want = torch.autograd.grad(plain(*args_f), [args[0]], g)
    np.testing.assert_allclose(grads[0].numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    # a mask takes autograd of the plain op, as the JAX custom_vjp does
    p = x.shape[2] if mode == "spatial" else x.shape[1]
    mask = torch.from_numpy(
        (np.random.RandomState(4).rand(p, p) > 0.4).astype(np.float32))
    out = fn(*args, mask=mask)
    want = plain(*args, mask=mask)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  want.detach().numpy())
    assert out.grad_fn is not None
    assert "DSTDFunction" not in type(out.grad_fn).__name__
    # a compute dtype takes the Function with the kernels' bf16 contract:
    # the plain kernel version forward, the plain backward with the dtype
    out = fn(*args, dtype=torch.bfloat16)
    want = getattr(tops, f"kernel_{mode}")(*args, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        want.detach().to(torch.bfloat16).float().numpy())
    assert "DSTDFunction" in type(out.grad_fn).__name__


def test_backward_wrappers_on_cpu_run_the_plain_backward():
    for mode in ("spatial", "temporal"):
        case = [torch.from_numpy(a) for a in _case(mode, SHAPES[1], seed=5)]
        tfused.reset_launch_counts()
        for agg in ("right", "left"):
            got = getattr(tfused, f"dstd_{mode}_bwd")(*case, agg=agg)
            want = getattr(tbwd, f"dstd_{mode}_bwd")(*case, agg=agg)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert tfused.launch_counts() == {
            "dstd_spatial": 0, "dstd_temporal": 0, "dstd_spatial_bwd": 0,
            "dstd_temporal_bwd": 0, "dstd_chain": 0,
            "dstd_encoder_chain": 0,
        "dstd_spatial_bf16": 0, "dstd_temporal_bf16": 0,
        "dstd_spatial_bwd_bf16": 0, "dstd_temporal_bwd_bf16": 0,
        "dstd_chain_bf16": 0, "dstd_encoder_chain_bf16": 0}
    with pytest.raises(ValueError):
        tbwd.dstd_spatial_bwd(*case, agg="middle")
