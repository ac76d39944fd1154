"""The port's plain DSTD-GC ops and kernel wrappers against the JAX package.

The same numpy inputs go through ``dstdgcn_tpu.ops.dstd`` (the XLA path),
``dstdgcn_tpu.kernels.fused`` (the Pallas kernels, run by the Pallas
interpreter on the CPU as ``tests/test_kernels.py`` runs them) and the
port's ``ops.dstd`` / ``kernels.fused`` wrappers on CPU tensors.  Float32
tolerance 1e-5: only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.kernels import fused as jfused
from dstdgcn_tpu.ops import dstd as joracle
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.ops import dstd as tops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHTS = ("wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm")


def _case(mode, n, cin, co, seed=0):
    """Seeded numpy inputs of one op: (x, base, alpha, weights)."""
    rng = np.random.RandomState(seed)
    t, v = 7, 6
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    mk = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    x = rng.randn(n, t, v, cin).astype(np.float32)
    base = mk(k, pair, pair)
    alpha = np.asarray([0.7], np.float32)
    w = dict(wf=mk(k, cin, co), bf=mk(k, co), wm1=mk(k, cin, 2),
             bm1=mk(k, 2), wm2=mk(k, cin, 2), bm2=mk(k, 2),
             wrm=mk(k, 2, ref, ref), brm=mk(k, ref))
    return x, base, alpha, w


def _jax_args(x, base, alpha, w):
    return [jnp.asarray(a) for a in (x, base, alpha)] + \
        [jnp.asarray(w[k]) for k in WEIGHTS]


def _torch_args(x, base, alpha, w):
    return [torch.from_numpy(a) for a in (x, base, alpha)] + \
        [torch.from_numpy(w[k]) for k in WEIGHTS]


@pytest.mark.parametrize("reference", ["oracle", "pallas"])
@pytest.mark.parametrize("cin,co", [(6, 4), (5, 3)])
@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_plain_op_matches_jax(mode, agg, n, cin, co, reference):
    x, base, alpha, w = _case(mode, n, cin, co)
    if reference == "oracle":
        fn = getattr(joracle, f"dstd_{mode}")
        want = fn(*_jax_args(x, base, alpha, w), None, agg)
    else:
        fn = getattr(jfused, f"dstd_{mode}")
        want = fn(*_jax_args(x, base, alpha, w), None, agg)
    got = getattr(tops, f"dstd_{mode}")(*_torch_args(x, base, alpha, w),
                                        None, agg)
    assert got.shape == (n, 7, 6, co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_mask_matches_jax(mode):
    x, base, alpha, w = _case(mode, 3, 5, 4, seed=3)
    p = 6 if mode == "spatial" else 7
    mask = (np.random.RandomState(4).rand(p, p) > 0.4).astype(np.float32)
    want = getattr(joracle, f"dstd_{mode}")(*_jax_args(x, base, alpha, w),
                                            jnp.asarray(mask), "right")
    targs = _torch_args(x, base, alpha, w)
    got = getattr(tops, f"dstd_{mode}")(*targs, torch.from_numpy(mask),
                                        "right")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper hands a masked call to the plain op, as the JAX one does
    tfused.reset_launch_counts()
    wrapped = getattr(tfused, f"dstd_{mode}")(*targs, torch.from_numpy(mask),
                                              "right")
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_layout_knobs_are_no_ops(mode):
    x, base, alpha, w = _case(mode, 3, 5, 4, seed=5)
    targs = _torch_args(x, base, alpha, w)
    fn = getattr(tops, f"dstd_{mode}")
    plain = fn(*targs, None, "left")
    knobs = fn(*targs, None, "left", None, pair_flat=True, agg_group=2)
    np.testing.assert_array_equal(plain.numpy(), knobs.numpy())
    want = getattr(joracle, f"dstd_{mode}")(
        *_jax_args(x, base, alpha, w), None, "left", None, pair_flat=True,
        agg_group=2)
    np.testing.assert_allclose(knobs.numpy(), np.asarray(want), **TOL)


def test_building_blocks_match_jax():
    rng = np.random.RandomState(6)
    q = rng.randn(2, 5, 2).astype(np.float32)
    k = rng.randn(2, 5, 2).astype(np.float32)
    mask = (rng.rand(5, 5) > 0.5).astype(np.float32)
    for m in (None, mask):
        want = joracle.sddmm_pairwise_tanh(
            jnp.asarray(q), jnp.asarray(k),
            None if m is None else jnp.asarray(m))
        got = tops.sddmm_pairwise_tanh(
            torch.from_numpy(q), torch.from_numpy(k),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for mode in ("spatial", "temporal"):
        x, _, _, w = _case(mode, 3, 5, 4, seed=7)
        wargs = [w[key] for key in ("wm1", "bm1", "wm2", "bm2", "wrm",
                                    "brm")]
        want = getattr(joracle, f"dyn_adjacency_{mode}")(
            jnp.asarray(x), *[jnp.asarray(a) for a in wargs])
        got = getattr(tops, f"dyn_adjacency_{mode}")(
            torch.from_numpy(x), *[torch.from_numpy(a) for a in wargs])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        xf = rng.randn(2, 3, 7, 6, 4).astype(np.float32)
        adj = rng.randn(*np.asarray(want).shape).astype(np.float32)
        for agg in ("right", "left"):
            want_a = getattr(joracle, f"aggregate_{mode}")(
                jnp.asarray(xf[: adj.shape[0]]), jnp.asarray(adj), agg)
            got_a = getattr(tops, f"aggregate_{mode}")(
                torch.from_numpy(xf[: adj.shape[0]]), torch.from_numpy(adj),
                agg)
            np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                                       **TOL)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_wrapper_on_cpu_runs_plain_op_and_counts_nothing(mode):
    x, base, alpha, w = _case(mode, 3, 6, 4, seed=8)
    targs = _torch_args(x, base, alpha, w)
    tfused.reset_launch_counts()
    for agg in ("right", "left"):
        got = getattr(tfused, f"dstd_{mode}")(*targs, None, agg)
        want = getattr(tops, f"dstd_{mode}")(*targs, None, agg)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tfused.launch_counts() == {
        "dstd_spatial": 0, "dstd_temporal": 0, "dstd_spatial_bwd": 0,
        "dstd_temporal_bwd": 0, "dstd_chain": 0, "dstd_encoder_chain": 0,
        "dstd_spatial_bf16": 0, "dstd_temporal_bf16": 0,
        "dstd_spatial_bwd_bf16": 0, "dstd_temporal_bwd_bf16": 0,
        "dstd_chain_bf16": 0, "dstd_encoder_chain_bf16": 0}


def test_bf16_plain_op_rounds_contraction_inputs():
    x, base, alpha, w = _case("spatial", 3, 5, 4, seed=9)
    targs = _torch_args(x, base, alpha, w)
    f32 = tops.dstd_spatial(*targs)
    bf16 = tops.dstd_spatial(*targs, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    err = (bf16.float() - f32).abs().max().item()
    assert 0 < err < 2e-2 * f32.abs().max().item()


def test_bad_agg_raises():
    x, base, alpha, w = _case("spatial", 3, 5, 4)
    with pytest.raises(ValueError):
        tops.dstd_spatial(*_torch_args(x, base, alpha, w), None, "middle")


def test_backward_default_tile_evens_out_the_blocks_of_a_sample():
    """Without a tile asked for, the backward wrappers take the largest
    tile that fits, then the smallest with as few blocks a sample: the
    bf16 default of 8 output indices a block gives 7 at T = 35, 8 at V =
    22 and 7 at V = 25 (blocks of 7, 7, 7, 4); where tile 8 does not fit,
    7 at V = 23 gives 6 (6, 6, 6, 5).  A tile asked for stays as the
    search leaves it."""
    from dstdgcn_tpu_torch.kernels import build

    class Lib:  # a block of tile k takes 30,000 k bytes: k <= 7 fits
        pass

    lib = Lib()
    for op in ("dstd_spatial_bwd", "dstd_temporal_bwd"):
        setattr(lib, build.SMEM_BYTES[op, "bf16"],
                lambda t, v, ci, co, k, r, tile: 30000 * tile)
    sp, te = tfused.dstd_spatial_bwd, tfused.dstd_temporal_bwd
    assert sp._tile(lib, "bf16", 35, 22, 64, 64, 2, 2, None) == 7
    assert te._tile(lib, "bf16", 35, 25, 64, 64, 1, 2, None) == 7
    assert te._tile(lib, "bf16", 40, 23, 64, 64, 1, 2, None) == 6
    assert te._tile(lib, "bf16", 35, 25, 64, 64, 1, 2, 6) == 6
    assert sp._tile(lib, "bf16", 35, 25, 64, 64, 2, 2, 4) == 4
    # every tile fits: H36M's 22 joints in blocks of 8, 8, 6
    setattr(lib, build.SMEM_BYTES["dstd_temporal_bwd", "bf16"],
            lambda *shape: 0)
    assert te._tile(lib, "bf16", 35, 22, 64, 64, 1, 2, None) == 8


@pytest.mark.parametrize("variant", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", [op.name for op in tfused._KERNELS])
def test_every_kernel_variant_names_its_shared_memory_function(kernel,
                                                               variant):
    """The tile searches read a block's shared memory through
    ``build.SMEM_BYTES``: every variant of every wrapper has an entry, and
    it names a function its library declares (loading binds each one)."""
    from dstdgcn_tpu_torch.kernels import build
    lib = "dstd_chain" if kernel == "dstd_encoder_chain" else kernel
    assert build.SMEM_BYTES[kernel, variant] in build.SIGNATURES[lib]
