"""The port's blocked sparse ops against ``dstdgcn_tpu.kernels.sparse``.

Inputs are made with numpy from a seed and go through both packages: the JAX
ops run their Pallas kernels in interpret mode on the CPU (as
``tests/test_sparse_kernels.py`` runs them), the port's ops their plain
versions (the masked dense forms).  Tolerances are the JAX tests': SpMM and
SDDMM 1e-5, the fused op 1e-4, gradients 1e-4 (against the JAX
``custom_vjp`` backward, with the same seeded cotangent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.kernels import sparse as jsp
from dstdgcn_tpu_torch.kernels import sparse as sp

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def _case(seed, n=2, v=32, r=4, c=16, block=8, density=0.4, vj=None,
          masked=True):
    """Seeded inputs of the JAX tests' sizes: the block list, its element
    mask, q, k, w, x and an adjacency (zero outside the pattern when
    ``masked``, else dense: the ops must read active blocks only)."""
    rng = np.random.RandomState(seed)
    vj = v if vj is None else vj
    rows, cols = jsp.active_blocks(rng.rand(v // block, vj // block)
                                   < density)
    mask = jsp._pattern_mask(rows, cols, v // block, vj // block, block)
    adj = rng.randn(n, v, vj).astype(np.float32)
    return dict(rows=rows, cols=cols, block=block, mask=mask,
                adj=adj * mask if masked else adj,
                q=rng.randn(n, v, r).astype(np.float32),
                k=rng.randn(n, v, r).astype(np.float32),
                w=rng.randn(r).astype(np.float32),
                x=rng.randn(n, vj, c).astype(np.float32))


MASKS = {
    "random": np.random.RandomState(3).rand(4, 4) < 0.4,
    "empty": np.zeros((4, 4), bool),
    "one": np.arange(16).reshape(4, 4) == 6,     # block (1, 2) alone
    "wide": np.random.RandomState(4).rand(3, 6) < 0.3,
    "tall_empty": np.zeros((6, 3), bool),
    "tall": np.random.RandomState(5).rand(6, 3) < 0.3,
    "full": np.ones((3, 5), bool),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_active_blocks_matches_jax(name):
    got, want = sp.active_blocks(MASKS[name]), jsp.active_blocks(MASKS[name])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    rows, cols = got
    assert set(rows.tolist()) == set(range(MASKS[name].shape[0]))
    assert np.all(np.diff(rows) >= 0)


def test_pattern_state_matches_the_jax_mask():
    d = _case(0)
    pat = sp.pattern(d["rows"], d["cols"], 8, 32, 32)
    assert sp.pattern(list(d["rows"]), d["cols"], 8, 32, 32) is pat
    np.testing.assert_array_equal(
        pat.mask(torch.device("cpu")).numpy(),
        jsp._pattern_mask(d["rows"], d["cols"], 4, 4, 8))
    np.testing.assert_array_equal(
        sp._pattern_mask(d["rows"], d["cols"], 4, 4, 8),
        jsp._pattern_mask(d["rows"], d["cols"], 4, 4, 8))
    row_ptr, rows, cols = pat.csr(torch.device("cpu"))
    for i in range(4):
        seg = slice(int(row_ptr[i]), int(row_ptr[i + 1]))
        assert np.all(rows[seg].numpy() == i)
        np.testing.assert_array_equal(cols[seg].numpy(),
                                      d["cols"][d["rows"] == i])
    assert int(row_ptr[-1]) == len(d["rows"]) == pat.num_blocks


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_spmm_matches_jax(seed, masked):
    d = _case(seed, masked=masked)
    want = jsp.block_spmm(_j(d["adj"]), _j(d["x"]), d["rows"], d["cols"],
                          d["block"])
    got = sp.block_spmm(_t(d["adj"]), _t(d["x"]), d["rows"], d["cols"],
                        d["block"])
    assert got.shape == (2, 32, 16)
    _close(got, want, 1e-5)
    _close(got, jsp.spmm_dense(_j(d["adj"] * d["mask"]), _j(d["x"])), 1e-5)


@pytest.mark.parametrize("v,vj,block", [(32, 48, 8), (48, 16, 8),
                                        (256, 384, 128)])
def test_block_spmm_non_square_matches_jax(v, vj, block):
    d = _case(2, v=v, vj=vj, block=block, c=8, masked=False)
    want = jsp.block_spmm(_j(d["adj"]), _j(d["x"]), d["rows"], d["cols"],
                          block)
    got = sp.block_spmm(_t(d["adj"]), _t(d["x"]), d["rows"], d["cols"],
                        block)
    assert got.shape == (2, v, 8)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_block_sddmm_matches_jax_on_active_blocks(seed):
    d = _case(seed)
    want = np.asarray(jsp.block_sddmm(_j(d["q"]), _j(d["k"]), _j(d["w"]),
                                      d["rows"], d["cols"], d["block"]))
    got = sp.block_sddmm(_t(d["q"]), _t(d["k"]), _t(d["w"]), d["rows"],
                         d["cols"], d["block"]).numpy()
    assert got.shape == want.shape == (2, 32, 32)
    # inactive blocks are undefined by contract: compare active only
    sel = np.broadcast_to(d["mask"].astype(bool), got.shape)
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_sddmm_spmm_matches_jax(seed, r):
    d = _case(seed, r=r)
    args = [d[key] for key in ("q", "k", "w", "x")]
    want = jsp.block_sddmm_spmm(*map(_j, args), d["rows"], d["cols"],
                                d["block"])
    got = sp.block_sddmm_spmm(*map(_t, args), d["rows"], d["cols"],
                              d["block"])
    _close(got, want, 1e-4)
    _close(got, jsp.sddmm_spmm_dense(*map(_j, args), _j(d["mask"])), 1e-4)


def _close_norm(got, want, tol):
    """max |got - want| <= tol max(max |want|, 1): the norm the card holds
    the fused kernel to against this plain version (``chip_smoke.py``
    ``SPARSE_TOL``), since sums over many sources cancel."""
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


#: (n, v, r, c, block, density) at the fused kernel's edges on the card
#: (``tests/test_torch_cuda.py::SPARSE_CASES``): blocks of 8 (four to a
#: step of its walk) and 96 (a ragged 64-row tile), C = 200 (a ragged
#: channel tile), R = 1, 3 and 32 (its largest)
FUSED_EDGES = [(2, 32, 1, 16, 8, 0.4), (2, 32, 32, 16, 8, 0.4),
               (3, 256, 3, 200, 64, 0.3), (3, 256, 1, 200, 64, 0.3),
               (2, 384, 3, 40, 96, 0.4), (2, 384, 1, 40, 96, 0.4),
               (2, 384, 32, 40, 96, 0.4), (2, 256, 32, 200, 128, 0.5)]


@pytest.mark.parametrize("n,v,r,c,block,density", FUSED_EDGES)
def test_block_sddmm_spmm_matches_jax_at_the_card_edges(n, v, r, c, block,
                                                        density):
    d = _case(5, n=n, v=v, r=r, c=c, block=block, density=density)
    args = [d[key] for key in ("q", "k", "w", "x")]
    want = jsp.block_sddmm_spmm(*map(_j, args), d["rows"], d["cols"], block)
    got = sp.block_sddmm_spmm(*map(_t, args), d["rows"], d["cols"], block)
    assert got.shape == (n, v, c)
    _close_norm(got, want, 1e-4)
    _close_norm(got, jsp.sddmm_spmm_dense(*map(_j, args), _j(d["mask"])),
                1e-4)


@pytest.mark.parametrize("n,v,r,c,block,density",
                         [FUSED_EDGES[1], FUSED_EDGES[4], FUSED_EDGES[6]])
def test_block_sddmm_spmm_gradients_match_jax_at_the_card_edges(
        n, v, r, c, block, density):
    d = _case(6, n=n, v=v, r=r, c=c, block=block, density=density)
    arrs = [d[key] for key in ("q", "k", "w", "x")]
    g = np.random.RandomState(7).randn(n, v, c).astype(np.float32)

    def f(q, k, w, x):
        return jsp.block_sddmm_spmm(q, k, w, x, d["rows"], d["cols"], block)

    _, vjp = jax.vjp(f, *map(_j, arrs))
    want = vjp(_j(g))
    leaves = [_t(a).requires_grad_() for a in arrs]
    out = sp.block_sddmm_spmm(*leaves, d["rows"], d["cols"], block)
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(got, want):
        _close_norm(a, b, 1e-4)


MASKS_256 = {"lower": np.array([[True, False], [True, True]]),
             "upper": np.array([[True, True], [False, True]])}


@pytest.mark.parametrize("mask", sorted(MASKS_256))
def test_block_spmm_gradients_match_jax(mask):
    rng = np.random.RandomState(0)
    n, v, c, block = 2, 256, 8, 128
    rows, cols = jsp.active_blocks(MASKS_256[mask])
    adj, x = rng.randn(n, v, v), rng.randn(n, v, c)
    g = rng.randn(n, v, c)
    _, vjp = jax.vjp(lambda a, b: jsp.block_spmm(a, b, rows, cols, block),
                     _j(adj), _j(x))
    want = vjp(_j(g))
    leaves = [_t(adj).requires_grad_(), _t(x).requires_grad_()]
    out = sp.block_spmm(*leaves, rows, cols, block)
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    # only one input needing a gradient
    x_only = _t(x).requires_grad_()
    (dx,) = torch.autograd.grad(sp.block_spmm(_t(adj), x_only, rows, cols,
                                              block), [x_only], _t(g))
    _close(dx, want[1], 1e-4)


@pytest.mark.parametrize("mask", sorted(MASKS_256))
def test_block_sddmm_spmm_gradients_match_jax(mask):
    rng = np.random.RandomState(1)
    n, v, r, c, block = 2, 256, 3, 8, 128
    rows, cols = jsp.active_blocks(MASKS_256[mask])
    arrs = [rng.randn(n, v, r), rng.randn(n, v, r), rng.randn(r),
            rng.randn(n, v, c)]
    g = rng.randn(n, v, c)

    def f(q, k, w, x):
        return jsp.block_sddmm_spmm(q, k, w, x, rows, cols, block)

    _, vjp = jax.vjp(f, *map(_j, arrs))
    want = vjp(_j(g))
    leaves = [_t(a).requires_grad_() for a in arrs]
    out = sp.block_sddmm_spmm(*leaves, rows, cols, block)
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-4)


def test_autograd_path_equals_the_forward_path():
    d = _case(3)
    plain = sp.block_sddmm_spmm(*(_t(d[key]) for key in "qkwx"), d["rows"],
                                d["cols"], d["block"])
    leaves = [_t(d[key]).requires_grad_() for key in "qkwx"]
    out = sp.block_sddmm_spmm(*leaves, d["rows"], d["cols"], d["block"])
    assert out.requires_grad and torch.equal(out.detach(), plain)
    adj = _t(d["adj"]).requires_grad_()
    out = sp.block_spmm(adj, _t(d["x"]), d["rows"], d["cols"], d["block"])
    assert torch.equal(out.detach(), sp.block_spmm(
        _t(d["adj"]), _t(d["x"]), d["rows"], d["cols"], d["block"]))


def test_cpu_calls_launch_no_kernel():
    sp.reset_launch_counts()
    d = _case(4)
    sp.block_spmm(_t(d["adj"]), _t(d["x"]), d["rows"], d["cols"], 8)
    sp.block_sddmm(_t(d["q"]), _t(d["k"]), _t(d["w"]), d["rows"], d["cols"],
                   8)
    sp.block_sddmm_spmm(*(_t(d[key]) for key in "qkwx"), d["rows"],
                        d["cols"], 8)
    assert sp.launch_counts() == dict(block_spmm=0, block_sddmm=0,
                                      block_sddmm_spmm=0)
    assert sp.available() == torch.cuda.is_available()


def _bad_patterns():
    rows, cols = jsp.active_blocks(np.random.RandomState(0).rand(4, 4) < 0.4)
    order = np.argsort(-rows, kind="stable")
    keep = rows != 2
    return {
        "unsorted": (rows[order], cols[order], 8, "sorted"),
        "row missing": (rows[keep], cols[keep], 8, "no active block"),
        "V not a multiple of block": (rows, cols, 12, "multiples of"),
        "duplicate block": (np.append(rows, 3), np.append(cols, cols[-1]), 8,
                            "twice"),
        "column out of range": (rows, np.where(cols == cols.max(), 4, cols),
                                8, "out of range"),
        "length mismatch": (rows, cols[:-1], 8, "equal-length"),
    }


@pytest.mark.parametrize("case", sorted(_bad_patterns()))
def test_ops_refuse_a_bad_pattern(case):
    rows, cols, block, match = _bad_patterns()[case]
    d = _case(0)
    calls = (
        lambda: sp.block_spmm(_t(d["adj"]), _t(d["x"]), rows, cols, block),
        lambda: sp.block_sddmm(_t(d["q"]), _t(d["k"]), _t(d["w"]), rows,
                               cols, block),
        lambda: sp.block_sddmm_spmm(*(_t(d[key]) for key in "qkwx"), rows,
                                    cols, block))
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


def test_block_sddmm_has_no_gradient():
    d = _case(0)
    q = _t(d["q"]).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        sp.block_sddmm(q, _t(d["k"]), _t(d["w"]), d["rows"], d["cols"], 8)
    with torch.no_grad():
        out = sp.block_sddmm(q, _t(d["k"]), _t(d["w"]), d["rows"], d["cols"],
                             8)
    assert not out.requires_grad


def test_ops_refuse_mismatched_shapes():
    d = _case(0)
    with pytest.raises(ValueError):
        sp.block_spmm(_t(d["adj"]), _t(d["x"])[:, :16], d["rows"], d["cols"],
                      8)
    with pytest.raises(ValueError):
        sp.block_sddmm(_t(d["q"]), _t(d["k"])[..., :3], _t(d["w"]),
                       d["rows"], d["cols"], 8)
    with pytest.raises(ValueError):
        sp.block_sddmm_spmm(_t(d["q"]), _t(d["k"]), _t(d["w"]),
                            _t(d["x"])[:, :16], d["rows"], d["cols"], 8)
