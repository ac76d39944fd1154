"""The numerics of the float32 kernels' tensor-core products
(``dstdgcn_tpu_torch/csrc/dstd_mma.cuh::Tf32x3Mma``: the backward kernels
and the float32 encoder), emulated in numpy.

A TF32 operand keeps 10 mantissa bits.  3xTF32 splits each operand x into
big = tf32(x), rounded to nearest with ties away from zero (the rounding
of ``cvt.rna.tf32.f32``), and small = x - big, which the tensor core reads
as TF32 by ignoring its low 13 bits (round toward zero); it sums small_a
big_b + big_a small_b + big_a big_b in float32.  At the backward's
contraction depths (REF = 22 output joints for ds, Co = 64 channels for dA
and dx, P^2 = 1225 frame pairs for dwrm) its error stays within a small
factor of float32's own distance from float64, while a single TF32 pass
lies beyond the 1e-4 of max(|g|, 1) that the float32 kernels are held to.
That is why the float32 kernels use three passes and not one.  The
forward's depths: K V = 44 (the spatial aggregation, two 22-deep sums
into one accumulator; the encoder's temporal mixing R V over the 22 H36M
joints), Ci = 64 (the feature projection), R T = 70 (the spatial mixing),
T = 35 and 40 (sums over the frames of the card tests' sequences: the
encoder's temporal aggregation, the temporal backward's dA and dxf) and
R V = 50 (the temporal mixing over the 25 CMU joints).
"""

import numpy as np
import pytest

#: the float32 kernels' bound against their plain versions
#: (tests/test_torch_cuda.py, chip_smoke.py ``TOL``)
F32_TOL = 1e-4
#: 3xTF32 against float32's own distance to float64: measured 0.76x,
#: 0.39x, 1.02x, 0.81x, 0.69x, 0.42x, 0.77x and 0.69x at depths 22, 35,
#: 40, 44, 50, 64, 70 and 1225 (fewer float32 roundings, one per step of 8
#: and pass, than the CUDA cores' sequential sum)
X3_FACTOR = 2.0
DEPTHS = (22, 35, 40, 44, 50, 64, 70, 1225)


def tf32(x):
    """x (float32) rounded to TF32: nearest, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_rz(x):
    """x (float32) as the tensor core reads it as TF32: its low 13 bits
    ignored."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _steps(terms):
    """The tensor cores' sum over the last axis of each (rows, depth) term
    array: per m16n8k8 step of 8 depths, one mma.sync a term in the given
    order, each adding its 8 products to the float32 accumulator (modelled
    as summed exactly, rounded once)."""
    acc = np.zeros(terms[0].shape[0], np.float32)
    for k0 in range(0, terms[0].shape[1], 8):
        for term in terms:
            step = term[:, k0:k0 + 8].astype(np.float64).sum(1)
            acc = (acc + step).astype(np.float32)
    return acc


def dot_3xtf32(a, b):
    """In the order of dstd_mma.cuh: the small terms first, then the big."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32_rz(a - a_big), tf32_rz(b - b_big)
    return _steps([a_small * b_big, a_big * b_small, a_big * b_big])


def dot_tf32(a, b):
    return _steps([tf32(a) * tf32(b)])


def dot_f32(a, b):
    """A sequential float32 sum of fused multiply-adds, as on the CUDA
    cores."""
    acc = np.zeros(a.shape[0], np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64) + a[:, k].astype(np.float64)
               * b[:, k]).astype(np.float32)
    return acc


def _case(depth):
    """512 seeded dot products of the depth, and their float64 values and
    the norm max(max |float64|, 1)."""
    rng = np.random.RandomState(depth)
    a = rng.randn(512, depth).astype(np.float32)
    b = rng.randn(512, depth).astype(np.float32)
    exact = (a.astype(np.float64) * b.astype(np.float64)).sum(1)
    return a, b, exact, max(float(np.abs(exact).max()), 1.0)


def _err(got, exact, norm):
    return float(np.abs(got.astype(np.float64) - exact).max()) / norm


def test_tf32_rounds_to_nearest_ties_away_keeping_10_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert tf32(np.float32(1 + 2 ** -11)) == one + ulp      # tie: away
    assert tf32(np.float32(-(1 + 2 ** -11))) == -(one + ulp)
    assert tf32(np.float32(1 + 2 ** -12)) == one             # below: down
    assert tf32(np.float32(1 + 3 * 2 ** -12)) == one + ulp   # above: up
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert (tf32(x).view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    assert (tf32_rz(x).view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    assert tf32_rz(np.float32(1 + 3 * 2 ** -12)) == one      # toward zero
    big = tf32(x)
    # big + small as the tensor core reads them lies within 2^-21 of x
    rest = x.astype(np.float64) - big - tf32_rz(x - big)
    assert (np.abs(rest) <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("depth", DEPTHS)
def test_3xtf32_dot_is_float32_accurate(depth):
    a, b, exact, norm = _case(depth)
    err3 = _err(dot_3xtf32(a, b), exact, norm)
    err32 = _err(dot_f32(a, b), exact, norm)
    assert err3 <= X3_FACTOR * err32, (err3, err32)
    assert err3 < F32_TOL / 10


@pytest.mark.parametrize("depth", DEPTHS)
def test_one_tf32_pass_lies_beyond_the_float32_bound(depth):
    a, b, exact, norm = _case(depth)
    err1 = _err(dot_tf32(a, b), exact, norm)
    # measured 2.1e-4 to 3.3e-4 of the norm, 2-3x the bound
    assert err1 > 2 * F32_TOL, err1
