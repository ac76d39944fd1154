"""The port's numpy data helpers on the CPU, against the JAX package.

* kinematics: every rotation conversion, ``forward_kinematics`` and
  ``expmap_to_xyz`` for both skeletons, byte-equal (``np.array_equal``,
  same dtype) to ``dstdgcn_tpu.data.kinematics``;
* the native CSV reader: byte-equal to the JAX package's, within 1e-5 of
  ``np.loadtxt``, None for a ragged file (which ``read_csv_floats`` then
  reads with ``np.loadtxt``), and a failed build raises;
* the scale normalizers on numpy arrays and torch tensors against the JAX
  classes (1e-6), their statistics cast once per device and dtype;
* ``pose_norm``'s eight functions against the JAX module (1e-6 relative).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.data import kinematics as jkin
from dstdgcn_tpu.data import native as jnative
from dstdgcn_tpu.data import pose_norm as jpn
from dstdgcn_tpu.data import transforms as jtfm
from dstdgcn_tpu_torch.data import datasets, kinematics, native, pose_norm
from dstdgcn_tpu_torch.data import transforms as tfm


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _expmap(rng, *shape):
    return (rng.randn(*shape) * 0.8).astype(np.float32)


def test_rotation_conversions_are_byte_equal():
    rng = np.random.RandomState(0)
    r = _expmap(rng, 64, 3)
    r[0] = 0.0                                  # the epsilon-guarded axis
    rm = kinematics.expmap_to_rotmat(r)
    _same(rm, jkin.expmap_to_rotmat(r))
    _same(kinematics.rotmat_to_quat(rm), jkin.rotmat_to_quat(rm))
    q = kinematics.expmap_to_quat(r)
    _same(q, jkin.expmap_to_quat(r))
    _same(kinematics.quat_to_expmap(q), jkin.quat_to_expmap(q))
    _same(kinematics.rotmat_to_euler(rm), jkin.rotmat_to_euler(rm))
    # the gimbal branches of rotmat_to_euler (r02 = +-1)
    gimbal = np.zeros((2, 3, 3), np.float32)
    gimbal[0, 0, 2], gimbal[1, 0, 2] = 1.0, -1.0
    gimbal[:, 1, 1] = gimbal[:, 2, 0] = 1.0
    _same(kinematics.rotmat_to_euler(gimbal), jkin.rotmat_to_euler(gimbal))


@pytest.mark.parametrize("layout,channels", [("h36m", 99), ("cmu", 117)])
def test_forward_kinematics_is_byte_equal(layout, channels):
    rng = np.random.RandomState(1)
    angles = _expmap(rng, 40, channels)
    angles[:, :6] = 0.0
    skel = getattr(kinematics, f"{layout}_skeleton")()
    jskel = getattr(jkin, f"{layout}_skeleton")()
    for got, want in zip(skel, jskel):
        if isinstance(got, tuple):
            for a, b in zip(got, want):
                _same(a, b)
        else:
            _same(got, want)
    _same(kinematics.forward_kinematics(angles, skel),
          jkin.forward_kinematics(angles, jskel))
    xyz = kinematics.expmap_to_xyz(angles, layout)
    _same(xyz, jkin.expmap_to_xyz(angles, layout))
    assert xyz.shape == (40, len(skel.parents), 3)


def _write(path, arr, fmt="%.6f"):
    np.savetxt(path, arr, delimiter=",", fmt=fmt)
    return str(path)


def test_native_reader_matches_jax_and_loadtxt(tmp_path):
    rng = np.random.RandomState(2)
    for i, shape in enumerate([(120, 99), (7, 117), (1, 5)]):
        path = _write(tmp_path / f"m{i}.txt", 0.3 * rng.randn(*shape))
        got = native.fast_read_csv(path)
        _same(got, jnative.fast_read_csv(path))
        want = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # CRLF line ends and spaces after the commas
    crlf = tmp_path / "crlf.txt"
    crlf.write_bytes(b"1.5, -2.25,3\r\n4,5e-3, 6\r\n")
    _same(native.fast_read_csv(str(crlf)),
          np.array([[1.5, -2.25, 3], [4, 5e-3, 6]], np.float32))


def test_ragged_file_goes_to_loadtxt(tmp_path):
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1,2,3\n4,5\n")
    assert native.fast_read_csv(str(ragged)) is None
    assert jnative.fast_read_csv(str(ragged)) is None
    datasets.reset_reader_counts()
    good = _write(tmp_path / "good.txt", np.arange(6.0).reshape(2, 3))
    _same(datasets.read_csv_floats(good), np.arange(6, dtype=np.float32)
          .reshape(2, 3))
    assert datasets.reader_counts() == {"native": 1, "loadtxt": 0}
    with pytest.raises(ValueError):   # np.loadtxt refuses it in turn
        datasets.read_csv_floats(str(ragged))
    assert datasets.reader_counts() == {"native": 1, "loadtxt": 1}
    assert native.fast_read_csv(str(tmp_path / "missing.txt")) is None


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    assert os.path.isfile(native.SOURCE)


@pytest.mark.parametrize("kind", ["meanstd", "minmax"])
def test_scale_norms_match_jax(kind):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 9) * 50 + 10).astype(np.float32)
    flat = x.reshape(-1, 9)
    if kind == "meanstd":
        args = (flat.mean(0), flat.std(0))
        norm, jnorm = tfm.MeanStdNorm(*args), jtfm.MeanStdNorm(*args)
    else:
        args = (flat.min(0), flat.max(0))
        norm, jnorm = tfm.MinMaxNorm(*args), jtfm.MinMaxNorm(*args)
    y = norm.transform(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    np.testing.assert_allclose(y, jnorm.transform(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(norm.inverse(y), jnorm.inverse(y), rtol=1e-6,
                               atol=1e-6)
    jy = np.asarray(jnorm.transform(jnp.asarray(x)))
    t = norm.transform(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), jy, rtol=1e-6, atol=1e-6)
    back = norm.inverse(t)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jnorm.inverse(jnp.asarray(jy))), rtol=1e-6,
        atol=1e-4)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-3)
    # the statistics become tensors once per (device, dtype)
    cached = dict(norm._tensors)
    assert list(cached) == [(torch.device("cpu"), torch.float32)]
    norm.inverse(t)
    assert all(a is b for a, b in zip(norm._tensors[list(cached)[0]],
                                      cached[list(cached)[0]]))
    norm.transform(torch.from_numpy(x).double())
    assert len(norm._tensors) == 2


def _poses(rng, *shape):
    return (rng.randn(*shape) * 300).astype(np.float64)


def test_pose_norm_matches_jax():
    rng = np.random.RandomState(4)
    assert sorted(pose_norm.__all__) == sorted(jpn.__all__)
    assert len(pose_norm.__all__) == 8
    p0, p1, p2 = (_poses(rng, 5, 3) for _ in range(3))
    seq_expi = _poses(rng, 6, 108)
    seq_ntu = _poses(rng, 6, 150)
    cases = [
        ("rigid_frame_matrix", (p0, p1, p2)),
        ("rigid_frame_normalize", (_poses(rng, 5, 18, 3), (0, 3, 7))),
        ("normalize_expi_2p", (seq_expi,)),
        ("normalize_expi_independent", (_poses(rng, 2, 5, 18, 3),)),
        ("normalize_expi_independent", (_poses(rng, 2, 5, 36, 3),)),
        ("normalize_ntu", (seq_ntu,)),
        ("normalize_ntu_independent", (_poses(rng, 2, 5, 25, 3),)),
        ("normalize_ntu_independent", (_poses(rng, 2, 5, 50, 3),)),
        ("ntu_pelvis_center", (seq_ntu,)),
    ]
    zeros = seq_ntu.copy()
    zeros[[1, 4]] = 0.0
    cases.append(("filter_zero_frames", (zeros,)))
    for name, args in cases:
        got = getattr(pose_norm, name)(*args)
        want = getattr(jpn, name)(*args)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    assert pose_norm.filter_zero_frames(zeros).shape == (4, 150)
    with pytest.raises(ValueError, match="18 or 36"):
        pose_norm.normalize_expi_independent(_poses(rng, 1, 2, 20, 3))
    with pytest.raises(ValueError, match="25 or 50"):
        pose_norm.normalize_ntu_independent(_poses(rng, 1, 2, 20, 3))
