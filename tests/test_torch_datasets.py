"""The port's real-dataset loaders and datasets on the CPU, against the JAX
package.

Small seeded trees in each dataset's own format, written by
``chip_smoke.py``'s writers (expmap CSVs of 99 and 117 channels, pickled
``jointPositions``), go through both packages; every array is byte-equal
(``np.array_equal``, same dtype):

* ``load_h36m_3d`` in modes ``8``, ``256`` and ``all``; ``load_h36m_angles``
  on the train and SRNN paths; ``load_cmu_angles`` on the train and
  ``is_test`` paths (the latter with the train statistics); ``load_cmu_3d``
  in modes ``all`` and ``8``;
* ``Human36M`` with ``mirror``, with ``scale: True`` and with ``data_3d:
  False``, ``CMUMocap`` and ``PW3D``: the four arrays of ``arrays()``,
  ``joint_weight_use``, ``dim_used`` and the scaler's statistics;
* ``define_actions`` (the ExPI splits and ``amass`` too) and
  ``find_indices_srnn``;
* the factories serve ``h36m``, ``cmu`` and ``3dpw`` and refuse an unknown
  name.
"""

import os

import numpy as np
import pytest

import chip_smoke as cs
from dstdgcn_tpu.data import datasets as jds
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import datasets as tds
from dstdgcn_tpu_torch.data import get_dataset
from dstdgcn_tpu_torch.runner import get_runner

ACTS = ["walking", "eating"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    h36m = cs.write_h36m_tree(str(root / "h36m"), seed=1, actions=ACTS,
                              subjects=(1, 5, 6), frames=120,
                              test_frames=400)
    cmu = cs.write_cmu_tree(str(root / "cmu"), seed=2, actions=["walking",
                                                                "soccer"],
                            files=(2, 1), frames=(200, 180))
    pw3d = cs.write_pw3d_tree(str(root / "3dpw"), seed=3, files=(2, 1),
                              frames=(70, 60))
    return dict(h36m=h36m, cmu=cmu, pw3d=pw3d)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _all_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(np.asarray(a), b)


def test_trees_read_the_same_in_both_packages(trees):
    h = trees["h36m"]
    assert sorted(os.listdir(h)) == ["S1", "S5", "S6"]
    assert sorted(os.listdir(os.path.join(h, "S5"))) == [
        "eating_1.txt", "eating_2.txt", "walking_1.txt", "walking_2.txt"]
    tds.reset_reader_counts()
    seq = tds.read_csv_floats(os.path.join(h, "S5", "walking_1.txt"))
    _same(seq, jds.read_csv_floats(os.path.join(h, "S5", "walking_1.txt")))
    assert seq.shape == (400, 99)
    assert tds.reader_counts() == {"native": 1, "loadtxt": 0}
    train, test = trees["cmu"]
    assert sorted(os.listdir(train)) == ["soccer", "walking"]
    assert sorted(os.listdir(os.path.join(test, "walking"))) == [
        "walking_1.txt"]
    tr, te = trees["pw3d"]
    assert sorted(os.listdir(tr)) == ["seq_1.pkl", "seq_2.pkl"]
    assert len(jds.PW3D(te, input_n=10, output_n=30)) == len(
        tds.PW3D(te, input_n=10, output_n=30)) == 2 * (60 - 40 + 1)


@pytest.mark.parametrize("mode", ["8", "256", "all"])
def test_load_h36m_3d_is_byte_equal(trees, mode):
    args = (trees["h36m"], [1, 5], ACTS, 2, 35, mode)
    got = tds.load_h36m_3d(*args)
    _all_same(got, jds.load_h36m_3d(*args))
    assert got[0].shape[1:] == (35, 96) and len(got[2]) == 66


@pytest.mark.parametrize("subjects,mode", [([1, 6], "all"), ([5], "8"),
                                           ([5], "256")])
def test_load_h36m_angles_is_byte_equal(trees, subjects, mode):
    args = (trees["h36m"], subjects, ACTS, 2, 20)
    got = tds.load_h36m_angles(*args, input_n=10, test_mode=mode)
    _all_same(got, jds.load_h36m_angles(*args, input_n=10, test_mode=mode))
    assert got[0].shape[2] == 99


def test_load_cmu_angles_is_byte_equal(trees):
    train, test = trees["cmu"]
    got = tds.load_cmu_angles(train, ["walking", "soccer"], 10, 25)
    _all_same(got, jds.load_cmu_angles(train, ["walking", "soccer"], 10,
                                       25))
    _, _, _, mean, std = got
    std = std.copy()
    std[:5] = 1e-5          # channels below the threshold at test time
    kw = dict(data_std=std, data_mean=mean, is_test=True)
    got = tds.load_cmu_angles(test, ["walking", "soccer"], 10, 25, **kw)
    _all_same(got, jds.load_cmu_angles(test, ["walking", "soccer"], 10, 25,
                                       **kw))
    assert got[0].shape == (16, 35, 117)
    assert set(got[1]) >= set(range(5))


@pytest.mark.parametrize("mode", ["all", "8"])
def test_load_cmu_3d_is_byte_equal(trees, mode):
    train, _ = trees["cmu"]
    args = (train, ["walking", "soccer"], 2, 10, 25, mode)
    got = tds.load_cmu_3d(*args)
    _all_same(got, jds.load_cmu_3d(*args))
    assert got[0].shape[1:] == (35, 114) and len(got[2]) == 75


def _dataset_same(got, want, scaled=False):
    _all_same(got.arrays(), want.arrays())
    _same(got.joint_weight_use, want.joint_weight_use)
    _same(got.joint_weight_all, want.joint_weight_all)
    _same(got.dim_used, want.dim_used)
    assert (got.scale_tsfm is None) == (want.scale_tsfm is None) \
        == (not scaled)
    if scaled:
        _same(got.scale_tsfm.mean, want.scale_tsfm.mean)
        _same(got.scale_tsfm.std, want.scale_tsfm.std)
    assert got.time_tsfm is None and want.time_tsfm is None


@pytest.mark.parametrize("opts", [
    dict(mode="train", mirror=True),
    dict(mode="train", scale=True),
    dict(mode="test", test_mode="8"),
    dict(mode="train", data_3d=False, mirror=True),
], ids=["mirror", "scale", "srnn8", "angles"])
def test_human36m_is_byte_equal(trees, opts):
    kw = dict(data_path=trees["h36m"], actions="walking", input_n=10,
              output_n=25, dct_used=0, sample_rate=2, **opts)
    if kw["mode"] == "train":
        kw["mode"] = "debug"     # subject 1 alone: the tree has no S7-S9
    got, want = tds.Human36M(**kw), jds.Human36M(**kw)
    _dataset_same(got, want, scaled=opts.get("scale", False))
    if opts.get("data_3d") is False:
        _same(got.angle_mean, want.angle_mean)
        _same(got.angle_std, want.angle_std)
        assert got.all_seqs.shape[2] == 99
    if opts.get("mirror") and opts.get("data_3d") is not False:
        assert len(got) == 2 * 2 * (60 - 35 + 1)
    # a test split scaled by the train split's scaler
    if opts.get("scale"):
        test = dict(kw, mode="test", test_mode="all", scaler=got.scale_tsfm)
        jtest = dict(test, scaler=want.scale_tsfm)
        _dataset_same(tds.Human36M(**test), jds.Human36M(**jtest), True)


@pytest.mark.parametrize("opts", [dict(mirror=True), dict(test_mode="8"),
                                  dict(scale=True)],
                         ids=["mirror", "srnn8", "scale"])
def test_cmu_mocap_is_byte_equal(trees, opts):
    train, _ = trees["cmu"]
    kw = dict(data_path=train, actions="soccer" if "mirror" in opts
              else "walking", input_n=10, output_n=25, dct_used=0,
              sample_rate=2, **opts)
    _dataset_same(tds.CMUMocap(**kw), jds.CMUMocap(**kw),
                  scaled=opts.get("scale", False))


@pytest.mark.parametrize("mirror", [False, True])
def test_pw3d_is_byte_equal(trees, mirror):
    train, _ = trees["pw3d"]
    kw = dict(data_path=train, input_n=10, output_n=30, dct_used=0,
              mirror=mirror)
    got = tds.PW3D(**kw)
    _dataset_same(got, jds.PW3D(**kw))
    assert got.all_seqs.shape == ((2 if mirror else 1) * 2 * 2 * 31, 40,
                                  72)
    np.testing.assert_allclose(got.all_seqs[:, :, :3], 0, atol=1e-4)


def test_define_actions_and_srnn_indices_match_jax():
    for dataset, names in (("h36m", ["all", "debug", "walking",
                                     "walkingtogether"]),
                           ("cmu", ["all", "debug", "soccer"]),
                           ("expi", list(tds.EXPI_SPLITS) + ["nope"]),
                           ("amass", ["all"])):
        for name in names:
            assert tds.define_actions(name, dataset) == jds.define_actions(
                name, dataset)
    assert tds.EXPI_SPLITS == jds.EXPI_SPLITS
    assert tds.H36M_ACTIONS == jds.H36M_ACTIONS
    assert tds.CMU_ACTIONS == jds.CMU_ACTIONS
    for bad in (("jumping", "h36m"), ("walkingdog", "cmu")):
        with pytest.raises(ValueError):
            tds.define_actions(*bad)
    for args in ((400, 380, 35), (200, 300, 20, 10, 128), (180, 170, 15, 5)):
        _all_same(tds.find_indices_srnn(*args), jds.find_indices_srnn(*args))
    seq = np.arange(40.0).reshape(20, 2)
    _same(tds.sliding_windows(seq, 5), jds.sliding_windows(seq, 5))
    _same(tds.sliding_windows(seq, 25), jds.sliding_windows(seq, 25))


def test_factories_serve_the_real_datasets(trees, tmp_path):
    ds = get_dataset("h36m", h36m=dict(data_path=trees["h36m"],
                                       actions="walking", mode="debug",
                                       input_n=10, output_n=25, dct_used=0))
    assert isinstance(ds, tds.Human36M)
    assert isinstance(get_dataset("cmu", cmu=dict(
        data_path=trees["cmu"][0], actions="walking", input_n=10,
        output_n=25, dct_used=0)), tds.CMUMocap)
    assert isinstance(get_dataset("3dpw", **{"3dpw": dict(
        data_path=trees["pw3d"][0], input_n=10, output_n=30)}), tds.PW3D)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("ntu", ntu={})
    from dstdgcn_tpu_torch.runner import (CMURunner, H36MRunner,
                                          PW3DRunner)
    from dstdgcn_tpu_torch.utils.logging import setup_logger
    for name, cls in (("h36m", H36MRunner), ("cmu", CMURunner),
                      ("3dpw", PW3DRunner)):
        cfg = getattr(configs, f"real_{name}_train")()
        cfg["mode"] = "visualize"     # builds no model
        cfg["save"]["path"]["base"] = str(tmp_path / name)
        cfg["logger"] = setup_logger(f"factory_{name}", str(tmp_path))
        assert type(get_runner(name, cfg, device="cpu")) is cls
    with pytest.raises(ValueError, match="unknown runner"):
        get_runner("ntu", cfg, device="cpu")
