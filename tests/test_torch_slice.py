"""The port's serving slice end to end on the CPU, against the JAX package.

The same ``Synthetic`` test data and bridged weights go through the JAX
``PredictionEngine.test`` and the port's; the per-frame MPJPE agrees to
1e-4.  Also: the data layer matches byte for byte, the CLI writes
``testing_loss.csv`` in ``--device cpu`` mode, entry points refuse a
missing CUDA device, and the slice config's YAML and dict forms agree.
"""

import copy
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.data import Loader as JaxLoader
from dstdgcn_tpu.data import datasets as jdatasets
from dstdgcn_tpu.data import transforms as jtfm
from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic, get_dataset
from dstdgcn_tpu_torch.data import transforms as tfm
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.utils.bridge import load_flax_variables
from dstdgcn_tpu_torch.utils.config import get_config, resolve

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "dstdgcn_tpu_torch", "configs",
                    "synthetic_h36m_serving.yaml")


def _small_config(run_dir):
    """The slice config cut to CPU size: 8 features, 1 encoder layer,
    16 sequences of T = 10 + 25 frames."""
    cfg = configs.synthetic_h36m_serving()
    cfg["dataset"]["test"]["synthetic"]["num_sequences"] = 16
    cfg["test_batch_size"] = 8
    cfg["model"]["dstdgcn"].update(num_feature=8, num_layers=1)
    cfg["save"]["path"]["base"] = str(run_dir)
    return cfg


def test_synthetic_data_matches_jax_byte_for_byte():
    kw = dict(layout="h36m", num_sequences=12, input_n=10, output_n=25,
              mode="test", mirror=True)
    got, want = Synthetic(**kw), jdatasets.Synthetic(**kw)
    for a, b in zip(got.arrays(), want.arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(got.joint_weight_use, want.joint_weight_use)
    batches = list(Loader(got.arrays(), 5, shuffle=True))
    jbatches = list(JaxLoader(want.arrays(), 5, shuffle=True))
    assert len(batches) == len(jbatches) == 5
    for b, jb in zip(batches, jbatches):
        for x, y in zip(b, jb):
            np.testing.assert_array_equal(x, np.asarray(y))
    # the factories serve the real datasets and refuse an unknown name
    from dstdgcn_tpu_torch.data import datasets as tdatasets
    from dstdgcn_tpu_torch.runner import _RUNNERS, get_runner
    assert {k: tdatasets._DATASETS[k] for k in ("h36m", "cmu", "3dpw")} == {
        "h36m": tdatasets.Human36M, "cmu": tdatasets.CMUMocap,
        "3dpw": tdatasets.PW3D}
    assert {"h36m", "cmu", "3dpw"} <= set(_RUNNERS)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("ntu", ntu={})
    with pytest.raises(ValueError, match="unknown runner"):
        get_runner("ntu", {})


@pytest.mark.parametrize("name", ["tsc", "st", "cst", "tscr_h36m", "no"])
def test_transforms_match_jax(name):
    x = np.random.RandomState(0).randn(2, 5, 66).astype(np.float32)
    fwd, inv = tfm.get_transform(name)
    jfwd, jinv = jtfm.get_transform(name)
    if fwd is None:
        assert jfwd is None and inv is None
        return
    y = fwd(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jfwd(jnp.asarray(x))))
    np.testing.assert_array_equal(inv(y).numpy(), x)


def test_time_transform_and_padding_match_jax():
    x = np.random.RandomState(1).randn(2, 12, 9).astype(np.float32)
    tt, jtt = tfm.TimeTransform(12, 6), jtfm.TimeTransform(12, 6)
    np.testing.assert_allclose(tt.transform(torch.from_numpy(x)).numpy(),
                               np.asarray(jtt.transform(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tt.inverse(x[:, :6]),
                                  jtt.inverse(x[:, :6]))
    for pad in (True, False):
        for a, b in zip(tfm.padding_indices(10, 25, pad),
                        jtfm.padding_indices(10, 25, pad)):
            np.testing.assert_array_equal(a, b)


def test_slice_mpjpe_matches_jax_engine(tmp_path):
    cfg = resolve(_small_config(tmp_path))
    mcfg = cfg["model"]
    setting = cfg["setting"]
    ds_kw = dict(cfg["dataset"]["test"]["synthetic"])
    jds = jdatasets.Synthetic(**ds_kw)
    ds = Synthetic(**ds_kw)
    args = (setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(setting["joint_to_ignore"]),
            np.array(setting["joint_to_equal"]), None, None, "all")

    jmodel = jax_get_model("dstdgcn", **{k: v for k, v in mcfg.items()
                                         if k != "name"})
    jeng = JaxEngine(cfg["engine"], jmodel)
    state = jeng.init(jds.input_seqs[:1])
    # move the gates and biases that init at zero so the dynamic
    # adjacency takes part (alpha = 0 would hide it)
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), state.params)
    jeng.state = state.replace(params=jax.tree.map(jnp.asarray, params))
    want_avg, want = jeng.test(JaxLoader(jds.arrays(), 8), *args)

    model = get_model("dstdgcn", **{k: v for k, v in mcfg.items()
                                    if k != "name"})
    eng = PredictionEngine(cfg["engine"], model, device="cpu")
    eng.init()
    load_flax_variables(model, {"params": params,
                                "batch_stats": jax.tree.map(
                                    np.asarray, state.batch_stats)})
    tfused.reset_launch_counts()
    got_avg, got = eng.test(Loader(ds.arrays(), 8), *args)
    assert np.all(np.isfinite(got)) and got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got_avg == pytest.approx(want_avg, rel=1e-4)
    assert len(eng.test_batch_seconds) == 2
    assert tfused.launch_counts() == {
        "dstd_spatial": 0, "dstd_temporal": 0, "dstd_spatial_bwd": 0,
        "dstd_temporal_bwd": 0, "dstd_chain": 0, "dstd_encoder_chain": 0,
        "dstd_spatial_bf16": 0, "dstd_temporal_bf16": 0,
        "dstd_spatial_bwd_bf16": 0, "dstd_temporal_bwd_bf16": 0,
        "dstd_chain_bf16": 0, "dstd_encoder_chain_bf16": 0}


def test_run_writes_testing_loss_csv(tmp_path):
    runner, (avg, per_frame) = run(_small_config(tmp_path), "cpu")
    assert runner.engine.device.type == "cpu"
    with open(tmp_path / "testing_loss.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["test_loss", "3d80", "3d160", "3d320", "3d400",
                       "3d560", "3d720", "3d880", "3d1000"]
    np.testing.assert_allclose([float(v) for v in rows[1]],
                               [avg] + list(per_frame))
    assert np.all(np.isfinite(per_frame))


def test_cli_cpu_mode_writes_testing_loss_csv(tmp_path):
    import yaml
    cfg = _small_config(tmp_path / "unused")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dstdgcn_tpu_torch.main", "--run_dir",
         str(tmp_path / "run"), "--config", str(path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "run" / "testing_loss.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and len(rows[1]) == 9
    assert all(np.isfinite(float(v)) for v in rows[1])


def test_entry_points_refuse_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run(_small_config(tmp_path), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PredictionEngine(configs.synthetic_h36m_serving()["engine"],
                         get_model("dstdgcn", dstdgcn={"num_feature": 8}))


def test_unported_modes_raise(tmp_path):
    """What the port refused before its engine slice now runs:
    engine.solver and engine.callbacks train and write the callback CSV,
    and a checkpoint of the JAX engine loads in test and train mode."""
    cfg = _small_config(tmp_path)
    cfg["dataset"]["train"]["synthetic"]["num_sequences"] = 16
    cfg["train_batch_size"] = 8
    trained = copy.deepcopy(cfg)
    trained.update(mode="train", epoch=1)
    trained["engine"].update(
        solver={"optimizer_name": "adam", "bias_lr_factor": 2.0},
        callbacks={"name": "train"})
    trained["save"]["path"]["base"] = str(tmp_path / "solver")
    runner, history = run(trained, "cpu")
    assert [g["label"] for g in runner.engine.optimizer.param_groups] == [
        "base", "bias"]
    with open(tmp_path / "solver" / "train_loss.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "joint", "total"] and len(rows) == 2
    # a msgpack checkpoint written by the JAX engine loads
    from dstdgcn_tpu.engine.checkpoint import save_checkpoint
    mcfg = resolve(cfg)["model"]
    jeng = JaxEngine(cfg["engine"], jax_get_model(
        "dstdgcn", **{k: v for k, v in mcfg.items() if k != "name"}))
    jds = jdatasets.Synthetic(**cfg["dataset"]["test"]["synthetic"])
    state = jeng.init(jds.input_seqs[:1])
    ckpt = tmp_path / "jax.ckpt"
    save_checkpoint(str(ckpt), state, dict(lr=3e-3, err=1.0, epoch=0))
    cfg["model"].update(load=True, ckpt=str(ckpt))
    runner, _ = run(copy.deepcopy(cfg), "cpu")
    kernel = state.params["conv_st_in"]["block"]["spatial"]["wf"]
    np.testing.assert_array_equal(
        runner.engine.model.conv_st_in.block.spatial.wf.detach().numpy(),
        np.asarray(kernel))
    assert os.path.isfile(tmp_path / "testing_loss.csv")
    cfg.update(mode="train", epoch=2)
    runner, history = run(cfg, "cpu")
    # from the payload's epoch 0, as the JAX runner resumes
    assert [row[0] for row in history] == [1, 2]


def test_slice_config_yaml_equals_dict():
    import yaml
    with open(YAML) as f:
        raw = yaml.safe_load(f)
    assert raw == configs.SYNTHETIC_H36M_SERVING
    cfg = get_config(YAML)
    assert cfg["setting"]["dim_used"] == resolve(
        configs.SYNTHETIC_H36M_SERVING)["setting"]["dim_used"]
    assert len(cfg["setting"]["dim_used"]) == 66
    # full width: the model block of configs/dstdgcn_h36m.yaml
    with open(os.path.join(REPO, "configs", "dstdgcn_h36m.yaml")) as f:
        h36m = yaml.safe_load(f)
    model = dict(raw["model"]["dstdgcn"])
    assert model.pop("compute_dtype") is None
    assert model == h36m["model"]["dstdgcn"]
    assert raw["model"]["use_pallas"] == "serving"
    assert raw["setting"] == h36m["setting"]
