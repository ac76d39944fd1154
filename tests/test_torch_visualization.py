"""The port's visualization (``utils/visualization.py``) and the runners'
visualize mode on the CPU, against the JAX package.

* ``Visualizer.plot_single``, ``plot_multi`` and ``plot_expmap_multi`` on a
  4-frame seeded input write the JAX functions' files: the same names, the
  GIF frames and the strip PNG array-equal;
* ``run_visualize`` in ``visualize-debug`` mode on a small seeded H36M tree
  (``chip_smoke.write_h36m_tree``, the debug action alone, 2 + 2 frames)
  writes the JAX runner's files, 8 GIFs and 8 PNGs, equal frame for frame;
* without matplotlib the functions write nothing and return None.
"""

import builtins
import copy
import os

import numpy as np
import pytest

import chip_smoke as cs
from dstdgcn_tpu.runner import get_runner as jax_get_runner
from dstdgcn_tpu.utils import visualization as jvis
from dstdgcn_tpu.utils.logging import setup_logger as jax_setup_logger
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.main import run
from dstdgcn_tpu_torch.utils import visualization as tvis
from dstdgcn_tpu_torch.utils.config import resolve

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("matplotlib")


def _frames(path):
    return np.stack(imageio.mimread(path)) if path.endswith(".gif") \
        else imageio.imread(path)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        np.testing.assert_array_equal(_frames(os.path.join(b, name)),
                                      _frames(os.path.join(a, name)),
                                      err_msg=name)
    return names


def test_plots_equal_the_jax_functions(tmp_path):
    rng = np.random.RandomState(8)
    seq = rng.randn(4, 32 * 3).astype(np.float32) * 100
    pred = seq + rng.randn(*seq.shape).astype(np.float32) * 10
    expmap = rng.randn(2, 4, 99).astype(np.float32) * 0.3
    out = {}
    for label, mod in (("jax", jvis), ("port", tvis)):
        d = str(tmp_path / label)
        vis = mod.Visualizer("h36m")
        got = [vis.plot_single(seq, d, "single", input_n=2),
               vis.plot_multi(pred, seq, d, "multi"),
               mod.plot_expmap_multi(expmap[0], expmap[1], d, "expmap")]
        out[label] = [os.path.basename(g) for g in got]
    assert out["port"] == out["jax"] == ["single.gif", "multi.gif",
                                         "expmap.gif"]
    names = _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["expmap.gif", "multi.gif", "single.gif", "single.png"]
    assert tvis.BONES == jvis.BONES
    for key in ("_MULTI_I", "_MULTI_J", "_MULTI_LR"):
        np.testing.assert_array_equal(getattr(tvis, key), getattr(jvis, key))


def test_plots_write_nothing_without_matplotlib(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] in ("matplotlib", "imageio"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    seq = np.zeros((2, 96), np.float32)
    vis = tvis.Visualizer("3dpw")
    assert vis.plot_single(seq, str(tmp_path), "s") is None
    assert vis.plot_multi(seq, seq, str(tmp_path), "m") is None
    assert tvis.plot_expmap_multi(np.zeros((2, 99)), np.zeros((2, 99)),
                                  str(tmp_path), "e") is None
    assert os.listdir(tmp_path) == []


def _visualize_config(tree, base):
    cfg = configs.set_data_paths(configs.real_h36m_train(), tree, tree)
    cfg["mode"] = "visualize-debug"
    cfg["setting"].update(input_n=2, output_n=2)
    for split in ("train", "test"):
        cfg["dataset"][split]["h36m"].update(input_n=2, output_n=2)
    cfg["save"]["path"]["base"] = str(base)
    return cfg


def test_run_visualize_writes_the_jax_runners_files(tmp_path):
    tree = cs.write_h36m_tree(str(tmp_path / "h36m"), seed=3,
                              actions=["walking"], frames=40,
                              test_frames=230)
    jcfg = resolve(_visualize_config(tree, tmp_path / "jax"))
    os.makedirs(tmp_path / "jax")
    jcfg["logger"] = jax_setup_logger("jax_visualize", str(tmp_path / "jax"))
    jax_get_runner("h36m", copy.deepcopy(jcfg)).run()
    runner, _ = run(_visualize_config(tree, tmp_path / "port"), "cpu")
    assert runner.engine is None
    names = _same_files(str(tmp_path / "jax" / "visualize"),
                        str(tmp_path / "port" / "visualize"))
    assert names == sorted(f"Awalking_S{i}.{ext}" for i in range(1, 9)
                           for ext in ("gif", "png"))
