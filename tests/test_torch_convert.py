"""The port's reference-checkpoint converter (``dstdgcn_tpu_torch/utils/
convert.py``) against the JAX package's (``dstdgcn_tpu/utils/convert.py``).

A seeded state_dict in the reference PyTorch DSTD-GCN's layout (the keys
and shapes ``_dstdgc``, ``_bn`` and ``_block`` of the JAX converter read,
for the qualitative and the fast model) goes through the port's
``torch_state_to_port`` and through the JAX ``torch_state_to_flax``
followed by the port's weight bridge: the two states must be bit-equal.
Both ``.pth`` formats the reference writes (a bare state_dict and the
engine's dict with the ``model.`` prefix) must load to the same state.
"""

import numpy as np
import pytest
import torch

from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.utils import convert
from dstdgcn_tpu_torch.utils.bridge import load_flax_variables

#: a small model of the H36M layout (K = 2 spatial kernels, 1 temporal)
MODEL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=2, layout="h36m")
RED = 2


def _reference_state(fast, seed=3):
    """A reference state_dict (numpy) of MODEL's widths, seeded."""
    rng = np.random.RandomState(seed)
    t = MODEL["input_time_frame"] + MODEL["output_time_frame"]
    v, f = MODEL["joints_to_consider"], MODEL["num_feature"]
    sd = {}

    def put(name, *shape):
        sd[name] = rng.randn(*shape).astype(np.float32)

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean"):
            put(f"{prefix}.bn.{leaf}", c * v)
        sd[f"{prefix}.bn.running_var"] = rng.uniform(
            0.5, 2.0, c * v).astype(np.float32)

    def dstdgc(prefix, k, ci, co, ref):
        for i in range(k):
            put(f"{prefix}.{i}.conv_f.weight", co, ci, 1, 1)
            put(f"{prefix}.{i}.conv_f.bias", co)
            for m in ("conv_m1", "conv_m2"):
                put(f"{prefix}.{i}.{m}.weight", RED, ci, 1, 1)
                put(f"{prefix}.{i}.{m}.bias", RED)
            put(f"{prefix}.{i}.conv_rm.weight", ref, RED * ref, 1, 1)
            put(f"{prefix}.{i}.conv_rm.bias", ref)

    def block(prefix, ci, co):
        for name in (("A_s",) if fast else ("W_s", "R_s")):
            put(f"{prefix}.{name}", 2, v, v)
        put(f"{prefix}.R_t", 1, t, t)
        put(f"{prefix}.alpha_sm", 1)
        put(f"{prefix}.alpha_tm", 1)
        dstdgc(f"{prefix}.conv_s", 2, ci, co, t)
        dstdgc(f"{prefix}.conv_t", 1, co, co, v)
        bn(f"{prefix}.bn", co)
        put(f"{prefix}.prelu.weight", 1)
        if ci != co:
            put(f"{prefix}.residual.0.weight", co, ci, 1, 1)
            put(f"{prefix}.residual.0.bias", co)
            bn(f"{prefix}.residual.1", co)

    c_in = MODEL["input_channels"]
    block("conv_st_in.stgcn.0.0", c_in, f)
    for i in range(MODEL["num_layers"]):
        block(f"encoders.{i}.0.stgcn.0.0", f, f)
        bn(f"encoders.{i}.1", f)
        put(f"encoders.{i}.2.weight", 1)
    block("conv_st_out.stgcn.0.0", f, c_in // 2)
    bn("bn_in", f)
    put("prelu.weight", 1)
    return sd


def _model(fast):
    name = "dstdgcn_fast" if fast else "dstdgcn"
    return get_model(name, **{name: MODEL})


def _convert_args(fast):
    return dict(num_layers=MODEL["num_layers"],
                joints=MODEL["joints_to_consider"], fast=fast)


@pytest.mark.parametrize("fast", [False, True])
def test_port_conversion_is_the_jax_conversion_through_the_bridge(fast):
    import jax
    from dstdgcn_tpu.utils.convert import torch_state_to_flax
    sd = _reference_state(fast)
    got = convert.torch_state_to_port(sd, **_convert_args(fast))
    via_jax = _model(fast)
    load_flax_variables(via_jax, jax.tree.map(
        np.asarray, torch_state_to_flax(sd, **_convert_args(fast))))
    want = via_jax.state_dict()
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), val.numpy(),
                                      err_msg=key)
    # the port's own flax-tree form is the JAX tree, leaf for leaf
    tree = convert.torch_state_to_flax(sd, **_convert_args(fast))
    jtree = torch_state_to_flax(sd, **_convert_args(fast))
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the converted state loads into the model by name, nothing left over
    model = _model(fast)
    model.load_state_dict(got)
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), want[key].numpy())


@pytest.mark.parametrize("fast", [False, True])
def test_both_pth_formats_load_to_the_same_state(fast, tmp_path):
    from dstdgcn_tpu.utils.convert import \
        load_torch_state_dict as jax_load
    sd = _reference_state(fast)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    bare, engine = tmp_path / "bare.pth", tmp_path / "engine.pth"
    torch.save(tensors, str(bare))
    torch.save({"lr": 1e-3, "err": 42.0,
                "model": {"model." + k: v for k, v in tensors.items()},
                "optimizer": {}, "scheduler": {}, "epoch": 7}, str(engine))
    want = convert.torch_state_to_port(sd, **_convert_args(fast))
    for path in (bare, engine):
        read = convert.load_torch_state_dict(str(path))
        jread = jax_load(str(path))
        assert read.keys() == jread.keys() == sd.keys()
        for key in sd:
            np.testing.assert_array_equal(read[key], sd[key])
            np.testing.assert_array_equal(read[key], jread[key])
        got = convert.torch_state_to_port(read, **_convert_args(fast))
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
        model = _model(fast)
        convert.load_reference_checkpoint(model, str(path))
        for key, val in model.state_dict().items():
            assert torch.equal(val, want[key]), key


def test_bn_vectors_follow_each_models_flattening():
    """c-major (index c*V + v) in the qualitative model, v-major (v*C + c)
    in the fast one, as the reference's two BatchNorm1d layouts are."""
    v, c = 4, 3
    vec = np.arange(v * c, dtype=np.float32)
    qual = convert._bn_vec(vec, v, fast=False)
    fast = convert._bn_vec(vec, v, fast=True)
    assert qual.shape == fast.shape == (v, c)
    assert qual[1, 2] == 2 * v + 1 and fast[1, 2] == 1 * c + 2
