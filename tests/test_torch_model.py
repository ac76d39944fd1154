"""The port's DSTDGCN, loaded through the weight bridge, against the flax
model in eval mode (tolerance 1e-4: seven chained ops reorder sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstdgcn_tpu.models import DSTDGCN as JaxDSTDGCN
from dstdgcn_tpu_torch.kernels import fused as tfused
from dstdgcn_tpu_torch.models import DSTDGCN, JointBatchNorm
from dstdgcn_tpu_torch.utils.bridge import flatten_tree, load_flax_variables

torch.set_num_threads(2)

SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.1, joints_to_consider=22, num_feature=8,
             num_layers=2, layout="h36m")


def _calibrated_variables(jmodel, x, seed, **model_kw):
    """Flax init with every parameter moved by seeded noise (so gates and
    biases that init at 0 or 1 take part), and BatchNorm statistics set to
    the batch statistics of ``x``: activations stay O(1), as in a trained
    model, instead of growing by orders of magnitude over the layers."""
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)
    variables["params"] = jax.tree.map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32),
        variables["params"])
    model = DSTDGCN(**dict(model_kw, st_gcnn_dropout=0.0,
                           use_pallas=False))
    load_flax_variables(model, variables)
    for mod in model.modules():
        if isinstance(mod, JointBatchNorm):
            mod.momentum = 1.0
    with torch.no_grad():
        model.train()(torch.from_numpy(x))
    state = model.state_dict()
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: state[".".join(k.key for k in path)].numpy().copy(),
        variables["batch_stats"])
    return variables


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("use_pallas", [False, "serving"])
def test_bridged_model_matches_flax_eval(use_pallas, fast):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 22, 3).astype(np.float32) * 2
    kw = dict(SMALL, fast=fast, use_pallas=use_pallas)
    jmodel = JaxDSTDGCN(**kw)
    variables = _calibrated_variables(jmodel, x, seed=2, **kw)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)

    model = DSTDGCN(**kw).eval()
    load_flax_variables(model, variables)
    tfused.reset_launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # CPU tensors never reach a kernel, whatever the routing
    assert tfused.launch_counts() == {
        "dstd_spatial": 0, "dstd_temporal": 0, "dstd_spatial_bwd": 0,
        "dstd_temporal_bwd": 0, "dstd_chain": 0, "dstd_encoder_chain": 0,
        "dstd_spatial_bf16": 0, "dstd_temporal_bf16": 0,
        "dstd_spatial_bwd_bf16": 0, "dstd_temporal_bwd_bf16": 0,
        "dstd_chain_bf16": 0, "dstd_encoder_chain_bf16": 0}


def test_train_mode_batchnorm_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 22, 3).astype(np.float32)
    kw = dict(SMALL, st_gcnn_dropout=0.0)
    jmodel = JaxDSTDGCN(**kw)
    variables = _calibrated_variables(jmodel, x, seed=4, **kw)
    want, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    model = DSTDGCN(**dict(SMALL, st_gcnn_dropout=0.0)).train()
    load_flax_variables(model, variables)
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    state = model.state_dict()
    for key, val in flatten_tree(mut["batch_stats"]).items():
        np.testing.assert_allclose(state[key].numpy(), val, rtol=1e-4,
                                   atol=1e-4)