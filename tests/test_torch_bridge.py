"""The port's DSTDGCN against the flax model's structure: parameter names
and shapes, the weight bridge's checks, seeded init and the options the
port refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dstdgcn_tpu.models import DSTDGCN as JaxDSTDGCN
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu_torch.models import DSTDGCN, get_model
from dstdgcn_tpu_torch.utils.bridge import flatten_tree, load_flax_variables

torch.set_num_threads(2)

SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.1, joints_to_consider=22, num_feature=8,
             num_layers=2, layout="h36m")
H36M = dict(input_channels=6, input_time_frame=10, output_time_frame=25,
            st_gcnn_dropout=0.1, joints_to_consider=22, num_feature=64,
            num_layers=5, layout="h36m")


def test_parameter_count_matches_flax_full_h36m():
    jmodel = jax_get_model("dstdgcn", dstdgcn=H36M)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)},
                            jnp.zeros((1, 35, 22, 3)), train=False))
    jflat = {col: flatten_dict(shapes[col], sep=".") for col in shapes}
    model = get_model("dstdgcn", dstdgcn=H36M, use_pallas="serving")
    n_jax = sum(int(np.prod(s.shape)) for s in jflat["params"].values())
    assert sum(p.numel() for p in model.parameters()) == n_jax == 173999
    names = {k for col in jflat.values() for k in col}
    assert names == set(model.state_dict())
    for col in jflat.values():
        for key, s in col.items():
            assert tuple(model.state_dict()[key].shape) == tuple(s.shape)


def test_bridge_rejects_missing_extra_and_misshaped_keys():
    x = jnp.zeros((1, 8, 22, 3))
    jmodel = JaxDSTDGCN(**SMALL)
    variables = jax.tree.map(
        np.asarray, jmodel.init({"params": jax.random.key(0)}, x,
                                train=False))
    model = DSTDGCN(**SMALL)
    load_flax_variables(model, variables)   # the full tree loads
    params = dict(variables["params"])
    params.pop("bn_in")
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(model, dict(variables, params=params))
    params = dict(variables["params"], extra={"w": np.zeros(2)})
    with pytest.raises(KeyError, match="extra"):
        load_flax_variables(model, dict(variables, params=params))
    bad = dict(variables["params"])
    bad["prelu"] = {"negative_slope": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(model, dict(variables, params=bad))


def test_routed_op_in_train_mode_raises():
    """A routed op in train mode no longer raises: it trains through the
    kernels' autograd Function (the plain ops on the CPU) with the same
    gradients as the plain path; what still raises in training is
    ``remat`` and a bf16 compute dtype on the card."""
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 8, 22, 3).astype(np.float32))
    grads = []
    for flag in (True, "serving", False):
        model = DSTDGCN(**dict(SMALL, st_gcnn_dropout=0.0),
                        use_pallas=flag).train()
        model(x).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for routed in grads[:2]:
        for a, b in zip(routed, grads[2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DSTDGCN(**SMALL, remat=True)


def test_auto_knobs_and_unported_options_raise():
    with pytest.raises(NotImplementedError, match="item 13"):
        DSTDGCN(**SMALL, compute_dtype="auto")
    with pytest.raises(NotImplementedError):
        DSTDGCN(**SMALL, bn_axis_name="data")
    with pytest.raises(ValueError):
        DSTDGCN(**SMALL, use_pallas="sometimes")


def test_init_is_seeded_and_matches_flax_init_values():
    a, b = DSTDGCN(**SMALL, seed=5), DSTDGCN(**SMALL, seed=5)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    jmodel = JaxDSTDGCN(**SMALL)
    variables = jmodel.init({"params": jax.random.key(0)},
                            jnp.zeros((1, 8, 22, 3)), train=False)
    flat = flatten_tree(jax.tree.map(np.asarray, variables["params"]))
    state = a.state_dict()
    # deterministic initializers agree exactly; random ones in scale
    for key in ("conv_st_in.block.R_s", "conv_st_in.block.W_s",
                "encoder_0.block.R_t", "bn_in.scale", "prelu.negative_slope",
                "encoder_1.block.alpha_tm"):
        np.testing.assert_array_equal(state[key].numpy(), flat[key])
    w = state["encoder_0.block.spatial.wrm"].numpy()
    assert abs(w.std() - flat["encoder_0.block.spatial.wrm"].std()) < 0.1

