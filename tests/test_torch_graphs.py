"""The port's graph builders are bit-exact copies of the JAX package's."""

import numpy as np
import pytest
import torch

from dstdgcn_tpu.graphs import skeleton as jsk
from dstdgcn_tpu.graphs import temporal as jtg
from dstdgcn_tpu_torch.graphs import skeleton as sk
from dstdgcn_tpu_torch.graphs import temporal as tg

torch.set_num_threads(2)

LAYOUTS = ["h36m", "cmu", "3dpw"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_skeleton_matches_jax(layout):
    for kind in ("self", "connect", "part", "all"):
        got, want = sk.adjacency(layout, kind), jsk.adjacency(layout, kind)
        assert got.dtype == want.dtype and np.array_equal(got, want), kind
    np.testing.assert_array_equal(sk.stacked_adjacency(layout),
                                  jsk.stacked_adjacency(layout))
    np.testing.assert_array_equal(sk.bone_incidence(layout),
                                  jsk.bone_incidence(layout))
    a, b = sk.get_layout(layout), jsk.get_layout(layout)
    for field in ("used_joints", "bone_pairs", "part_pairs", "mirror_right",
                  "mirror_left", "full_joints", "num_aux_bones"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("t", [20, 35, 40])
def test_temporal_matches_jax(t):
    for kind in ("self", "neighbor", "neighboor", "tridiag", "inout", "all"):
        got, want = tg.adjacency(t, kind), jtg.adjacency(t, kind)
        assert got.dtype == want.dtype and np.array_equal(got, want), kind
    np.testing.assert_array_equal(tg.stacked_adjacency(t),
                                  jtg.stacked_adjacency(t))


def test_neighboor_quirk_is_not_tridiagonal():
    adj = tg.adjacency(6, "neighbor")
    assert adj[0, 0] == 1 and adj[5, 5] == 1 and adj[2, 2] == 0
    assert adj[0, 1] == 1 and adj[4, 5] == 1 and adj[2, 3] == 0
    assert np.all(np.diag(adj, -1) == 1)


def test_unknown_layout_and_kind_raise():
    with pytest.raises(NotImplementedError):
        sk.get_layout("nope")
    with pytest.raises(ValueError):
        sk.adjacency("h36m", "nope")
    with pytest.raises(ValueError):
        tg.adjacency(10, "nope")
