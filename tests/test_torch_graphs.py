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


def _same(got, want, what):
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_list_and_kinematic_bones_match_jax(layout):
    _same(sk.get_layout(layout).kinematic_bones,
          jsk.get_layout(layout).kinematic_bones, "kinematic_bones")
    for kind in ("connect", "part", "all"):
        adj = jsk.adjacency(layout, kind)
        _same(sk.edge_list(adj), jsk.edge_list(adj), kind)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jbc_and_flattened_graphs_match_jax(layout):
    for kind in ("joint", "bone", "cross"):
        _same(sk.jbc_adjacency(layout, kind), jsk.jbc_adjacency(layout, kind),
              f"jbc {kind}")
    for dims in (2, 3):
        for kind in ("joint", "coordinate", "connection"):
            _same(sk.flattened_adjacency(layout, kind, dims),
                  jsk.flattened_adjacency(layout, kind, dims),
                  f"flattened {kind} dims={dims}")
        _same(sk.joint_bone_transition(layout, dims),
              jsk.joint_bone_transition(layout, dims), f"transition {dims}")
        for kind in ("joint", "bone", "joint-node", "bone-node"):
            _same(sk.joint_bone_flattened(layout, kind, dims),
                  jsk.joint_bone_flattened(layout, kind, dims),
                  f"joint-bone {kind} dims={dims}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_hop_normalize_and_stgcn_graphs_match_jax(layout):
    lay = jsk.get_layout(layout)
    for max_hop in (1, 2, 3):
        _same(sk.hop_distance(lay.bones, lay.num_joints, max_hop),
              jsk.hop_distance(lay.bones, lay.num_joints, max_hop),
              f"hop {max_hop}")
    for kind in ("connect", "all"):
        adj = jsk.adjacency(layout, kind)
        _same(sk.normalize_digraph(adj), jsk.normalize_digraph(adj), kind)
        _same(sk.normalize_undigraph(adj), jsk.normalize_undigraph(adj),
              kind)
    for strategy in ("uniform", "distance", "spatial"):
        for max_hop, dilation in ((1, 1), (2, 1), (3, 2)):
            opts = dict(strategy=strategy, max_hop=max_hop,
                        dilation=dilation, center=3)
            _same(sk.stgcn_adjacency(layout, **opts),
                  jsk.stgcn_adjacency(layout, **opts),
                  f"stgcn {opts}")
            _same(sk.stgcn_adjacency(lay.parts, **opts),
                  jsk.stgcn_adjacency(lay.parts, **opts),
                  f"stgcn edges {opts}")


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
    for fn in (sk.jbc_adjacency, sk.flattened_adjacency,
               sk.joint_bone_flattened):
        with pytest.raises(ValueError):
            fn("h36m", "nope")
    with pytest.raises(ValueError):
        sk.stgcn_adjacency("h36m", "nope")
