"""The process mesh and the port's counterparts of the JAX sharding rules.

Counterpart of ``dstdgcn_tpu/parallel/mesh.py``.  There, every array is
global and GSPMD places it: the batch over ``data``, the joint axis over
``graph``, feature channels over ``model``.  Here each rank is one process
on one device and holds its own shard, so every placement becomes explicit
code:

==========================  ===============================================
JAX (``parallel/mesh.py``)   port
==========================  ===============================================
``make_mesh``               :func:`make_mesh`: a :class:`Mesh` of named
                            process groups, the same shape rules
``batch_sharding``          the loader's split of every global batch by
                            process (``data/loader.py``)
``replicated``              one broadcast of the parameters and statistics
                            from rank 0 after ``engine.init``
``place_tree``              the same broadcast
``activation_sharding_     :func:`activation_sharding_context`: the active
context``                   mesh, which ``JointBatchNorm`` (statistics over
                            the data group) and ``per_chip_batch`` read
``constrain_activation``    nothing: a rank's activations are its shard
``param_sharding``          :func:`param_sharding`: the same rule by leaf
                            name, as specs
==========================  ===============================================

The engine (``engine/engine.py``) averages gradients and losses over the
data group, which GSPMD does by making every array global.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "activation_sharding_context",
           "active_mesh", "stats_group", "param_sharding"]

#: the mesh axes, outermost first: ranks are numbered row major over them
AXES = ("data", "graph", "model")


class Mesh:
    """Named process groups over the ranks ``0 .. size - 1``, row major over
    ``axis_names``, like ``jax.sharding.Mesh`` over devices: ``shape`` maps
    each axis to its size, :meth:`group` gives this rank's group along an
    axis and :meth:`index` its position in it (``axis_index``)."""

    def __init__(self, shape: Dict[str, int], groups: Dict[str, Any],
                 coords: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self._groups = groups
        self._coords = coords

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self._coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(data: Optional[int] = None, graph: int = 1,
              model: int = 1) -> Mesh:
    """A ("data", "graph"[, "model"]) mesh over the ranks of the process
    group, as ``dstdgcn_tpu.parallel.make_mesh`` builds one over devices:
    ``data`` None takes the world over ``graph * model``; the ``model``
    axis exists only when above 1.  Every rank must call it (each group is
    made by ``dist.new_group``, which every rank enters); a rank beyond
    ``data * graph * model`` belongs to no group of the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % (graph * model):
            raise ValueError(f"make_mesh: {world} ranks do not split into "
                             f"graph={graph} x model={model}")
        data = world // (graph * model)
    if data * graph * model > world:
        raise ValueError(f"make_mesh: {data}x{graph}x{model} ranks asked, "
                         f"the process group has {world}")
    sizes = dict(data=data, graph=graph, model=model)
    names = AXES if model > 1 else AXES[:2]
    shape = {a: sizes[a] for a in names}

    def coords_of(r):
        return dict(data=r // (graph * model), graph=(r // model) % graph,
                    model=r % model)

    def rank_of(c):
        return (c["data"] * graph + c["graph"]) * model + c["model"]

    mine = coords_of(rank) if rank < data * graph * model else None
    groups = {}
    for axis in names:
        others = [a for a in AXES if a != axis]
        # every group along ``axis``, in one order on every rank
        for fixed in _product([sizes[a] for a in others]):
            c = dict(zip(others, fixed))
            ranks = [rank_of(dict(c, **{axis: i}))
                     for i in range(sizes[axis])]
            group = dist.new_group(ranks)
            if mine is not None and rank in ranks:
                groups[axis] = group
    return Mesh(shape, groups, mine or {})


def _product(sizes):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (i,) + rest


# -- the active mesh ---------------------------------------------------------
# The engine enters the mesh around every forward pass, so that model code
# stays mesh-agnostic: JointBatchNorm reduces its statistics over the mesh's
# data group and models/autotune.py reads the data-axis size.

_ACTIVE_MESH: contextvars.ContextVar[Optional[Mesh]] = \
    contextvars.ContextVar("dstdgcn_torch_active_mesh", default=None)


@contextlib.contextmanager
def activation_sharding_context(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh inside the block (None: none)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH.get()


def stats_group(axis_name: Optional[str]):
    """``(group, size)`` over which a BatchNorm in training reduces its
    statistics, or None for none.

    With ``axis_name`` the group is the active mesh's along that axis (the
    JAX module's ``pmean`` over ``axis_name``): a ``ValueError`` names the
    axis when no active mesh has it, as JAX refuses an unbound axis name.
    Without one, it is the data group whenever that has more than one rank:
    under GSPMD a BatchNorm's mean is the global batch's whether or not an
    axis is named.
    """
    mesh = active_mesh()
    if axis_name is not None:
        if mesh is None or axis_name not in mesh.axis_names:
            raise ValueError(
                f"bn_axis_name {axis_name!r}: no active mesh has that axis "
                f"(active: {mesh!r}); train through an engine with a mesh")
        return mesh.group(axis_name), mesh.shape[axis_name]
    if mesh is not None and mesh.shape["data"] > 1:
        return mesh.group("data"), mesh.shape["data"]
    return None


# -- the model axis -----------------------------------------------------------

#: parameters whose LAST dim is the feature/output-channel dim: the DSTD
#: feature transform, Dense kernels/biases, and joint-BN (V, C) vectors
_CHANNEL_LAST_PARAMS = frozenset(
    ["wf", "bf", "kernel", "bias", "scale", "mean", "var"])


def param_sharding(mesh: Mesh, tree):
    """Per-leaf specs of the tensor-parallel ``model`` axis, the rule of
    ``dstdgcn_tpu.parallel.param_sharding``: a leaf whose name (the last key
    of its path) is a feature/output-channel parameter and whose last dim
    divides the ``model`` axis gets ``(None, ..., "model")``; every other
    leaf, and every leaf without a model axis, is replicated (``()``).

    ``tree`` is a nested dict (a flax-style tree of parameters, statistics
    or Adam moments) or a flat dict of dotted names (``named_parameters``,
    ``state_dict``, or an optimizer's moments keyed by the parameters'
    names); the result has the same structure.  The engine does not run a
    model axis (ROADMAP item 4c): the specs say which dimension would
    shard.
    """
    m = mesh.shape.get("model", 1)

    def rule(name: str, leaf):
        ndim = getattr(leaf, "ndim", 0)
        if m > 1 and name.rsplit(".", 1)[-1] in _CHANNEL_LAST_PARAMS \
                and ndim >= 1 and leaf.shape[-1] % m == 0:
            return (None,) * (ndim - 1) + ("model",)
        return ()

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping) else rule(str(k), v)
                for k, v in node.items()}

    return walk(tree)
