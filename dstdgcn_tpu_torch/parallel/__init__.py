"""The parallel layer on ``torch.distributed``: the counterpart of
``dstdgcn_tpu/parallel/`` (its exports, by the same names where there is a
counterpart; see :mod:`.mesh` for the map of the GSPMD placements)."""

from . import collectives, distributed, mesh, shard
from .distributed import initialize, process_info
from .mesh import (Mesh, activation_sharding_context, make_mesh,
                   param_sharding)
from .shard import (dstd_spatial_edge_partitioned, dstd_spatial_ring,
                    dstd_temporal_edge_partitioned)

__all__ = [
    "mesh", "shard", "distributed", "collectives", "Mesh", "make_mesh",
    "param_sharding", "activation_sharding_context",
    "dstd_spatial_edge_partitioned", "dstd_temporal_edge_partitioned",
    "dstd_spatial_ring", "initialize", "process_info",
]
