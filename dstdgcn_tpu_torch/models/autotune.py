"""The "auto" model knobs: per-batch-size values of the compute dtype and
the aggregation grouping.

The port's copy of ``dstdgcn_tpu/models/autotune.py``, so that ``auto`` in
a config means the same thing in both packages at every batch size.  The
table is the JAX package's: its thresholds were chosen there from that
package's own measurements, and they are the configs' meaning here, not a
measurement of this port.  Re-tuning them for the H100 waits for measured
rows of the port's own benchmark.

=============  ======================  ================================
batch          compute_dtype           agg_group_spatial / _temporal
=============  ======================  ================================
below 64       None (float32)          None / None
64 to 511      "bfloat16"              5 / 2
512 and up     "bfloat16"              None / None
=============  ======================  ================================

The grouping sizes are layout choices of the JAX package's XLA path with
the same result; the port accepts them and computes the same function
without them.  The table is read at the batch one device computes: the
configured batch hint is the global batch, divided by the active mesh's
data-axis size (:func:`per_chip_batch`), and a forward's own batch is
already a rank's.  The hint is not scaled by a process count (the JAX
package scales it by ``jax.process_count()``, which ``ADVICE.md`` records
as a finding of that package).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from ..parallel.mesh import active_mesh

__all__ = ["AUTO_KNOBS", "resolve_auto", "per_chip_batch", "resolve_knob"]

#: knobs that accept the string "auto" in DSTDGCN / config files
AUTO_KNOBS = ("compute_dtype", "agg_group_spatial", "agg_group_temporal")


def resolve_auto(batch_size: int) -> Dict[str, Any]:
    """The knob values of the table above for ``batch_size``."""
    if batch_size < 64:
        return dict(compute_dtype=None, agg_group_spatial=None,
                    agg_group_temporal=None)
    if batch_size >= 512:
        return dict(compute_dtype="bfloat16", agg_group_spatial=None,
                    agg_group_temporal=None)
    return dict(compute_dtype="bfloat16", agg_group_spatial=5,
                agg_group_temporal=2)


def per_chip_batch(batch_size: int) -> int:
    """The batch one device computes of a global ``batch_size``: divided by
    the active mesh's data-axis size (at least 1), the whole batch without
    a mesh, as in the JAX package."""
    mesh = active_mesh()
    if mesh is None:
        return batch_size
    return max(1, batch_size // mesh.shape["data"])


def resolve_knob(name: str, value: Union[str, int, None], batch_size: int,
                 batch_hint: Optional[int] = None) -> Optional[Any]:
    """``value`` unless it is the string "auto"; then the table's value at
    ``batch_hint`` (the configured batch size, which the runner passes as
    ``auto_batch_hint`` so that a ragged last batch or an eval batch of
    another size does not flip the knobs within a run), a global batch read
    per chip, or, without a hint, at ``batch_size``, a forward's own (a
    rank's) batch."""
    if value == "auto":
        n = per_chip_batch(batch_hint) if batch_hint else batch_size
        return resolve_auto(n)[name]
    return value
