"""DSTD-GCN motion-prediction network in PyTorch.

Counterpart of ``dstdgcn_tpu/models/dstdgcn.py``.  The model consumes a
padded position sequence ``(N, T=input_n+output_n, V, 3)`` whose output
frames hold the last observed frame, forms a (position, motion) 6-channel
input, runs an in-layer, ``num_layers`` residual DSTD-GC encoder blocks and
an out-layer, and adds back the last observed frame so the network
predicts motion deltas.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from .layers import Dropout, JointBatchNorm, PReLU, STGCNNLayer, reset_all

__all__ = ["DSTDGCN", "get_model"]


class DSTDGCN(nn.Module):
    """Flagship spatiotemporal motion-prediction model.

    ``fast`` selects the fully learnable spatial adjacency with left
    aggregation; ``use_pallas`` routes the DSTD-GC ops through the CUDA
    kernels (see :class:`.layers.DSTDGC`).  ``pair_flat`` and the
    ``agg_group_*`` sizes are layout choices of the JAX package with the
    same result and change nothing here.  Parameters start from
    ``torch.Generator().manual_seed(seed)``; call :meth:`reset_parameters`
    with another generator to draw them again.  Dropout draws its masks from
    ``do_in.generator`` (seeded ``seed + 1``).
    """

    def __init__(self, input_channels: int = 6, input_time_frame: int = 10,
                 output_time_frame: int = 25, st_gcnn_dropout: float = 0.1,
                 joints_to_consider: int = 22, num_feature: int = 64,
                 num_layers: int = 7, layout: str = "h36m",
                 fast: bool = False, bn_axis_name: Optional[str] = None,
                 use_pallas: Union[bool, str] = False,
                 pair_flat: Union[bool, str] = False,
                 agg_group_spatial: Union[int, str, None] = None,
                 agg_group_temporal: Union[int, str, None] = None,
                 compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False,
                 auto_batch_hint: Optional[int] = None, seed: int = 0):
        super().__init__()
        knobs = dict(compute_dtype=compute_dtype, pair_flat=pair_flat,
                     agg_group_spatial=agg_group_spatial,
                     agg_group_temporal=agg_group_temporal)
        autos = sorted(k for k, v in knobs.items() if v == "auto")
        if autos:
            raise NotImplementedError(
                f"{autos} = 'auto': the auto-knob policy has no H100 "
                "measurements yet (ROADMAP Queue 1 item 13); set the knobs "
                "explicitly")
        if bn_axis_name is not None:
            raise NotImplementedError(
                "bn_axis_name (cross-replica BatchNorm) belongs to the "
                "parallel layer, ROADMAP Queue 1 item 12")
        if remat:
            raise NotImplementedError(
                "model.remat (activation rematerialisation in training) is "
                "not ported yet (ROADMAP Queue 1 item 6)")
        del pair_flat, agg_group_spatial, agg_group_temporal, auto_batch_hint
        self.input_channels = input_channels
        self.input_time_frame = input_time_frame
        self.output_time_frame = output_time_frame
        self.joints_to_consider = joints_to_consider
        self.num_layers = num_layers
        self.fast = fast
        t, v, f = (input_time_frame + output_time_frame, joints_to_consider,
                   num_feature)
        common = dict(time_dim=t, joints_dim=v, layout=layout, fast=fast,
                      use_pallas=use_pallas, compute_dtype=compute_dtype)
        self.conv_st_in = STGCNNLayer(input_channels, f, residual=False,
                                      **common)
        self.bn_in = JointBatchNorm(v, f)
        self.prelu = PReLU()
        # the engine hands over a generator on its device, seeded seed + 1
        self.do_in = Dropout(st_gcnn_dropout,
                             torch.Generator().manual_seed(seed + 1))
        for i in range(num_layers):
            self.add_module(f"encoder_{i}",
                            STGCNNLayer(f, f, residual=True, **common))
            self.add_module(f"encoder_bn_{i}", JointBatchNorm(v, f))
            self.add_module(f"encoder_prelu_{i}", PReLU())
        self.conv_st_out = STGCNNLayer(f, input_channels // 2,
                                       residual=False, **common)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_all(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        tt = self.input_time_frame + self.output_time_frame
        if t != tt or v != self.joints_to_consider:
            raise ValueError(f"input {tuple(x.shape)}: expected T={tt} and "
                             f"V={self.joints_to_consider}")
        # motion decomposition: the last padded frame is the last observed
        # frame; channels = (position, position - last)
        residual = x[:, -1:]
        h = torch.cat([x, x - residual], dim=-1)
        h = self.do_in(self.prelu(self.bn_in(self.conv_st_in(h))))
        for i in range(self.num_layers):
            h = getattr(self, f"encoder_{i}")(h)
            h = getattr(self, f"encoder_bn_{i}")(h)
            h = getattr(self, f"encoder_prelu_{i}")(h)
        return self.conv_st_out(h) + residual


_REGISTRY = {
    "dstdgcn": dict(fast=False),
    "dstdgcn_fast": dict(fast=True),
}

_MODEL_KNOBS = ("bn_axis_name", "use_pallas", "compute_dtype", "pair_flat",
                "agg_group_spatial", "agg_group_temporal", "remat",
                "auto_batch_hint")


def get_model(name: str, **opts: Any) -> DSTDGCN:
    """Model factory: the model's own hyper-parameters live under
    ``opts[name]``; the routing knobs may also sit at the top of ``opts``."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}")
    kwargs = dict(opts.get(name, {}))
    for k in ("name", "load", "ckpt"):
        kwargs.pop(k, None)
    kwargs.update(_REGISTRY[name])
    for k in _MODEL_KNOBS:
        if k in opts:
            kwargs[k] = opts[k]
    return DSTDGCN(**kwargs)
