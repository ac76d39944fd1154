"""Graph WaveNet (Wu et al., IJCAI 2019) for traffic forecasting on a road
graph, with its road diffusion on the blocked SpMM.

The layer equations are those of ``model.py::gwnet`` of the authors' code
(github.com/nnzhan/Graph-WaveNet), at its defaults: a 1x1 ``start_conv``
to ``residual_channels``; ``blocks`` x ``layers`` layers of kernel size 2
at dilations 1, 2, 1, 2, ..., each ``h = tanh(filter(x)) * sigmoid(gate(x))``,
``skip += skip_conv(h)`` (``skip`` cropped to the new length), ``h =
gcn(h)``, ``x = BN(h + x[..., -len:])``; then ``relu(skip)``, a 1x1
``end_conv_1`` with a relu and a 1x1 ``end_conv_2`` to ``output_time_frame``
channels.  ``gcn`` diffuses over three supports, each ``order`` hops of
``nconv(x, S) = einsum('ncvl,vw->ncwl', x, S)``: the road graph's forward
transition ``D_out^-1 A``, its backward transition ``D_in^-1 A^T`` and the
adaptive ``softmax(relu(E1 E2), dim=1)``; it concatenates the input and the
hops, applies a 1x1 ``mlp`` and dropout.

What differs from ``model.py`` in form (not in result):

* The input is the dataset's ``(N, T, V, C_in)`` in the caller's node
  order and the output ``(N, output_time_frame, V)``, the prediction of
  each step ahead, in the same order.
* Inside, the nodes run in a bandwidth-reducing order
  (:func:`..graphs.road.rcm_order`), in which a road support's edges fill
  few 128 x 128 blocks.  A hop over a road support is
  ``kernels/sparse.py::block_spmm`` (kernel 7) of the support's transpose
  in that order, padded to a multiple of the block, on the node-major
  ``(V, N*C*L)`` activation; its ``d_x`` is the same kernel on the
  transposed pattern, against the support's transpose, which the model
  holds beside it.  The adaptive hop is one dense product,
  ``kernels/dense.py::dense_hop`` (``adp^T x`` and its gradients on
  3xTF32 ``wgmma``).  The node embeddings stay in the caller's order.
* The gate convolution is a ``Conv2d`` (``model.py`` builds an
  ``nn.Conv1d`` with the kernel ``(1, 2)``, which computes the same);
  ``residual_convs``, which ``model.py`` builds but does not call when the
  graph convolution is on, are left out.
* Dropout draws its masks from an explicit generator (the engine's,
  seeded ``seed + 1``): one ``torch.rand`` of the ``(N, C, V, L)`` shape in
  the caller's node order a layer, moved into the inner order.
* Parameters are drawn from an explicit generator in ``named_parameters``
  order (:meth:`GWNet.reset_parameters`): ``nodevec1`` and ``nodevec2``
  standard normal, each convolution's weight and bias uniform within
  ``1 / sqrt(fan_in)`` (torch's defaults), the BatchNorms at one and zero.

Program spans (:func:`..utils.profiling.spanned`, recorded only while a
profiler records): ``gwnet.tcn`` (the gated convolutions), ``gwnet.diffusion``
(one layer's ``gcn``) and ``gwnet.adaptive`` (forming the adaptive
support), each in both directions.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graphs import road
from ..kernels import dense, sparse
from ..utils import profiling
from .layers import Dropout

__all__ = ["GWNet", "NodeOrderDropout", "build"]


class NodeOrderDropout(Dropout):
    """:class:`.layers.Dropout` of an ``(N, C, V, L)`` activation in the
    inner node order, its mask drawn in the caller's order: position k of
    the inner order holds the caller's node ``order[k]``."""

    def __init__(self, p: float, generator: torch.Generator,
                 order: torch.Tensor):
        super().__init__(p, generator, features=(0, 0))
        self.register_buffer("order", order.clone(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        g = self.generator
        keep = torch.rand(x.shape, generator=g, device=g.device) >= self.p
        keep = keep.index_select(2, self.order.to(keep.device))
        return x * keep.to(device=x.device, dtype=x.dtype) / (1 - self.p)


class _Linear(nn.Module):
    """``model.py``'s ``linear``: a 1x1 convolution named ``mlp``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.mlp = nn.Conv2d(c_in, c_out, kernel_size=(1, 1))


class _GCN(nn.Module):
    """``model.py``'s ``gcn`` parameters: the 1x1 ``mlp`` over the input
    and its ``order`` hops over each support."""

    def __init__(self, c_in: int, c_out: int, supports: int, order: int):
        super().__init__()
        self.mlp = _Linear((order * supports + 1) * c_in, c_out)


class GWNet(nn.Module):
    """Graph WaveNet over a road graph of ``joints_to_consider`` sensors.

    The graph is ``adjacency`` (a (V, V) weighted adjacency in the caller's
    node order) or, without one, drawn by :func:`..graphs.road.road_graph`
    with the keyword arguments ``graph`` (its ``seed`` among them).
    """

    def __init__(self, joints_to_consider: int = 3834,
                 input_time_frame: int = 12, output_time_frame: int = 12,
                 in_dim: int = 3, residual_channels: int = 32,
                 dilation_channels: int = 32, skip_channels: int = 256,
                 end_channels: int = 512, kernel_size: int = 2,
                 blocks: int = 4, layers: int = 2, dropout: float = 0.3,
                 embedding: int = 10, order: int = 2, block: int = 128,
                 adjacency: Optional[np.ndarray] = None,
                 graph: Optional[dict] = None, seed: int = 0):
        super().__init__()
        v = joints_to_consider
        self.joints_to_consider = v
        self.input_time_frame = input_time_frame
        self.output_time_frame = output_time_frame
        self.order_hops = order
        self.block = block
        self.layer_count = blocks * layers
        if adjacency is None:
            if graph is None:
                raise ValueError("GWNet needs an adjacency or a graph block")
            adjacency = road.road_graph(v, **graph)
        adjacency = np.asarray(adjacency, np.float32)
        if adjacency.shape != (v, v):
            raise ValueError(f"adjacency {adjacency.shape} for {v} nodes")
        order_np = road.rcm_order(adjacency)
        self.register_buffer("order", torch.from_numpy(order_np),
                             persistent=False)
        self.register_buffer("inverse", torch.from_numpy(
            road.inverse_order(order_np)), persistent=False)
        self.padded = road.padded(v, block)
        #: (rows, cols) of each road support's blocks, in the inner order
        self.support_blocks = []
        for i, p in enumerate(road.transitions(adjacency)):
            # nconv(x, P) is P^T x on the node-major activation
            m = np.zeros((self.padded, self.padded), np.float32)
            m[:v, :v] = p[order_np][:, order_np].T
            self.register_buffer(f"support_{i}", torch.from_numpy(m)[None],
                                 persistent=False)
            # the d_x operand: zero outside the support's own blocks, m^T
            # is the masked transpose that block_spmm's adj_t asks for
            self.register_buffer(f"support_{i}_t", torch.from_numpy(
                np.ascontiguousarray(m.T))[None], persistent=False)
            self.support_blocks.append(road.block_list(m, block))

        self.nodevec1 = nn.Parameter(torch.empty(v, embedding))
        self.nodevec2 = nn.Parameter(torch.empty(embedding, v))
        self.start_conv = nn.Conv2d(in_dim, residual_channels, (1, 1))
        self.filter_convs = nn.ModuleList()
        self.gate_convs = nn.ModuleList()
        self.skip_convs = nn.ModuleList()
        self.bn = nn.ModuleList()
        self.gconv = nn.ModuleList()
        receptive = 1
        for _ in range(blocks):
            scope, dilation = kernel_size - 1, 1
            for _ in range(layers):
                for convs in (self.filter_convs, self.gate_convs):
                    convs.append(nn.Conv2d(residual_channels,
                                           dilation_channels,
                                           (1, kernel_size),
                                           dilation=dilation))
                self.skip_convs.append(nn.Conv2d(dilation_channels,
                                                 skip_channels, (1, 1)))
                self.bn.append(nn.BatchNorm2d(residual_channels))
                self.gconv.append(_GCN(dilation_channels, residual_channels,
                                       3, order))
                dilation *= 2
                receptive += scope
                scope *= 2
        self.receptive_field = receptive
        self.end_conv_1 = nn.Conv2d(skip_channels, end_channels, (1, 1))
        self.end_conv_2 = nn.Conv2d(end_channels, output_time_frame, (1, 1))
        # the engine hands over a generator on its device, seeded seed + 1
        self.dropout = NodeOrderDropout(
            dropout, torch.Generator().manual_seed(seed + 1), self.order)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator``, in
        ``named_parameters`` order."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("nodevec"):
                    p.normal_(generator=generator)
                elif name.startswith("bn."):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    conv = self.get_submodule(name.rsplit(".", 1)[0])
                    fan_in = conv.weight[0].numel()
                    bound = 1.0 / math.sqrt(fan_in)
                    p.uniform_(-bound, bound, generator=generator)
            for bn in self.bn:
                bn.reset_running_stats()

    # -- the layers ---------------------------------------------------------

    def _adaptive(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        """The adaptive support in the inner order."""
        e1 = e1.index_select(0, self.order)
        e2 = e2.index_select(1, self.order)
        return F.softmax(F.relu(torch.mm(e1, e2)), dim=1)

    def _tcn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.filter_convs[i](x)) * torch.sigmoid(
            self.gate_convs[i](x))

    def _gcn(self, i: int, h: torch.Tensor, adp: torch.Tensor,
             ops: dense.Operands) -> torch.Tensor:
        """``model.py``'s ``gcn`` of layer ``i`` on ``h`` (N, C, V, L);
        ``ops``: adp as the dense hop's kernels read it."""
        n, c, v, length = h.shape
        # node-major (Vp, N*C*L), the padded rows zero
        hp = F.pad(h.permute(2, 0, 1, 3),
                   (0, 0, 0, 0, 0, 0, 0, self.padded - v))
        hp = hp.reshape(1, self.padded, n * c * length)
        hops = []
        for k, (rows, cols) in enumerate(self.support_blocks):
            adj, z = getattr(self, f"support_{k}"), hp
            adj_t = getattr(self, f"support_{k}_t")
            for _ in range(self.order_hops):
                z = sparse.block_spmm(adj, z, rows, cols, self.block,
                                      adj_t=adj_t)
                hops.append(z[0, :v])
        z = hp[0, :v]
        for _ in range(self.order_hops):
            z = dense.dense_hop(adp, z, ops)
            hops.append(z)
        cat = torch.cat([h] + [z.view(v, n, c, length).permute(1, 2, 0, 3)
                               for z in hops], dim=1)
        return self.dropout(self.gconv[i].mlp.mlp(cat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, V, C_in) in the caller's node order -> (N,
        output_time_frame, V), the same order."""
        x = x.index_select(2, self.order).permute(0, 3, 2, 1)
        if x.shape[3] < self.receptive_field:
            x = F.pad(x, (self.receptive_field - x.shape[3], 0))
        x = self.start_conv(x)
        adp = profiling.spanned("gwnet.adaptive", self._adaptive,
                                self.nodevec1, self.nodevec2)
        ops = dense.Operands(adp)
        skip = None
        for i in range(self.layer_count):
            residual = x
            h = profiling.spanned("gwnet.tcn",
                                  lambda r, i=i: self._tcn(i, r), residual)
            s = self.skip_convs[i](h)
            skip = s if skip is None else s + skip[..., -s.shape[3]:]
            h = profiling.spanned("gwnet.diffusion",
                                  lambda a, b, i=i: self._gcn(i, a, b, ops),
                                  h, adp)
            x = self.bn[i](h + residual[..., -h.shape[3]:])
        x = F.relu(self.end_conv_1(F.relu(skip)))
        x = self.end_conv_2(x)[..., -1]
        return x.index_select(2, self.inverse)


def build(**opts) -> GWNet:
    """:class:`GWNet` from a configuration's model options: its
    hyper-parameters are the block ``opts["gwnet"]``."""
    kwargs = dict(opts.get("gwnet", {}))
    for k in ("name", "load", "ckpt"):
        kwargs.pop(k, None)
    return GWNet(**kwargs)
