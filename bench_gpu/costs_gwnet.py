"""Operations and bytes of a Graph WaveNet training step, from shapes.

The counts of the forecast cell's per-layer metrics, kept apart from
``costs.py`` (the DSTD-GCN yardstick), whose peaks they share.  Model FLOPs
count products, as ``costs.model_flops`` does (elementwise work, the
softmax and BatchNorm are not counted):

* the adaptive support's dense hops, ``2 V^2 F`` each (F = N C L: batch,
  channels, length of the layer), and ``E1 E2`` (``2 V^2 D``), forward;
  in the backward the same products again for each input's gradient;
* each road support's useful hops, ``2 nnz F`` forward and for ``d_x``
  (the support is constant: no gradient of its own);
* the convolutions, ``2 Ci k Co`` a position, forward and for each of
  the input's and the weights' gradients (the start convolution's input
  needs none).

The backward reaches every layer but the last one's graph convolution and
BatchNorm, whose output nothing reads (``model.py`` sums the skips alone
after the last layer).

The SpMM's bound (kernel 7, ``roofline.spmm.forecast``): a call of a
pattern of ``b`` active ``block x block`` blocks on ``F`` features of
``Vp`` padded nodes reads the active blocks and x and writes out,
``4 (b block^2 + 2 Vp F)`` bytes, and does ``2 b block^2 F`` products at
the float32-accurate tensor-core rate (3xTF32).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .costs import PEAK_BYTES, PEAK_F32_DOT_FLOPS


def lengths(model: dict, frames: int) -> List[int]:
    """The time length of each layer's output: the input padded to the
    receptive field, less each layer's dilation."""
    k = int(model.get("kernel_size", 2))
    dil = [2 ** i for _ in range(int(model.get("blocks", 4)))
           for i in range(int(model.get("layers", 2)))]
    length = max(frames, 1 + sum((k - 1) * d for d in dil))
    out = []
    for d in dil:
        length -= (k - 1) * d
        out.append(length)
    return out


def step_flops(model: dict, batch: int, road_nnz: Sequence[int]) -> float:
    """Model FLOPs of one training step (forward and backward) at
    ``batch``, the road supports' nonzeros ``road_nnz``."""
    v = int(model["joints_to_consider"])
    t_in = int(model["input_time_frame"])
    cin = int(model.get("in_dim", 3))
    r = int(model.get("residual_channels", 32))
    d = int(model.get("dilation_channels", 32))
    sk = int(model.get("skip_channels", 256))
    end = int(model.get("end_channels", 512))
    out = int(model["output_time_frame"])
    k = int(model.get("kernel_size", 2))
    emb = int(model.get("embedding", 10))
    hops = int(model.get("order", 2))
    lens = lengths(model, t_in)
    pos = batch * v
    rf = lens[0] + (k - 1)
    total = 2 * pos * rf * cin * r * 2            # start conv, no d_input
    total += 3 * 2 * v * v * emb                  # E1 E2 and its gradients
    for i, length in enumerate(lens):
        reached = i < len(lens) - 1
        f = batch * d * length
        adaptive = hops * 2 * v * v * f
        road = sum(hops * 2 * nnz * f for nnz in road_nnz)
        total += adaptive * (3 if reached else 1)
        total += road * (2 if reached else 1)
        tcn = 2 * 2 * pos * length * r * k * d    # filter and gate
        skip = 2 * pos * length * d * sk
        mlp = 2 * pos * length * (3 * hops + 1) * d * r
        total += 3 * (tcn + skip) + mlp * (3 if reached else 1)
    total += 3 * 2 * pos * (sk * end + end * out)  # the end convolutions
    return float(total)


def transposed_blocks(rows: np.ndarray, cols: np.ndarray, n_rows: int) \
        -> int:
    """Active blocks of the transposed pattern of ``(rows, cols)`` over
    ``n_rows`` block rows, every block row given at least one (as the
    port's ``active_blocks`` gives them)."""
    pairs = set(zip(np.asarray(cols).tolist(), np.asarray(rows).tolist()))
    return len(pairs) + n_rows - len({c for c, _ in pairs})


def spmm_bound_s(model: dict, batch: int, blocks: Dict[str, List[int]],
                 block: int, padded: int) -> float:
    """Least seconds of a step's kernel-7 calls: ``blocks["forward"]`` the
    active blocks of each road support's pattern (each hop of every
    layer's forward), ``blocks["backward"]`` those of their transposed
    patterns (each hop's ``d_x`` in every layer the backward reaches)."""
    d = int(model.get("dilation_channels", 32))
    hops = int(model.get("order", 2))
    lens = lengths(model, int(model["input_time_frame"]))
    total = 0.0
    for i, length in enumerate(lens):
        f = batch * d * length
        walks = list(blocks["forward"])
        if i < len(lens) - 1:
            walks += list(blocks["backward"])
        for b in walks:
            nbytes = 4.0 * (b * block * block + 2 * padded * f)
            flops = 2.0 * b * block * block * f
            total += hops * max(nbytes / PEAK_BYTES,
                                flops / PEAK_F32_DOT_FLOPS)
    return total
