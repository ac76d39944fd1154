"""Operations and bytes of the DSTD-GC ops, from shapes, and the H100's peaks.

A frozen copy of ``chip_smoke.py::op_cost``, ``op_weights`` and
``bound_of`` (the port's correctness script), so that a later change to
that script cannot move the yardstick.  Peaks are NVIDIA's published data
sheet figures of one H100 SXM at its 700 W limit, dense rates.

``model_ops`` lists the DSTD-GC op calls of one forward of a configuration
(in-layer, encoder layers, out-layer), and ``model_flops`` counts the
contraction operations of one forward: every DSTD-GC op's projections,
score mixing and aggregation (``op_cost``'s contraction count) and the
residual projections of the layers that change width.  Elementwise work
(tanh, BatchNorm, PReLU) is not counted, as model FLOPs count products.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 494.7e12    # dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12          # HBM3
#: float32-accurate contractions at their least time on this card: three
#: TF32 tensor-core products for each (3xTF32)
PEAK_F32_DOT_FLOPS = PEAK_TF32_FLOPS / 3


def op_weights(mode: str, ci: int, co: int, t: int, v: int) -> int:
    """Weight floats of one op (base, alpha, wf, bf, wm1, bm1, wm2, bm2,
    wrm, brm) at T = ``t``, V = ``v``."""
    k, r = (2 if mode == "spatial" else 1), 2
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    return (k * pair * pair + 1 + k * ci * co + k * co + 2 * k * ci * r
            + 2 * k * r + k * r * ref * ref + k * ref)


def op_cost(mode: str, n: int, ci: int, co: int, t: int, v: int,
            backward: bool = False, bf16: bool = True):
    """(flops, bytes, contraction flops, their peak) one call needs: every
    input read once, every output written once; tanh and the pair
    difference count one op each.  The backward recomputes the forward up
    to the adjacency, then does the dA and dxf products, dalpha / dbase /
    dbrm, dx from dxf, dwf / dbf, dwrm, ds, du, the dq / dk sums, dx from
    dq / dk and dwqk / dbqk; it reads x, g and the weights and writes dx and
    the weight gradients.  Contractions run at the tensor cores' rate for
    the dtype (bf16: dense bf16; float32: 3xTF32), the rest at the float32
    rate; the bytes are float32 inputs and outputs, but for the bf16
    forward, which reads x as bf16."""
    k = 2 if mode == "spatial" else 1
    r = 2
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    rows = n * t * v
    scores = n * k * r * ref * pair * pair          # score entries
    adj = n * k * ref * pair * pair                 # adjacency entries
    proj = 2 * rows * ci * co * k                   # feature projection
    qk = 2 * rows * ci * 2 * r * k                  # q/k projections
    mix = 2 * scores * ref                          # frame/joint mixing
    agg = 2 * adj * co                              # aggregation
    weights = op_weights(mode, ci, co, t, v)
    if not backward:
        dots = proj + qk + mix + agg
        rest = 2 * scores + 2 * adj
        x_bytes = 2 if bf16 else 4
        nbytes = x_bytes * rows * ci + 4 * (rows * co + weights)
    else:
        dots = (proj + qk + mix                      # recompute
                + 2 * agg                            # dA, dxf
                + 2 * proj                           # dx(dxf), dwf
                + 2 * mix                            # dwrm, ds
                + 2 * qk)                            # dx(dqk), dwqk
        rest = (2 * scores + 2 * adj                 # recompute
                + 3 * adj                            # dalpha, dbase, dbrm
                + rows * co * k                      # dbf
                + 3 * scores + 2 * scores            # du, dq / dk sums
                + rows * 2 * r * k)                  # dbqk
        nbytes = 4 * (2 * rows * ci + rows * co + 2 * weights)
    return rest, nbytes, dots, (PEAK_BF16_FLOPS if bf16
                                else PEAK_F32_DOT_FLOPS)


def bound_of(flops, nbytes, dot_flops=0.0, dot_peak=PEAK_F32_DOT_FLOPS):
    """(least seconds, seconds of the operations, seconds of the bytes):
    ``flops`` (elementwise) at the float32 rate, ``dot_flops`` (the
    contractions) at ``dot_peak``, bytes at the HBM rate."""
    t_ops = flops / PEAK_F32_FLOPS + dot_flops / dot_peak
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem), t_ops, t_mem


def model_ops(model: dict, t: int, v: int) -> List[Tuple[str, int, int]]:
    """(mode, Ci, Co) of every DSTD-GC op call of one forward of the model
    block ``model`` (``input_channels``, ``num_feature``, ``num_layers``):
    the in-layer (Ci -> F), ``num_layers`` encoder layers (F -> F) and the
    out-layer (F -> Ci / 2); each layer a spatial op Ci -> Co, then a
    temporal op Co -> Co."""
    cin, f, layers = (int(model["input_channels"]), int(model["num_feature"]),
                      int(model["num_layers"]))
    widths = [(cin, f)] + [(f, f)] * layers + [(f, cin // 2)]
    ops = []
    for ci, co in widths:
        ops += [("spatial", ci, co), ("temporal", co, co)]
    return ops


def model_flops(model: dict, n: int, t: int, v: int) -> float:
    """Contraction operations of one forward of ``n`` samples: the DSTD-GC
    ops' and the residual projections of the layers whose width changes
    (``2 * rows * Ci * Co`` each)."""
    total = 0.0
    for mode, ci, co in model_ops(model, t, v):
        total += op_cost(mode, n, ci, co, t, v)[2]
    cin, f = int(model["input_channels"]), int(model["num_feature"])
    total += 2 * n * t * v * (cin * f + f * (cin // 2))
    return total


def ops_bound_s(model: dict, n: int, t: int, v: int, backward: bool,
                bf16: bool = True) -> float:
    """Least seconds of the DSTD-GC op calls of one forward (or of their
    backward calls) of ``n`` samples."""
    return sum(bound_of(*op_cost(mode, n, ci, co, t, v, backward, bf16))[0]
               for mode, ci, co in model_ops(model, t, v))
