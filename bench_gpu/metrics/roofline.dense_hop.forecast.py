"""Share of their bound that a training step's dense adaptive hops reach:
the least time of the step's hop products (:func:`bound_s`) over the
device time of everything whose launch call starts inside the program's
``dense.hop`` spans, on any thread (``launched.device_s``), per step.
None where the program names no such span."""

from bench_gpu import costs, costs_gwnet, launched

SPAN = "dense.hop"


def bound_s(model: dict, batch: int) -> float:
    """Least seconds of a step's dense hop products: each of ``order``
    hops of every layer's forward, and its ``d_x`` and ``d_adp`` in every
    layer the backward reaches (all but the last), each reading the
    (V, V) adjacency and a (V, F) operand and writing a (V, F) or (V, V)
    result, ``4 (V^2 + 2 V F)`` bytes, and doing ``2 V^2 F`` products at
    the float32-accurate tensor-core rate (3xTF32); F = batch x dilation
    channels x the layer's length."""
    v = int(model["joints_to_consider"])
    d = int(model.get("dilation_channels", 32))
    hops = int(model.get("order", 2))
    lens = costs_gwnet.lengths(model, int(model["input_time_frame"]))
    total = 0.0
    for i, length in enumerate(lens):
        f = batch * d * length
        one = max(4.0 * (v * v + 2 * v * f) / costs.PEAK_BYTES,
                  2.0 * v * v * f / costs.PEAK_F32_DOT_FLOPS)
        products = 3 if i < len(lens) - 1 else 1
        total += hops * products * one
    return total


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = launched.device_s(run.trace, SPAN)
    if not count or seconds <= 0:
        return None
    return 100.0 * bound_s(run.model, run.batch) * run.profiled / seconds
