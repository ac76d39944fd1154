"""Model FLOP utilization of a Graph WaveNet training step on the card: the
model FLOPs of a step (``costs_gwnet.step_flops``: the adaptive support's
dense products forward and for both gradients, the road supports' useful
``2 nnz F`` forward and for ``d_x``, the convolutions forward and for both
gradients) times the profiled steps, over the device's busy seconds in
their trace times the card's peak for the stated precision (float32:
``costs.PEAK_F32_DOT_FLOPS``)."""

from bench_gpu import costs_gwnet


def read(run):
    if run.trace is None or not run.profiled or not run.trace.device:
        return None
    nnz = run.window.get("road_nnz")
    busy = run.trace.busy_s()
    if not nnz or busy <= 0:
        return None
    flops = costs_gwnet.step_flops(run.model, run.batch, nnz)
    return 100.0 * flops * run.profiled / (busy * run.peak_flops)
