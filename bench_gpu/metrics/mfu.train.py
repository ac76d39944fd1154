"""Model FLOP utilization of a training step on the card: the contraction
operations of a step (``costs.model_flops``: the forward of both
directions under inverse training, the backward at twice the forward, no
recompute) times the profiled steps, over the device's busy seconds in
their trace times the card's peak for the stated precision."""


def read(run):
    if run.trace is None or not run.profiled or not run.trace.device:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    flops = 3 * run.directions * run.costs.model_flops(
        run.model, run.batch, run.frames, run.joints)
    return 100.0 * flops * run.profiled / (busy * run.peak_flops)
