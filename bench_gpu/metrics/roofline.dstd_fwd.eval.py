"""Share of their bound that the forward DSTD-GC op calls of an evaluation
batch reach: the least time of the batch's forward op calls (from their
shapes, ``costs.op_cost``) over the device time of everything launched
inside the DSTD-GC op modules' forwards (the forward kernels and the casts
around them; the harness marks each module's forward in the traced part,
``bench.dstd_op``), whatever the kernels are called."""

SPAN = "bench.dstd_op"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = run.trace.device_s_under(SPAN)
    if not count or seconds <= 0:
        return None
    bound = run.costs.ops_bound_s(run.model, run.batch, run.frames,
                                  run.joints, backward=False, bf16=run.bf16)
    return 100.0 * bound * run.profiled / seconds
