"""Share of their bound that the forward DSTD-GC op calls of a training
step reach: the least time of the step's forward op calls (from their
shapes, ``costs.op_cost``, both directions under inverse training) over
the device time of everything launched inside the program's ``dstd.op``
spans (each op module's call: the forward kernel and the casts around
it), whatever the kernels are called."""

from bench_gpu import spans

SPAN = "dstd.op"


def read(run):
    seconds = spans.device_s(run.trace, SPAN)
    if not seconds or not run.profiled:
        return None
    bound = run.costs.ops_bound_s(run.model, run.batch, run.frames,
                                  run.joints, backward=False, bf16=run.bf16)
    return 100.0 * bound * run.directions * run.profiled / seconds
