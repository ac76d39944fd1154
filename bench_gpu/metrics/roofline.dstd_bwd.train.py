"""Share of their bound that the backward DSTD-GC op calls of a training
step reach: the least time of the step's backward op calls (from their
shapes, ``costs.op_cost``, both directions under inverse training) over
the device time of everything the autograd node ``_DSTDFunctionBackward``
launched (the backward kernels and the casts around them), whatever the
kernels are called."""

NODE = "_DSTDFunctionBackward"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = run.trace.device_s_under(NODE)
    if not count or seconds <= 0:
        return None
    bound = run.costs.ops_bound_s(run.model, run.batch, run.frames,
                                  run.joints, backward=True, bf16=run.bf16)
    return 100.0 * bound * run.directions * run.profiled / seconds
