"""Host milliseconds a profiled evaluation batch spends in the engine's
``engine.readback`` span: the metric's copy to the host, which waits on
the batch's device work, per batch."""

from bench_gpu import spans

SPAN = "engine.readback"


def read(run):
    return spans.per_step_ms(run, spans.host_s(run.trace, SPAN))
