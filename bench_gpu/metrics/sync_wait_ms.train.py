"""Host milliseconds a profiled training step spends in the engine's
``engine.sync`` span: the step's synchronize and the losses' read-back,
the host waiting on the card, per step."""

from bench_gpu import spans

SPAN = "engine.sync"


def read(run):
    return spans.per_step_ms(run, spans.host_s(run.trace, SPAN))
