"""Milliseconds a profiled training step in which no device operation ran
while the engine was inside its ``engine.forward`` span: the card waiting
on the host's forward (inputs to the device, both directions' forwards,
the losses), per step."""

from bench_gpu import spans

SPAN = "engine.forward"


def read(run):
    return spans.per_step_ms(run, spans.idle_s(run.trace, SPAN))
