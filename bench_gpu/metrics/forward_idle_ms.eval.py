"""Milliseconds a profiled evaluation batch in which no device operation ran
while the engine was inside its ``engine.eval_forward`` span: the card
waiting on the host's forward (inputs to the device, the transform, the
model, the inverse), per batch."""

from bench_gpu import spans

SPAN = "engine.eval_forward"


def read(run):
    return spans.per_step_ms(run, spans.idle_s(run.trace, SPAN))
