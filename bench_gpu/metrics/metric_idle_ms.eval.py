"""Milliseconds a profiled evaluation batch in which no device operation ran
while the engine was inside its ``engine.eval_metric`` span: the card
waiting on the host's metric code (the sequences to the device, the index
tensors, the scatter, the ignored joints' copy, MPJPE), per batch."""

from bench_gpu import spans

SPAN = "engine.eval_metric"


def read(run):
    return spans.per_step_ms(run, spans.idle_s(run.trace, SPAN))
