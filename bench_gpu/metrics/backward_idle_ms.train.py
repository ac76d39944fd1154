"""Milliseconds a profiled training step in which no device operation ran
while the engine was inside its ``engine.backward`` span: the card waiting
on autograd's host work (``zero_grad``, the backward nodes, the zero-fill
of unreached leaves), per step."""

from bench_gpu import spans

SPAN = "engine.backward"


def read(run):
    return spans.per_step_ms(run, spans.idle_s(run.trace, SPAN))
