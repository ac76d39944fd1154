"""Milliseconds a profiled training step in which no device operation ran
while the engine was inside its ``engine.optimizer`` span: the card
waiting on the clip's and the optimizer's host work, per step."""

from bench_gpu import spans

SPAN = "engine.optimizer"


def read(run):
    return spans.per_step_ms(run, spans.idle_s(run.trace, SPAN))
