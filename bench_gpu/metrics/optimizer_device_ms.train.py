"""Device milliseconds a profiled training step spends on what its
optimizer phase launched: the kernels, copies and fills whose launch call
starts inside the engine's ``engine.optimizer`` span (the clip by global
norm and the optimizer's step), per step."""

from bench_gpu import spans

SPAN = "engine.optimizer"


def read(run):
    return spans.per_step_ms(run, spans.device_s(run.trace, SPAN))
