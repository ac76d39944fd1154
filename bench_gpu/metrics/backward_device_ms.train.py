"""Device milliseconds a profiled training step spends on what its backward
phase launched: the kernels, copies and fills whose launch call starts
inside the engine's ``engine.backward`` span, on any host thread (autograd
launches the backward pass from its device thread while the engine waits
in the span: ``zero_grad``, the backward pass, the zero-fill of unreached
leaves), per step."""

from bench_gpu import spans

SPAN = "engine.backward"


def read(run):
    return spans.per_step_ms(run, spans.device_s(run.trace, SPAN))
