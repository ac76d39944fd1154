"""Device milliseconds a profiled training step spends on what its forward
phase launched: the kernels, copies and fills whose launch call starts
inside the engine's ``engine.forward`` span (inputs to the device, both
directions' train-mode forwards, the losses and their total), per step."""

from bench_gpu import spans

SPAN = "engine.forward"


def read(run):
    return spans.per_step_ms(run, spans.device_s(run.trace, SPAN))
