"""Host milliseconds a profiled training step spends inside PyTorch
operations and launch calls, summed over the host threads (the engine's
thread and autograd's), per step."""


def read(run):
    if run.trace is None or not run.profiled or not run.trace.host:
        return None
    return 1e3 * run.trace.host_s() / run.profiled
