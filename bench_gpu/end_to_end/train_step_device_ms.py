"""Device milliseconds of one optimizer step: the union of the kernel,
copy and fill intervals in the profiler's trace of ``trace_steps`` steps
of the window's own loop, run right after the window, over those steps.
What a step costs the card, which the host's speed does not set."""


def read(run):
    if run.trace is None or not run.profiled or not run.trace.device:
        return None
    return 1e3 * run.trace.busy_s() / run.profiled
