"""Share of the profiled training steps' span in which no device operation
ran (one minus the union of kernel, copy and fill intervals over the
span)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
