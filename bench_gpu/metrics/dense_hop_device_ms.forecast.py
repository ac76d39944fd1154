"""Device milliseconds a profiled training step spends in Graph WaveNet's
dense adaptive hops: every device operation whose launch call starts
inside the program's ``dense.hop`` spans, on any thread
(``launched.device_s``: the forward hops, their ``d_x`` and ``d_adp``
products and the adjacency's copies for them), per step.  None where the
program names no such span."""

from bench_gpu import launched

SPAN = "dense.hop"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = launched.device_s(run.trace, SPAN)
    if not count:
        return None
    return 1e3 * seconds / run.profiled
