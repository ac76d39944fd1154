"""Device milliseconds a profiled training step spends in the block-sparse
SpMM: every device operation whose launch call starts inside the
program's ``sparse.spmm`` spans, on any thread (``launched.device_s``:
kernel 7, the forward hops and their ``d_x``), per step."""

from bench_gpu import launched

SPAN = "sparse.spmm"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = launched.device_s(run.trace, SPAN)
    if not count:
        return None
    return 1e3 * seconds / run.profiled
