"""Device milliseconds a profiled training step spends on what the graph
convolutions launched: every device operation whose launch call starts
inside the program's ``gwnet.diffusion`` spans (each layer's ``gcn``,
forward and backward), on any thread (``launched.device_s``, as
``spmm_device_ms.forecast`` reads its span), per step."""

from bench_gpu import launched

SPAN = "gwnet.diffusion"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    seconds, count = launched.device_s(run.trace, SPAN)
    if not count:
        return None
    return 1e3 * seconds / run.profiled
