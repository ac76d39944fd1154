"""Share of their bound that a training step's block-sparse SpMM calls
(kernel 7) reach: the least time of the step's calls
(``costs_gwnet.spmm_bound_s``: each hop's forward on the road supports'
patterns and each hop's ``d_x`` on their transposed patterns, the active
blocks the program's patterns hold) over the device time of everything
whose launch call starts inside the program's ``sparse.spmm`` spans, on
any thread (``launched.device_s``), per step.  None where the program names
no such span or has no block pattern."""

from bench_gpu import costs_gwnet, launched

SPAN = "sparse.spmm"


def read(run):
    if run.trace is None or not run.profiled:
        return None
    blocks = run.window.get("spmm_blocks")
    seconds, count = launched.device_s(run.trace, SPAN)
    if not blocks or not count or seconds <= 0:
        return None
    bound = costs_gwnet.spmm_bound_s(run.model, run.batch, blocks,
                                     run.window["block"],
                                     run.window["padded"])
    return 100.0 * bound * run.profiled / seconds
