"""Device kernels a profiled training step launches: the DSTD-GC kernels,
the bf16 casts and every small PyTorch kernel between them, per step."""


def read(run):
    if run.trace is None or not run.profiled:
        return None
    count = len(run.trace.kernels())
    return count / run.profiled if count else None
