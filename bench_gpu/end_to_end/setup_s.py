"""Seconds from the process's start to the first timed step: imports,
kernel builds, weights, inputs, the checked steps and the warm-up."""


def read(run):
    return run.setup_s
