"""Sequences trained in the window over the window's seconds (a sequence
is one window of observed and predicted frames), on the host's clock.
Kept with no bound: the training loop is paced by the host, whose speed
drifts by some tenths over minutes on a shared machine."""


def read(run):
    return run.window["samples"] / run.window["seconds"]
