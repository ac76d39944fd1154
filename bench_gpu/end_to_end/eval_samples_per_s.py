"""Sequences evaluated in the window over the window's seconds."""


def read(run):
    return run.window["samples"] / run.window["seconds"]
