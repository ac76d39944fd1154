"""Model FLOP utilization of the evaluation window: the contraction
operations of the forward (``costs.model_flops``) times the sequences
evaluated, over the window's seconds times the card's peak for the stated
precision."""


def read(run):
    if not run.window.get("samples") or not run.window.get("seconds"):
        return None
    flops = run.costs.model_flops(run.model, 1, run.frames, run.joints)
    return 100.0 * flops * run.window["samples"] / (
        run.window["seconds"] * run.peak_flops)
