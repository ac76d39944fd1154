"""Faults planted under the timed path, to show that ``correct`` catches
them (``calibrate.py`` reads them on the card, the harness's tests on the
CPU).  Each takes the engine before its first step."""

from __future__ import annotations


def frozen(engine) -> None:
    """A training step that returns its losses and leaves the model's state
    unchanged (no optimizer step)."""
    engine.train_step = (
        lambda inputs, inputs_inv, targets, *a, **k:
        engine.compute_gradients(inputs, inputs_inv, targets, *a, **k))


def half_batch(engine) -> None:
    """A training step on the first half of each batch, its mean taken over
    that half."""
    grads = engine.compute_gradients

    def half(inputs, inputs_inv, targets, *a, **k):
        n = len(inputs) // 2
        return grads(inputs[:n], inputs_inv[:n], targets[:n], *a, **k)

    engine.compute_gradients = half


def late_half_batch(engine, after: int = 11) -> None:
    """:func:`half_batch` from the ``after``-th step on (11: past the set-up's
    3 checked and 8 warm-up steps of the train mix), so the set-up's checked
    steps see a sound program: a change that acts only on the steady
    loop."""
    grads = engine.compute_gradients
    calls = [0]

    def late(inputs, inputs_inv, targets, *a, **k):
        calls[0] += 1
        if calls[0] <= after:
            return grads(inputs, inputs_inv, targets, *a, **k)
        n = len(inputs) // 2
        return grads(inputs[:n], inputs_inv[:n], targets[:n], *a, **k)

    engine.compute_gradients = late


def swapped_answer(engine) -> None:
    """An evaluation batch whose first two sequences' predictions are
    exchanged where the model's output is produced."""
    serve = engine._serve

    def swapped(*a, **k):
        out = serve(*a, **k).clone()
        out[[0, 1]] = out[[1, 0]]
        return out

    engine._serve = swapped


#: the faults each loop's cells can have
BY_LOOP = {"train": {"frozen": frozen, "half_batch": half_batch,
                     "late_half_batch": late_half_batch},
             "eval": {"swapped_answer": swapped_answer}}
