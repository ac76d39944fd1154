"""The ``train`` loop: a closed loop of optimizer steps through
``PredictionEngine.train``, epoch after epoch over the benchmark's batch
source.

Set-up builds one engine (model, Adam state, dropout generator) from the
seed, drives it through the checked steps and the warm-up steps with the
window's own call (``engine.train``) and feed (:class:`windows.TrainStream`,
rows all different), and hands the same engine to the window.  After the
window (and a traced part) the same engine runs ``checked_steps`` more
steps.  Of both sets of checked steps the objectives, the first step's
gradient (from Adam's first moment before and after it) and the
parameters before and after are kept, and of the later set the program's
whole state before it, which the reference follows from.  The comparison
runs once the engine is freed.
"""

from __future__ import annotations

import math
import time

import torch

from .. import check, program, reference, windows

#: the configuration key of the batch a step runs
BATCH_KEY = "train_batch_size"
#: the traced part marks no op modules (the backward node is its own span)
OP_MARKS = False
#: Adam's first-moment decay (torch's default, which the engine uses)
BETA1 = 0.9


def setup(h) -> dict:
    torch, cfg, tr = h.torch, h.config, h.traffic
    if h.device != "cpu":
        program.build_libraries(tr["libraries"])
    h.mark("kernel libraries")
    eng = program.make_engine(cfg, h.device)
    h.mark("model and engine")
    if h.fault is not None:
        h.fault(eng)
    eng.init(h.seed)
    h.mark("weights")
    batch = int(cfg[BATCH_KEY])
    pool = windows.Windows(cfg, h.seed, 1, int(tr["pool_sequences"]))
    src = windows.TrainStream(pool, batch, h.seed)
    h.mark("inputs")
    st = dict(engine=eng, src=src, pool=pool, epoch=0, batch=batch)
    st["readings"], st["rows"], _ = _checked(h, st)
    st["epoch"] = 1
    h.mark("checked steps")
    warm = int(tr.get("warmup_steps", 0)) if h.timed else 0
    while warm > 0:
        n = min(warm, len(src))
        eng.train(src, 0, None, None, None, n)
        warm -= n
    if h.device != "cpu":
        torch.cuda.synchronize()
    h.mark("warm-up")
    return st


def _state(eng, params, key: str) -> dict:
    """Adam's ``key`` of each leaf, on the CPU (zeros before a step)."""
    state = eng.optimizer.state
    return {k: state[p][key].detach().cpu().clone()
            if key in state.get(p, {}) else torch.zeros(p.shape)
            for k, p in params.items()}


def _checked(h, st) -> tuple:
    """Run ``checked_steps`` steps of the window's own call and feed in
    epoch ``st["epoch"]``; returns (the readings the comparison reads, the
    rows of the steps, the program's state before them)."""
    eng, src = st["engine"], st["src"]
    count = int(h.traffic["checked_steps"])
    params = dict(eng.model.named_parameters())
    first = len(src.fetched)
    state = eng.optimizer.state
    start = dict(
        params={k: v.detach().cpu().clone() for k, v in params.items()},
        exp_avg=_state(eng, params, "exp_avg"),
        exp_avg_sq=_state(eng, params, "exp_avg_sq"),
        steps=min((int(float(state[p]["step"])) if "step" in state.get(p, {})
                   else 0) for p in params.values()),
        epoch=st["epoch"],
        forwards=first * (2 if h.config["engine"].get("inverse") else 1))
    losses = []
    step = eng.train_step
    own = "train_step" in vars(eng)   # a fault's step, kept after these

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(out["total"])
        return out

    eng.train_step = recording
    try:
        eng.train(src, st["epoch"], None, None, None, 1)
        m1 = _state(eng, params, "exp_avg")
        grad1 = {k: (m1[k] - BETA1 * start["exp_avg"][k]) / (1 - BETA1)
                 for k in params}
        if count > 1:
            eng.train(src, st["epoch"], None, None, None, count - 1)
    finally:
        if own:
            eng.train_step = step
        else:
            del eng.train_step
    readings = dict(losses=[float(x) for x in losses], grad1=grad1,
                    p0=start["params"],
                    p_end={k: v.detach().cpu().clone()
                           for k, v in params.items()})
    rows = [st["pool"].batch(idx) for idx in src.fetched[first:first + count]]
    return readings, rows, start


def window(h, st) -> dict:
    eng, src = st["engine"], st["src"]
    eng.train_step_seconds = []
    failed = 0
    t0 = time.perf_counter()
    src.deadline = t0 + h.seconds
    while time.perf_counter() < src.deadline:
        before = len(eng.train_step_seconds)
        avg = eng.train(src, st["epoch"], None, None, None, -1)
        st["epoch"] += 1
        if not math.isfinite(avg):
            failed += len(eng.train_step_seconds) - before
    t1 = time.perf_counter()
    src.deadline = None
    walls = list(eng.train_step_seconds)
    return dict(steps=len(walls), seconds=t1 - t0,
                samples=len(walls) * st["batch"], attempted=len(walls),
                failed=failed, walls=walls)


def traced(h, st, count: int):
    """Run ``count`` more steps of the same loop (for the profiler)."""
    eng, src = st["engine"], st["src"]
    left = count
    while left > 0:
        n = min(left, len(src))
        eng.train(src, st["epoch"], None, None, None, n)
        st["epoch"] += 1
        left -= n


def after_window(h, st) -> None:
    """The checked steps after the window, from the program's state."""
    fed = len(st["src"].fetched)
    st["post"], st["post_rows"], st["post_start"] = _checked(h, st)
    st["steps_missed"] = fed - st["post_start"]["steps"]


def release(st) -> None:
    st.pop("engine", None)
    st.pop("src", None)


def verify(h, st, rounding=None) -> tuple:
    """(the comparison numbers of the kept readings against the reference,
    the reference's readings of the first and the later checked steps);
    ``rounding``: the reference's precision, None for float32."""
    torch = h.torch
    if h.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference.train_steps(h.config, h.seed, st["rows"], h.device,
                                rounding)
    ref_post = reference.train_steps(h.config, h.seed, st["post_rows"],
                                     h.device, rounding,
                                     start=st["post_start"])
    numbers = check.train_numbers(st["readings"], ref)
    numbers.update(check.train_numbers(st["post"], ref_post, "post_"))
    numbers["adam_steps_missed"] = float(st["steps_missed"])
    return numbers, (ref, ref_post)
