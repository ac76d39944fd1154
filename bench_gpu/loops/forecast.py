"""The ``forecast`` loop: a closed loop of Graph WaveNet optimizer steps
through ``PredictionEngine.train``, epoch after epoch over a seeded traffic
series on the device.

Set-up draws the road graph (``forecast_data.road_graph`` with the
configuration's ``graph`` block, whose own seed fixes it: a deployment's
road network is the same in every run, so every run does the same work)
and builds the port's model on it and its engine
(``program.make_engine``: the model block with the graph's adjacency, the
engine block as configured), then compiles the
kernel libraries, draws the weights from the seed and the series
(``forecast_data.Series``), and drives the engine through the checked
steps and the warm-up with the window's own call (``engine.train``, the
reading's scaler as its ``scale_tsfm``).  After the window (and a traced
part) the same engine runs ``checked_steps`` more steps.  Of both sets the
objectives, the first step's gradient (from Adam's first moment before and
after it) and the parameters before and after are kept, and of the later
set the program's state before it (weights, Adam's moments and step count,
the dropout generator's state), which the reference follows from.  The
comparison (``reference_gwnet``, float32 with TF32 off, dense supports in
the caller's node order) runs once the engine is freed.

Besides ``check.train_numbers`` and ``adam_steps_missed`` the loop reads
``tf32_in_window``: 1 when cuBLAS or cuDNN was allowed TF32 at the
window's start or after any of its epochs (the configuration states
float32), else 0.  The window's dict also carries what the per-layer
readers count with: the road supports' nonzeros and the active blocks of
the SpMM's patterns in both directions, the block and the padded node
count.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import check, costs_gwnet, forecast_data, program, reference_gwnet

BATCH_KEY = "train_batch_size"
#: the traced part marks no op modules (the model names its own spans)
OP_MARKS = False
BETA1 = 0.9


def _hp(cfg) -> dict:
    return cfg["model"][cfg["model"]["name"]]


def _tf32() -> bool:
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def setup(h) -> dict:
    cfg, tr = h.config, h.traffic
    hp = _hp(cfg)
    v = int(hp["joints_to_consider"])
    adj = forecast_data.road_graph(v, **cfg["graph"])
    h.mark("graph")
    model_cfg = dict(cfg["model"])
    model_cfg[cfg["model"]["name"]] = dict(hp, adjacency=adj)
    eng = program.make_engine(dict(cfg, model=model_cfg), h.device)
    h.mark("model and engine")
    if h.device != "cpu":
        program.build_libraries(tr["libraries"])
    h.mark("kernel libraries")
    if h.fault is not None:
        h.fault(eng)
    eng.init(h.seed)
    h.mark("weights")
    ds = cfg["dataset"]
    series = forecast_data.Series(v, float(tr["days"]), h.seed,
                                  float(ds["missing"]),
                                  int(hp["input_time_frame"]),
                                  int(hp["output_time_frame"]), h.device)
    batch = int(cfg[BATCH_KEY])
    src = forecast_data.Stream(series, batch, h.seed)
    h.mark("inputs")
    st = dict(engine=eng, src=src, series=series, epoch=0, batch=batch,
              adj=adj, sizes=_sizes(eng.model, adj))
    st["readings"], st["rows"], _ = _checked(h, st)
    st["epoch"] = 1
    h.mark("checked steps")
    warm = int(tr.get("warmup_steps", 0)) if h.timed else 0
    while warm > 0:
        n = min(warm, len(src))
        eng.train(src, 0, None, series.scaler, None, n)
        warm -= n
    if h.device != "cpu":
        torch.cuda.synchronize()
    h.mark("warm-up")
    return st


def _sizes(model, adj) -> dict:
    """What the readers count with: the road supports' nonzeros (of the
    graph the harness drew) and the SpMM patterns' active blocks (of the
    program's patterns; none where the program has none)."""
    nnz = int(np.count_nonzero(adj))
    out = dict(road_nnz=[nnz, nnz])
    pats = getattr(model, "support_blocks", None)
    if pats:
        block, padded = int(model.block), int(model.padded)
        out.update(block=block, padded=padded, spmm_blocks=dict(
            forward=[len(r) for r, _ in pats],
            backward=[costs_gwnet.transposed_blocks(r, c, padded // block)
                      for r, c in pats]))
    return out


def _state(eng, params, key: str) -> dict:
    state = eng.optimizer.state
    return {k: state[p][key].detach().cpu().clone()
            if key in state.get(p, {}) else torch.zeros(p.shape)
            for k, p in params.items()}


def _checked(h, st) -> tuple:
    """Run ``checked_steps`` steps of the window's own call and feed; returns
    (the readings the comparison reads, the batches' windows, the
    program's state before them)."""
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
        generator=eng.generator.get_state())
    losses = []
    step = eng.train_step
    own = "train_step" in vars(eng)

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(out["total"])
        return out

    eng.train_step = recording
    try:
        eng.train(src, st["epoch"], None, st["series"].scaler, None, 1)
        m1 = _state(eng, params, "exp_avg")
        grad1 = {k: (m1[k] - BETA1 * start["exp_avg"][k]) / (1 - BETA1)
                 for k in params}
        if count > 1:
            eng.train(src, st["epoch"], None, st["series"].scaler, None,
                      count - 1)
    finally:
        if own:
            eng.train_step = step
        else:
            del eng.train_step
    readings = dict(losses=[float(x) for x in losses], grad1=grad1,
                    p0=start["params"],
                    p_end={k: v.detach().cpu().clone()
                           for k, v in params.items()})
    return readings, src.fetched[first:first + count], start


def window(h, st) -> dict:
    eng, src = st["engine"], st["src"]
    eng.train_step_seconds = []
    failed, tf32 = 0, _tf32()
    t0 = time.perf_counter()
    src.deadline = t0 + h.seconds
    while time.perf_counter() < src.deadline:
        before = len(eng.train_step_seconds)
        avg = eng.train(src, st["epoch"], None, st["series"].scaler, None,
                        -1)
        st["epoch"] += 1
        tf32 = tf32 or _tf32()
        if not math.isfinite(avg):
            failed += len(eng.train_step_seconds) - before
    t1 = time.perf_counter()
    src.deadline = None
    st["tf32"] = tf32
    walls = list(eng.train_step_seconds)
    return dict(steps=len(walls), seconds=t1 - t0,
                samples=len(walls) * st["batch"], attempted=len(walls),
                failed=failed, walls=walls, **st["sizes"])


def traced(h, st, count: int):
    """Run ``count`` more steps of the same loop (for the profiler)."""
    eng, src = st["engine"], st["src"]
    left = count
    while left > 0:
        n = min(left, len(src))
        eng.train(src, st["epoch"], None, st["series"].scaler, None, n)
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


def reference_steps(h, st, rows, start=None) -> dict:
    """The reference's steps over the windows ``rows`` from the weights at
    the seed, or from the program's state ``start``."""
    hp = _hp(h.config)
    learn = h.config["engine"]["learn"]
    supports = [torch.from_numpy(s).to(h.device)
                for s in reference_gwnet.transitions(st["adj"])]
    series = st["series"]
    batches = [series.batch(idx)[::2] for idx in rows]
    gen = torch.Generator(h.device)
    if start is None:
        gen.manual_seed(h.seed + 1)
        p0, kw = reference_gwnet.init_params(hp, h.seed), {}
    else:
        gen.set_state(start["generator"])
        p0 = start["params"]
        kw = dict(exp_avg=start["exp_avg"], exp_avg_sq=start["exp_avg_sq"],
                  steps=start["steps"])
    return reference_gwnet.train_steps(
        p0, hp, supports, batches, (series.scaler.mean, series.scaler.std),
        h.device, lr=float(learn["lr"]),
        weight_decay=float(learn.get("weight_decay", 0.0)),
        clip=float(h.config["engine"].get("clip", 5.0)), gen=gen, **kw)


def verify(h, st, tf32: bool = False) -> tuple:
    """(the comparison numbers of the kept readings against the reference,
    the reference's readings of the first and the later checked steps);
    ``tf32``: the reference with TF32 allowed (the control)."""
    if h.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = reference_steps(h, st, st["rows"])
        ref_post = reference_steps(h, st, st["post_rows"], st["post_start"])
    finally:
        if h.device != "cpu":
            reference_gwnet.strict_float32()
    numbers = check.train_numbers(st["readings"], ref)
    numbers.update(check.train_numbers(st["post"], ref_post, "post_"))
    numbers["adam_steps_missed"] = float(st["steps_missed"])
    numbers["tf32_in_window"] = float(st.get("tf32", False))
    return numbers, (ref, ref_post)
