"""The ``eval`` loop: the evaluation sweep through
``PredictionEngine.test``, one call per action's test windows, again and
again.

Set-up builds the engine from the seed, gives its BatchNorms running
statistics with training-mode forwards (no gradient) over the first
``statistics_batches`` test batches, as a trained model would hold them
(at their initial values the untrained model's activations grow layer by
layer and its predictions run to millions of millimetres), and warms every
shape with whole sweeps.  In the window a thin wrapper around the engine's
eval step keeps the answers (predictions and per-frame error sums) of a
sample of batches drawn from the seed; every ``test`` call's per-frame
errors are kept too.
After the window, with the engine freed, the reference computes every test
batch again and the kept answers are compared with it.
"""

from __future__ import annotations

import time

import numpy as np

from .. import check, program, reference, windows

#: the configuration key of the batch a ``test`` call runs
BATCH_KEY = "test_batch_size"
#: the traced part marks each DSTD-GC op module's forward (``bench.dstd_op``:
#: under ``inference_mode`` no autograd node names the forward ops)
OP_MARKS = True


def setup(h) -> dict:
    torch, cfg, tr = h.torch, h.config, h.traffic
    if h.device != "cpu":
        program.build_libraries(tr["libraries"])
    h.mark("kernel libraries")
    eng = program.make_engine(cfg, h.device)
    h.mark("model and engine")
    eng.init(h.seed)
    h.mark("weights")
    actions, per = int(tr["actions"]), int(tr["sequences_per_action"])
    batch = int(cfg[BATCH_KEY])
    pool = windows.Windows(cfg, h.seed, 2, actions * per)
    clock = windows.Deadline()
    loaders = windows.action_loaders(pool, actions, batch, clock)
    h.mark("inputs")
    stat_rows = _statistics_rows(loaders, int(tr.get("statistics_batches", 0)))
    if stat_rows:
        model = eng.model.train()
        with torch.no_grad():
            for rows in stat_rows:
                model(eng.transform(eng.to_device(pool.batch(rows)[0])))
        model.eval()
    h.mark("batch statistics")
    st = dict(engine=eng, pool=pool, clock=clock, loaders=loaders,
              stat_rows=stat_rows,
              active=loaders[0], kept=[], sweeps=[], keep=False,
              pick=windows.rng_of(h.seed, 4).random(1 << 16)
              < 1.0 / float(tr["sample_every"]),
              calls=0, max_kept=int(tr["max_kept"]), batch=batch)
    if h.fault is not None:
        h.fault(eng)
    step = eng._eval_step

    def sampled(*args, **kwargs):
        out = step(*args, **kwargs)
        c = st["calls"]
        st["calls"] = c + 1
        if st["keep"] and (st["pick"][c % len(st["pick"])]
                           or h.keep_all) \
                and len(st["kept"]) < st["max_kept"]:
            st["kept"].append((st["active"].current, out[1], out[0]))
        return out

    eng._eval_step = sampled
    for _ in range(int(tr["warmup_sweeps"]) if h.timed else 0):
        _sweep(h, st, record=False)
    if h.device != "cpu":
        torch.cuda.synchronize()
    h.mark("warm-up")
    return st


def _statistics_rows(loaders, count: int) -> list:
    """The rows of the first ``count`` test batches, in the sweep's order
    and round again: the batches whose training-mode forwards give the
    BatchNorms running statistics before the evaluation."""
    rows = [ld.rows[j * ld.batch_size:(j + 1) * ld.batch_size]
            for ld in loaders for j in range(len(ld))]
    return [rows[i % len(rows)] for i in range(count)]


def _statistics(h, st, params, rounding):
    """The reference's running statistics after the same forwards."""
    return reference.running_statistics(
        params, h.config, h.seed, [st["pool"].batch(r)
                                   for r in st["stat_rows"]],
        h.device, rounding)


def _test(h, st, loader):
    s = h.config["setting"]
    st["active"] = loader
    return st["engine"].test(
        loader, int(s["input_n"]), np.asarray(s["eval_frame"]),
        np.asarray(s["dim_used"]), np.asarray(s["joint_to_ignore"]),
        np.asarray(s["joint_to_equal"]), None, None)


def _sweep(h, st, record: bool, limit: int = None) -> tuple:
    """One call of ``test`` per action (until the deadline or ``limit``
    batches); returns (batches, samples, failed batches)."""
    batches = samples = failed = 0
    for a, loader in enumerate(st["loaders"]):
        if st["clock"].passed() or (limit is not None and batches >= limit):
            break
        _, per_frame = _test(h, st, loader)
        done = len(st["engine"].test_batch_seconds)
        batches += done
        samples += min(done * st["batch"], len(loader.rows))
        if not np.all(np.isfinite(per_frame)):
            failed += done
        if record and done:
            st["sweeps"].append((a, done, np.asarray(per_frame)))
    return batches, samples, failed


def window(h, st) -> dict:
    st["keep"] = True
    clock = st["clock"]
    batches = samples = failed = 0
    t0 = time.perf_counter()
    clock.at = t0 + h.seconds
    while not clock.passed():
        b, s, f = _sweep(h, st, record=True)
        batches, samples, failed = batches + b, samples + s, failed + f
    t1 = time.perf_counter()
    clock.at = None
    st["keep"] = False
    return dict(batches=batches, seconds=t1 - t0, samples=samples,
                attempted=batches, failed=failed)


def traced(h, st, count: int):
    """Run ``count`` more batches of the same sweeps (for the profiler)."""
    left = count
    while left > 0:
        b, _, _ = _sweep(h, st, record=False, limit=left)
        left -= b


def after_window(h, st) -> None:
    """Nothing: the window's own answers are compared."""


def release(st) -> None:
    st.pop("engine", None)


def verify(h, st, rounding=None, program_rounding=None) -> tuple:
    """The comparison numbers of the kept answers against the reference
    (``rounding``: the reference's precision, None for float32).  With
    ``program_rounding`` the reference at that precision stands in the
    program's place (the control)."""
    torch = h.torch
    if h.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = {k: v.to(h.device)
              for k, v in reference.init_params(h.config, h.seed).items()}
    pool = st["pool"]
    stats = _statistics(h, st, params, rounding)
    low = (None if program_rounding is None
           else _statistics(h, st, params, program_rounding))
    refs, sums = {}, {}
    wanted = {b for b, _, _ in st["kept"]}
    for loader in st["loaders"]:
        for j in range(len(loader)):
            b = loader.first + j
            rows = loader.rows[j * loader.batch_size:
                               (j + 1) * loader.batch_size]
            pred, metric, motion = reference.eval_batch(
                params, h.config, pool.batch(rows), h.device, rounding, stats)
            sums[b] = metric.double().cpu().numpy()
            if b in wanted:
                refs[b] = (pred, motion)
    kept = st["kept"]
    if program_rounding is not None:
        kept = []
        for b, _, _ in st["kept"]:
            loader = next(ld for ld in st["loaders"]
                          if ld.first <= b < ld.first + len(ld))
            j = b - loader.first
            rows = loader.rows[j * loader.batch_size:
                               (j + 1) * loader.batch_size]
            pred, metric, _ = reference.eval_batch(
                params, h.config, pool.batch(rows), h.device,
                program_rounding, low)
            kept.append((b, pred, metric))
    pg = 0.0
    for b, pred, _ in kept:
        want, motion = refs[b]
        out_motion = motion[:, int(h.config["setting"]["input_n"]):]
        pg = max(pg, check.pred_gap(pred, want, out_motion))
    if not kept:
        pg = float("inf")
    fg = 0.0
    sweeps = st["sweeps"]
    if program_rounding is not None:
        sweeps = []
        for a, loader in enumerate(st["loaders"]):
            pr = [reference.eval_batch(
                params, h.config, pool.batch(loader.rows[
                    j * loader.batch_size:(j + 1) * loader.batch_size]),
                h.device, program_rounding, low)[1].double().cpu().numpy()
                for j in range(len(loader))]
            sweeps.append((a, len(loader), sum(pr) / len(loader.rows)))
    for a, done, per_frame in sweeps:
        loader = st["loaders"][a]
        n = min(done * loader.batch_size, len(loader.rows))
        want = sum(sums[loader.first + j] for j in range(done)) / n
        fg = max(fg, check.mpjpe_gap(per_frame, want))
    if not sweeps:
        fg = float("inf")
    return dict(pred_gap=pg, mpjpe_gap=fg), None

