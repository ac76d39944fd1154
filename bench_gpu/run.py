#!/usr/bin/env python3
"""Run one benchmark cell of the port once and print its result line.

    python3 bench_gpu/run.py --workload h36m_tpu.train --seed 7 \
        --seconds 30 --trace 0

The cell (``workloads`` of ``BENCHMARK.json`` at the checkout's root)
names a configuration file and a traffic mix; the mix
(``bench_gpu/traffic/<name>.json``) names its loop
(``bench_gpu/loops/<loop>.py``); the limits of ``correct`` are the table
of the loop at the configuration's stated precision
(``bench_gpu/limits/<loop>.<precision>.json``); each metric is a reader
of its own, an end-to-end one in ``bench_gpu/end_to_end/<name>.py`` and a
per-layer one in ``bench_gpu/metrics/<name>.py`` (a ``read(run)``
function each).  A run: set-up (kernel builds, weights and inputs from the
seed, the checked steps, warm-up); a window of ``--seconds`` through the
program's own loop; with ``--trace 1``, or an end-to-end metric whose
``source`` is ``device_trace``, a profiled part after the window;
the loop's checked work after the window; the comparison with the plain
reference once the program's state is freed.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, ``breakdown`` (traced runs) and last
``checks``, each compared number beside its limit, which also end standard
error.

Without a CUDA device, or with fewer than the cell asks for, or without a
limits table for the cell, the run exits with code 2 and prints no result.
Caches (``TORCH_EXTENSIONS_DIR``, ``TRITON_CACHE_DIR``,
``CUDA_CACHE_PATH``) are kept under ``.bench_cache/`` in the checkout; the
port builds its kernel libraries into its own ``build/`` directory there.
"""

import time

T_START = time.perf_counter()

import argparse                                              # noqa: E402
import gc                                                    # noqa: E402
import importlib                                             # noqa: E402
import importlib.util                                        # noqa: E402
import json                                                  # noqa: E402
import math                                                  # noqa: E402
import os                                                    # noqa: E402
import sys                                                   # noqa: E402
import types                                                 # noqa: E402
from pathlib import Path                                     # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script: import the harness as the package ``bench_gpu`` from the
# checkout's root, not its modules from this directory
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
#: modules that may not be loaded in a run (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "dstdgcn_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(root: Path, workload: str) -> dict:
    """The cell, its configuration and traffic mix, and the metrics it
    reports, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "bench_gpu"
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(cell=cell, config=json.loads((root / conf["file"])
                                             .read_text()),
                traffic=traffic, root=root,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def load_reader(root: Path, kind: str, name: str):
    """The reader module of metric ``name``: ``kind`` "end_to_end" or
    "metrics" (per-layer)."""
    path = root / "bench_gpu" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_gpu.{kind}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_caches(root: Path) -> None:
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def _finite(x):
    """A number for the result line: None where it is not finite."""
    return x if math.isfinite(x) else None


def read_metrics(root: Path, kind: str, entries, ns) -> dict:
    """{name: {value, unit}} of the metrics ``entries`` that their readers
    find something to read in (``ns``: :func:`reading`)."""
    out = {}
    for m in entries:
        value = load_reader(root, kind, m["name"]).read(ns)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


class Harness:
    """What a loop needs of the run."""

    def __init__(self, torch, loaded, seed, seconds, device, timed=True,
                 fault=None, keep_all=False):
        self.torch = torch
        self.config = loaded["config"]
        self.traffic = loaded["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.timed = timed
        self.fault = fault
        self.keep_all = keep_all
        #: seconds of each set-up phase, in order (:meth:`mark`)
        self.phases = {}
        self._last = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Close a set-up phase: the seconds since the last mark."""
        now = time.perf_counter()
        self.phases[phase] = now - self._last
        self._last = now


def reading(h, loop, win, trace=None, profiled=0, setup_s=None):
    """The namespace a metric reader gets."""
    from bench_gpu import costs
    cfg = h.config
    model = cfg["model"][cfg["model"]["name"]]
    bf16 = cfg.get("precision") == "bfloat16"
    return types.SimpleNamespace(
        trace=trace, profiled=profiled, window=win, setup_s=setup_s,
        config=cfg, traffic=h.traffic, costs=costs, model=model,
        batch=int(cfg[loop.BATCH_KEY]),
        frames=int(model["input_time_frame"])
        + int(model["output_time_frame"]),
        joints=int(model["joints_to_consider"]), bf16=bf16,
        directions=2 if cfg["engine"].get("inverse") else 1,
        peak_flops=costs.PEAK_BF16_FLOPS if bf16
        else costs.PEAK_F32_DOT_FLOPS)


def host_use() -> dict:
    """This process's CPU seconds, involuntary context switches and
    garbage collections so far: read before and after the window, they
    show what the host did to a slow run."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(cpu_s=ru.ru_utime + ru.ru_stime, preempted=ru.ru_nivcsw,
                gc=sum(g["collections"] for g in gc.get_stats()))


def mark_ops(torch, model):
    """Mark every DSTD-GC op module's forward as ``bench.dstd_op`` in the
    profiler; returns the hook handles."""
    from bench_gpu import program
    handles = []
    for m in program.op_modules(model):
        def pre(mod, args):
            mod._bench_span = torch.profiler.record_function(
                "bench.dstd_op")
            mod._bench_span.__enter__()

        def post(mod, args, out):
            mod._bench_span.__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    return handles


def run(argv=None, root: Path = ROOT, device: str = None, fault=None,
        out=None, err=None) -> int:
    """One run; returns the exit code.  ``device`` "cpu" skips the look
    for a card (the harness's tests), ``fault`` is applied to the engine
    before its first step."""
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    loaded = load_cell(root, args.workload)
    chips = int(loaded["cell"].get("chips", 1))
    loop_name = loaded["traffic"]["loop"]
    precision = loaded["config"]["precision"]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from bench_gpu import check
    if not check.limits_file(loop_name, precision, root).is_file():
        print(f"no limits for the {loop_name} loop at {precision}: "
              f"{check.limits_file(loop_name, precision, root)}", file=err)
        return 2
    table = check.limits(loop_name, precision, root)
    set_caches(root)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark measures the card",
                  file=err)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                  f"for {chips}", file=err)
            return 2
        device = "cuda"
    else:
        # the CPU launches no kernel: nothing to read the variants from
        table.pop("off_precision_share", None)
    from bench_gpu import devtrace, program
    loop = importlib.import_module(f"bench_gpu.loops.{loop_name}")
    h = Harness(torch, loaded, args.seed, args.seconds, device, fault=fault)
    h.phases["start"] = h._last - T_START

    st = loop.setup(h)
    if device != "cpu":
        torch.cuda.synchronize()
    program.reset_launch_counts()
    setup_s = time.perf_counter() - T_START
    use0 = host_use()
    win = loop.window(h, st)
    use1 = host_use()
    counts = {k: v for k, v in program.launch_counts().items() if v}
    mem = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    walls = sorted(win.get("walls", []))
    host = {k: use1[k] - use0[k] for k in use0}
    if walls:
        host.update(step_ms_median=1e3 * walls[len(walls) // 2],
                    step_ms_max=1e3 * walls[-1])
    print("set-up s: " + json.dumps(h.phases), file=err)
    print("window: " + json.dumps({k: v for k, v in win.items()
                                   if k != "walls"}), file=err)
    print("window host: " + json.dumps(host), file=err)
    print("launches in the window: " + json.dumps(counts), file=err)
    numbers = {"off_precision_share": check.off_precision_share(
        counts, precision, program.launch_variant)}

    def profiled(marks: bool):
        """(the trace of ``trace_steps`` more steps or batches of the
        window's loop, their count, the host seconds it took)"""
        count = int(h.traffic["trace_steps"])
        handles = mark_ops(torch, st["engine"].model) if marks else []
        spent = {}
        tr = devtrace.profile(torch, lambda: loop.traced(h, st, count),
                              seconds=spent) \
            if device != "cpu" else devtrace.Trace([])
        for hd in handles:
            hd.remove()
        return tr, count, spent

    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        tr, count, spent = profiled(loop.OP_MARKS)
        t0 = time.perf_counter()
        metrics = read_metrics(root, "metrics", loaded["per_layer"],
                               reading(h, loop, win, tr, count))
        dev_extra = dict(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = dict(device_ops=tr.top_device_ops(),
                         idle_gaps=tr.idle_gaps())
        spent["metrics"] = time.perf_counter() - t0
        print("trace s: " + json.dumps(spent), file=err)
    else:
        # an end-to-end metric read from the device's trace: the same
        # profiled part as a traced run's, after the window
        tr, count = None, 0
        if any(m["source"] == "device_trace" for m in loaded["end_to_end"]):
            tr, count, spent = profiled(False)
            print("device trace: " + json.dumps(dict(
                spent, steps=count, busy_s=tr.busy_s(),
                window_s=tr.window_s)), file=err)
        metrics = read_metrics(root, "end_to_end", loaded["end_to_end"],
                               reading(h, loop, win, tr, count,
                                       setup_s=setup_s))
    loop.after_window(h, st)

    found = forbidden_modules()
    if found:
        print("forbidden modules loaded in this run: " + ", ".join(found),
              file=err)
        return 3
    loop.release(st)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    numbers.update(loop.verify(h, st)[0])
    ok, checks = check.judge(numbers, table)
    correct = bool(ok and win["failed"] == 0 and win["attempted"] > 0)
    result = dict(correct=correct, attempted=win["attempted"],
                  failed=win["failed"], metrics=metrics,
                  device=dict(platform="gpu" if device != "cpu" else "cpu",
                              kind=(torch.cuda.get_device_name(0)
                                    if device != "cpu" else "cpu"),
                              count=chips, memory_peak_bytes=int(mem),
                              **dev_extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: dict(value=_finite(c["value"]), limit=c["limit"])
                        for k, c in checks.items()}
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(run())
