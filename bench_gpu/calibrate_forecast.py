#!/usr/bin/env python3
"""Readings behind the limits of the forecast loop, on the card at the
cell's size.

    python3 bench_gpu/calibrate_forecast.py --workload gwnet_gla.forecast \
        --seeds 101 102 103 --seconds 10 --out cal.jsonl

For each seed, in one process, a run as the benchmark makes it with a
window of ``--seconds`` (no warm-up, no trace), then:

* ``program``: the port's numbers against the float32 reference (the
  lower readings);
* ``control``: the reference computed with TF32 allowed for its products
  and convolutions (the precision below the configuration's float32) in
  the program's place, against the float32 reference (the upper
  readings), from the seed and, after the window, from the program's
  state, as the reference follows it;
* one entry per fault of ``faults_forecast.BY_NAME`` (or those named by
  ``--faults``), planted in the program.

Each entry also carries the spread of the leaf gaps (``check.train_spread``).
One JSON line per seed; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from bench_gpu import check, faults_forecast, run  # noqa: E402
from bench_gpu.loops import forecast  # noqa: E402


def readings(loaded, seed: int, device: str, seconds: float,
             fault_names=None) -> dict:
    import torch
    out = dict(seed=seed)

    def sound(fault=None):
        h = run.Harness(torch, loaded, seed, seconds, device, timed=False,
                        fault=fault, keep_all=True)
        st = forecast.setup(h)
        forecast.window(h, st)
        forecast.after_window(h, st)
        forecast.release(st)
        if device != "cpu":
            torch.cuda.synchronize()
            out.setdefault("memory_peak_bytes",
                           torch.cuda.max_memory_allocated())
            torch.cuda.empty_cache()
        return h, st

    t0 = time.perf_counter()
    h, st = sound()
    out["program"], (ref, ref_post) = forecast.verify(h, st)
    out["spread"] = dict(program=check.train_spread(st["readings"], ref))
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = forecast.reference_steps(h, st, st["rows"])
        ctl_post = forecast.reference_steps(h, st, st["post_rows"],
                                            st["post_start"])
    finally:
        forecast.reference_gwnet.strict_float32()
    out["control"] = check.train_numbers(ctl, ref)
    out["control"].update(check.train_numbers(ctl_post, ref_post, "post_"))
    out["spread"]["control"] = check.train_spread(ctl, ref)
    for name, fault in faults_forecast.BY_NAME.items():
        if fault_names is not None and name not in fault_names:
            continue
        hf, stf = sound(fault)
        out[name], (ref_f, _) = forecast.verify(hf, stf)
        out["spread"][name] = check.train_spread(stf["readings"], ref_f)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="gwnet_gla.forecast")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window before the later checked steps")
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to plant (default: every one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = HERE.parent
    loaded = run.load_cell(root, args.workload)
    run.set_caches(root)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            line = dict(workload=args.workload, **readings(
                loaded, seed, args.device, args.seconds, args.faults))
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
