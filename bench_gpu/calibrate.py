#!/usr/bin/env python3
"""Readings behind the limits of ``correct``, on the card at a cell's size.

    python3 bench_gpu/calibrate.py --workload h36m_tpu.train \
        --seeds 101 102 103 --seconds 10 --out cal.jsonl

For each seed, in one process, a run as the benchmark makes it with a
window of ``--seconds`` (no warm-up, no trace), then:

* ``program``: the port's numbers against the float32 reference (the
  lower readings);
* ``control``: the reference computed in fp8 (e4m3, the precision below
  the configuration's bf16) in the program's place (the upper readings);
  after a training window it follows the program's state, as the
  reference does;
* ``ref_bf16``: the reference at bf16 in the program's place (how far the
  stated precision alone reads);
* one entry per fault of the cell's loop (``faults.BY_LOOP``, or those
  named by ``--faults``), planted in the program.

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

from bench_gpu import check, faults, reference, run  # noqa: E402


def readings(loaded, seed: int, device: str, seconds: float,
             fault_names=None, faults_only: bool = False) -> dict:
    import torch
    import importlib
    loop = loaded["traffic"]["loop"]
    mod = importlib.import_module(f"bench_gpu.loops.{loop}")
    out = dict(seed=seed)

    def sound(fault=None):
        h = run.Harness(torch, loaded, seed, seconds, device, timed=False,
                        fault=fault, keep_all=True)
        st = mod.setup(h)
        mod.window(h, st)
        mod.after_window(h, st)
        mod.release(st)
        if device != "cpu":
            torch.cuda.empty_cache()
        return h, st

    t0 = time.perf_counter()
    if not faults_only:
        _sides(out, mod, loop, seed, device, *sound())
    for name, fault in faults.BY_LOOP[loop].items():
        if fault_names is not None and name not in fault_names:
            continue
        hf, stf = sound(fault)
        out[name], ref_f = mod.verify(hf, stf)
        if loop == "train":
            out["spread"] = out.get("spread", {})
            out["spread"][name] = check.train_spread(stf["readings"],
                                                     ref_f[0])
    out["seconds"] = time.perf_counter() - t0
    return out


def _sides(out, mod, loop, seed, device, h, st) -> None:
    """The program's, the control's and the bf16 reference's numbers of one
    sound run into ``out``."""
    numbers, ref = mod.verify(h, st)
    out["program"] = numbers
    if loop == "train":
        pre, post = ref
        out["spread"] = dict(program=check.train_spread(st["readings"], pre))
        for name, q in (("control", reference.fp8),
                        ("ref_bf16", reference.bf16)):
            low = reference.train_steps(h.config, seed, st["rows"], device, q)
            low_post = reference.train_steps(h.config, seed, st["post_rows"],
                                             device, q,
                                             start=st["post_start"])
            out[name] = check.train_numbers(low, pre)
            out[name].update(check.train_numbers(low_post, post, "post_"))
            out["spread"][name] = check.train_spread(low, pre)
    else:
        out["control"] = mod.verify(h, st, None, reference.fp8)[0]
        out["ref_bf16"] = mod.verify(h, st, None, reference.bf16)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window before the later checked steps")
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to plant (default: every one)")
    ap.add_argument("--faults-only", action="store_true",
                    help="read the faults alone")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loaded = run.load_cell(HERE.parent, args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            line = dict(workload=args.workload, **readings(
                loaded, seed, args.device, args.seconds, args.faults,
                args.faults_only))
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
