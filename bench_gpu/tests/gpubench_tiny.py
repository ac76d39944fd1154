"""A tiny copy of the benchmark for the CPU tests: the same files, the
configurations cut to 8 features, one encoder layer and batch 8 at the
stated bf16 compute, the traffic mixes to a few batches."""

from __future__ import annotations

import io
import json
import shutil
import sys
from contextlib import redirect_stderr
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench_gpu import run  # noqa: E402

SEED = 3_000_000_017


def make_copy(dest: Path) -> Path:
    """A checkout-like directory at ``dest``: ``BENCHMARK.json`` and a cut
    copy of ``bench_gpu/`` (the port is imported from the repository)."""
    shutil.copytree(REPO / "bench_gpu", dest / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        hp = cfg["model"][cfg["model"]["name"]]
        hp.update(num_feature=8, num_layers=1, compute_dtype="bfloat16")
        cfg["train_batch_size"] = cfg["test_batch_size"] = 8
        path.write_text(json.dumps(cfg))
    cuts = dict(train=dict(pool_sequences=32, warmup_steps=1, trace_steps=2),
                eval=dict(actions=3, sequences_per_action=16,
                          sample_every=2, trace_steps=2,
                          statistics_batches=6))
    for name, cut in cuts.items():
        path = dest / "bench_gpu" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(cut)
        path.write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run_cell(root: Path, workload: str, fault=None, trace: int = 0,
             seconds: float = 0.5, seed: int = SEED):
    """(exit code, result dict or None, standard error) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stderr(err):
        rc = run.run(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)],
                     root=root, device="cpu", fault=fault, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
