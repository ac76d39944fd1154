"""The port's program spans (``utils/profiling.py::span``) on the CPU.

* a profiled train step of the DSTD-GCN (``PredictionEngine.train``, the
  kernel wrappers' CPU path, inverse training) holds one ``engine.step``
  span, and inside it ``engine.forward``, ``engine.backward``,
  ``engine.optimizer`` and ``engine.sync`` in that order; ``dstd.op``
  once per DSTD-GC op module per direction, all inside the forward;
* a profiled ``test`` batch holds ``engine.eval_forward``,
  ``engine.eval_metric`` and ``engine.readback`` in that order, and
  ``dstd.op`` once per op module inside the forward;
* with no profiler recording no span builds a
  ``torch.profiler.record_function`` (a counter in its place), and under
  the profiler every span builds one.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Loader, Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.models import get_model
from dstdgcn_tpu_torch.models.layers import DSTDGC
from dstdgcn_tpu_torch.utils import profiling
from dstdgcn_tpu_torch.utils.config import resolve

torch.set_num_threads(2)

BATCH = 8
STEP = ["engine.forward", "engine.backward", "engine.optimizer",
        "engine.sync"]
EVAL = ["engine.eval_forward", "engine.eval_metric", "engine.readback"]


def _engine():
    """The training slice's engine and model (kernel wrappers, inverse
    training) cut to 8 features and one encoder layer, and one train and
    one test batch."""
    cfg = resolve(configs.synthetic_h36m_train())
    mcfg = dict(cfg["model"])
    hp = dict(mcfg.pop("dstdgcn"), num_feature=8, num_layers=1)
    model = get_model("dstdgcn", dstdgcn=hp, use_pallas=mcfg["use_pallas"])
    eng = PredictionEngine(dict(cfg["engine"]), model, device="cpu")
    eng.init(0)
    data = {}
    for mode in ("train", "test"):
        kw = dict(cfg["dataset"][mode]["synthetic"], num_sequences=BATCH)
        data[mode] = Loader(Synthetic(**kw).arrays(), BATCH)
    return eng, cfg["setting"], data


def _test(eng, setting, loader):
    return eng.test(loader, setting["input_n"],
                    np.asarray(setting["eval_frame"]),
                    np.asarray(setting["dim_used"]),
                    np.asarray(setting["joint_to_ignore"]),
                    np.asarray(setting["joint_to_equal"]))


def _spans(fn, tmp_path):
    """[(name, start, end)] of the user spans of the CPU profiler's trace
    of ``fn()``, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: s[1])


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def _in_order(spans, names, outer):
    """Each of ``names`` once, inside ``outer``, one after another."""
    got = [s for s in spans if s[0] in names]
    assert [s[0] for s in got] == names
    assert all(_inside(s, outer) for s in got)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    return dict((s[0], s) for s in got)


def _ops(eng):
    return sum(isinstance(m, DSTDGC) for m in eng.model.modules())


def test_train_step_spans_nest_in_order(tmp_path):
    eng, _, data = _engine()
    spans = _spans(lambda: eng.train(data["train"], 0), tmp_path)
    steps = [s for s in spans if s[0] == "engine.step"]
    assert len(steps) == 1
    phases = _in_order(spans, STEP, steps[0])
    ops = [s for s in spans if s[0] == "dstd.op"]
    assert _ops(eng) == 6              # 3 blocks of 2 ops at one layer
    assert len(ops) == 2 * _ops(eng)   # once a module, each direction
    assert all(_inside(s, phases["engine.forward"]) for s in ops)
    # no other span of the program's (torch names its optimizer step)
    assert {s[0] for s in spans if not s[0].startswith("Optimizer.")} \
        == {"engine.step", "dstd.op", *STEP}


def test_eval_batch_spans_in_order(tmp_path):
    eng, setting, data = _engine()
    spans = _spans(lambda: _test(eng, setting, data["test"]), tmp_path)
    whole = ("batch", spans[0][1], max(s[2] for s in spans))
    phases = _in_order(spans, EVAL, whole)
    ops = [s for s in spans if s[0] == "dstd.op"]
    assert len(ops) == _ops(eng)
    assert all(_inside(s, phases["engine.eval_forward"]) for s in ops)
    assert {s[0] for s in spans} == {"dstd.op", *EVAL}


def test_spans_build_nothing_without_a_profiler(monkeypatch):
    eng, setting, data = _engine()
    built = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        built.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    eng.train(data["train"], 0)
    _test(eng, setting, data["test"])
    assert built == []
    # the control: the same step and batch under the profiler build every
    # span through the counter
    with profile(activities=[ProfilerActivity.CPU]):
        eng.train(data["train"], 0)
        _test(eng, setting, data["test"])
    n = _ops(eng)
    assert sorted(built) == sorted(["engine.step", *STEP] + EVAL
                                   + ["dstd.op"] * (3 * n))


@pytest.mark.parametrize("profile_steps", [1, 3])
def test_engine_profile_holds_one_step_span_a_step(tmp_path, profile_steps):
    """``engine.profile`` traces steps 1 .. profile_steps: as many
    ``engine.step`` spans, each holding its four phases."""
    eng, _, _ = _engine()
    cfg = configs.synthetic_h36m_train()
    kw = dict(cfg["dataset"]["train"]["synthetic"], num_sequences=5 * BATCH)
    loader = Loader(Synthetic(**kw).arrays(), BATCH)
    prof = tmp_path / "profile"
    eng.config = dict(eng.config, profile=str(prof),
                      profile_steps=profile_steps)
    eng.train(loader, 0)
    (path,) = prof.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") == "user_annotation"),
                   key=lambda s: s[1])
    steps = [s for s in spans if s[0] == "engine.step"]
    assert len(steps) == profile_steps
    for step in steps:
        _in_order([s for s in spans if _inside(s, step)], STEP, step)
