"""The port's spans (``ct_pvae_tpu_torch/utils/trace.py``) on the CPU, at the
small sizes of ``test_torch_infer.py`` (a request) and ``test_torch_train.py``
(a chunk): nothing is recorded and no ``record_function`` entered without a
running ``torch.profiler``; under one, the spans nest as the request and the
chunk nest, each inside one request or one chunk, give ``amortized_infer``
its ``timing``, and sit in the exported Chrome trace inside their parents."""

import json
from collections import Counter, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_infer as infer_case
import test_torch_train as train_case
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.utils import trace
from ct_pvae_tpu_torch.utils.batching import IndexStream
from ct_pvae_tpu_torch.vi.infer import amortized_infer
from ct_pvae_tpu_torch.vi.train import Trainer

CPU = torch.device("cpu")
SETUP_STAGES = ("ctpvae.setup.config", "ctpvae.setup.masks", "ctpvae.setup.init_stack",
                "ctpvae.setup.models", "ctpvae.setup.restore")
# each span's enclosing span, as the request and the chunk nest
PARENT = {
    "ctpvae.request": None,
    "ctpvae.setup": "ctpvae.request",
    **{s: "ctpvae.setup" for s in SETUP_STAGES},
    "ctpvae.infer.accumulators": "ctpvae.request",
    "ctpvae.infer.batch": "ctpvae.request",
    "ctpvae.infer.pass": "ctpvae.infer.batch",
    "ctpvae.infer.wait": "ctpvae.request",
    "ctpvae.infer.readback": "ctpvae.request",
    "ctpvae.infer.finish": "ctpvae.request",
    "ctpvae.train.chunk": None,
    "ctpvae.train.stage": "ctpvae.train.chunk",
    "ctpvae.train.step": "ctpvae.train.chunk",
}


def _parent_name(name):
    if name.startswith("ctpvae.setup.init_stack."):
        return "ctpvae.setup.init_stack"
    return PARENT[name]


def _nested(spans):
    """The spans in the order they began, and for each the index of the
    innermost other span whose stretch holds its own (None at the top)."""
    spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    parents = []
    for i, s in enumerate(spans):
        around = [j for j in range(i) if spans[j].end_ns >= s.end_ns]
        parents.append(around[-1] if around else None)
    return spans, parents


def _within(spans, name):
    """For each span, the index of the span called ``name`` that holds it."""
    outer = [o for o in spans if o.name == name]
    return [[k for k, o in enumerate(outer) if o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns]
            for s in spans]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """``test_torch_infer``'s trained run (the paper's init algorithms)."""
    root = tmp_path_factory.mktemp("trace")
    sinos, theta = infer_case._data()
    infer_case._trained_run(root / "run", sinos, theta)
    return root / "run", sinos, theta


def _infer(run_dir, output_path=None, **kw):
    run, sinos, theta = run_dir
    return amortized_infer(str(run), output_path, sinograms=sinos, theta=theta,
                           num_passes=infer_case.PASSES, seed=3, device="cpu", **kw)


def _trainer():
    sinos, theta = train_case._data()
    return Trainer(Config(**train_case.KW), sinos, theta, CPU)


def _chunk(tr, streams, k):
    batches, angles = streams
    return tr.train_chunk([batches.next() for _ in range(k)], [angles.next() for _ in range(k)])


def _streams(tr):
    return (IndexStream(tr.num_examples, tr.cfg.batch_size, tr.cfg.seed + 1),
            IndexStream(tr.num_angles, tr.angles_per_step, tr.cfg.seed + 2))


def _profiled(fn):
    """``fn()`` under a running CPU profiler: (its result, the spans, the
    profiler)."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.spans(), prof


def test_nothing_is_recorded_without_a_profiler(run_dir, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tr = _trainer()
    streams = _streams(tr)
    trace.clear()
    out = _infer(run_dir, overrides=infer_case.OVERRIDES)
    rows = _chunk(tr, streams, 2)
    assert entered == [] and trace.spans() == []
    # the clock runs all the same
    assert out["timing"]["setup_s"] > 0 and all(s > 0 for s in out["timing"]["batch_s"])
    assert rows.shape == (2, 4)
    # control: the patched function is the one a running profiler enters
    _profiled(lambda: _chunk(tr, streams, 1))
    assert "ctpvae.train.chunk" in entered


def test_request_spans_nest_each_inside_one_request(run_dir):
    outs, spans, _ = _profiled(lambda: [_infer(run_dir, overrides=infer_case.OVERRIDES)
                                        for _ in range(2)])
    spans, parents = _nested(spans)
    assert sum(s.name == "ctpvae.request" for s in spans) == 2
    for s, p in zip(spans, parents):
        assert (spans[p].name if p is not None else None) == _parent_name(s.name), s
    # each span lies in one request, and each request holds the spans of a call
    inside = _within(spans, "ctpvae.request")
    assert all(len(k) == 1 for k in inside)
    assert Counter(k[0] for k in inside) == {0: len(spans) // 2, 1: len(spans) // 2}
    batches = -(-infer_case.N // infer_case.BATCH)
    count = Counter(s.name for s in spans)
    assert count["ctpvae.infer.batch"] == 2 * batches
    # one wait for the card and one readback a request, after its batches
    assert count["ctpvae.infer.wait"] == count["ctpvae.infer.readback"] == 2
    for k in range(2):
        mine = [s for s, i in zip(spans, inside) if i == [k]]
        (wait,) = [s for s in mine if s.name == "ctpvae.infer.wait"]
        (readback,) = [s for s in mine if s.name == "ctpvae.infer.readback"]
        last = max(s.end_ns for s in mine if s.name == "ctpvae.infer.batch")
        assert last <= wait.start_ns <= wait.end_ns <= readback.start_ns
    assert count["ctpvae.infer.pass"] == 2 * batches * infer_case.PASSES
    assert all(count[s] == 2 for s in SETUP_STAGES)
    assert np.isfinite(outs[0]["mean"]).all()


def test_init_stack_span_per_algorithm_and_batch(run_dir):
    # the run's algorithms as they are, not the cheap init's four FBPs
    _, spans, _ = _profiled(lambda: _infer(run_dir, overrides={**infer_case.OVERRIDES,
                                                               "cheap_init": False}))
    algorithms = ["sirt", "tv", "fbp", "gridrec"]
    p = infer_case.P
    init_batches = -(-infer_case.N // max(1, min(32, int(32 * (184.0 / p) ** 2))))
    count = Counter(s.name for s in spans)
    for part in algorithms + ["mask", "readback"]:
        assert count[f"ctpvae.setup.init_stack.{part}"] == init_batches, part
    assert count["ctpvae.setup.init_stack"] == count["ctpvae.setup.init_stack.assemble"] == 1


def test_timing_is_the_spans(run_dir):
    out, spans, _ = _profiled(lambda: _infer(run_dir, overrides=infer_case.OVERRIDES))
    (setup,) = [s for s in spans if s.name == "ctpvae.setup"]
    assert out["timing"]["setup_s"] == setup.seconds
    assert out["timing"]["batch_s"] == [s.seconds for s in spans if s.name == "ctpvae.infer.batch"]
    stages = sum(s.seconds for s in spans if s.name in SETUP_STAGES)
    assert 0 < stages <= setup.seconds


def test_chunk_spans_nest_each_inside_one_chunk(run_dir):
    tr = _trainer()
    streams = _streams(tr)
    _, spans, _ = _profiled(lambda: [_chunk(tr, streams, 2), _chunk(tr, streams, 3)])
    spans, parents = _nested(spans)
    for s, p in zip(spans, parents):
        assert (spans[p].name if p is not None else None) == _parent_name(s.name), s
    chunk_of = [k[0] for k in _within(spans, "ctpvae.train.chunk")]
    # the CPU runs each step of a chunk eagerly, after the chunk's staging
    assert [(s.name, k) for s, k in zip(spans, chunk_of)] == [
        ("ctpvae.train.chunk", 0), ("ctpvae.train.stage", 0),
        *[("ctpvae.train.step", 0)] * 2,
        ("ctpvae.train.chunk", 1), ("ctpvae.train.stage", 1),
        *[("ctpvae.train.step", 1)] * 3]
    # a step outside a chunk is a span of its own
    _, spans, _ = _profiled(lambda: tr.train_step(*(s.next() for s in streams)))
    assert [s.name for s in spans] == ["ctpvae.train.step"]


def test_chrome_trace_holds_each_span_inside_its_parent(run_dir, tmp_path):
    tr = _trainer()
    streams = _streams(tr)
    _, spans, prof = _profiled(lambda: (_infer(run_dir, str(tmp_path / "out"),
                                               overrides=infer_case.OVERRIDES),
                                        _chunk(tr, streams, 2)))
    spans, parents = _nested(spans)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                  and e["name"].startswith("ctpvae.")]
    by_name = {}
    for e in sorted(events, key=lambda e: float(e["ts"])):
        by_name.setdefault(e["name"], []).append(e)
    assert sorted(by_name) == sorted({s.name for s in spans})
    seen = Counter()
    matched = []
    for s in spans:  # the span's event: the next one of its name in time order
        matched.append(by_name[s.name][seen[s.name]])
        seen[s.name] += 1
    assert all(len(by_name[n]) == seen[n] for n in by_name)
    for s, e, parent in zip(spans, matched, parents):
        if parent is None:
            continue
        p = matched[parent]
        assert float(p["ts"]) <= float(e["ts"]), (s.name, p["name"])
        end, outer_end = float(e["ts"]) + float(e["dur"]), float(p["ts"]) + float(p["dur"])
        assert end <= outer_end, (s.name, p["name"])


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_records", deque(maxlen=4))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            for i in range(6):
                with trace.span(f"inner{i}"):
                    pass
    # the oldest records left first: the outer span, which ended last, stays
    assert [s.name for s in trace.spans()] == ["inner3", "inner4", "inner5", "outer"]
    trace.clear()
    assert trace.spans() == []
