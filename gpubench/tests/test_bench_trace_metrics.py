"""The readers of the port's spans on traced CPU runs of a train and a serve
cell at a small size: a number where a card's run would have one, None
where the run has no trace, no card, or a program without spans."""

import math
import sys
from types import SimpleNamespace

import pytest
import torch

from gpubench import harness
from gpubench.profiling import Tracer

BENCH = harness.load_bench()
SPAN_METRICS = {"stage_ms.train": "paper_train", "graphed_steps_pct.train": "paper_train",
                "masks_share_pct.serve": "stretch_serve",
                "init_stack_share_pct.serve": "stretch_serve",
                "model_load_share_pct.serve": "stretch_serve",
                "readback_share_pct.serve": "stretch_serve"}
CARD = torch.device("cuda")


@pytest.fixture(scope="module")
def recorded():
    """A traced window of each cell on the CPU, as ``harness.run_cell`` runs
    one, through the Joseph projector's plain version."""
    from gpubench.tests.conftest import SMALL
    import ct_pvae_tpu_torch.vi.serve as serve
    from ct_pvae_tpu_torch.utils import trace

    route = serve.joseph_route
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "joseph_route",
                   lambda cfg, n_det, device, kernel_route=False, mesh=None, num_angles=None:
                   route(cfg, n_det, device, True, mesh, num_angles))
        for cell in ("paper_train", "stretch_serve"):
            _, cfg, traffic, _ = harness.find_cell(BENCH, cell)
            cfg, traffic = dict(cfg, **SMALL["config"]), dict(traffic, **SMALL["traffic"])
            loop = harness.driver(traffic["driver"])(cfg, traffic, 2 ** 31 + 90, torch.device("cpu"))
            trace.clear()
            tracer = Tracer(0.0, 1)
            window = loop.window(0.5, tracer)
            runs[cell] = SimpleNamespace(kind=traffic["driver"], loop=loop, window=window,
                                         trace=tracer.summary(), device=torch.device("cpu"),
                                         net_seconds=window["seconds"] - tracer.overhead_s,
                                         spans=trace.spans())
            loop.close()
    return runs


def _as_read_on(run, monkeypatch, **changes):
    """``run`` with ``changes``, its spans the ones the port holds."""
    from ct_pvae_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(run.spans))
    return SimpleNamespace(**{**vars(run), **changes})


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_gives_a_number_on_a_traced_run(recorded, monkeypatch, metric):
    read = harness.metric_reader(metric)
    run = recorded[SPAN_METRICS[metric]]
    assert run.spans  # the CPU run recorded the stretch's spans
    value = read(_as_read_on(run, monkeypatch, device=CARD))  # as a card's run reads them
    assert value is not None and math.isfinite(value) and value >= 0
    if metric.endswith("_pct.serve") or metric == "graphed_steps_pct.train":
        assert value <= 100.0
    if metric == "graphed_steps_pct.train":
        assert value == 0.0  # the CPU runs every step eagerly


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_gives_none_where_there_is_nothing_to_read(recorded, monkeypatch, metric):
    read = harness.metric_reader(metric)
    run = recorded[SPAN_METRICS[metric]]
    other = recorded["stretch_serve" if run.kind == "train" else "paper_train"]
    assert read(_as_read_on(run, monkeypatch, device=CARD, trace=None)) is None
    assert read(_as_read_on(run, monkeypatch)) is None  # the CPU: no card kept waiting
    assert read(_as_read_on(other, monkeypatch, device=CARD)) is None  # the other kind of cell
    # a program without spans (the module is missing): nothing read, nothing raised
    monkeypatch.setitem(sys.modules, "ct_pvae_tpu_torch.utils.trace", None)
    assert read(SimpleNamespace(**{**vars(run), "device": CARD})) is None


def test_serve_shares_fit_in_the_stretch(recorded, monkeypatch):
    run = _as_read_on(recorded["stretch_serve"], monkeypatch, device=CARD)
    names = ("masks_share_pct.serve", "init_stack_share_pct.serve", "model_load_share_pct.serve",
             "readback_share_pct.serve")
    total = sum(harness.metric_reader(n)(run) for n in names)
    spans = recorded["stretch_serve"].spans
    request = sum(s.end_ns - s.start_ns for s in spans if s.name == "ctpvae.request") * 1e-9
    assert 0 < total <= 100.0 * request / run.trace["window_s"] + 1e-9


def test_stage_ms_is_per_chunk(recorded, monkeypatch):
    run = recorded["paper_train"]
    chunks = [s for s in run.spans if s.name == "ctpvae.train.chunk"]
    stages = [s for s in run.spans if s.name == "ctpvae.train.stage"]
    assert chunks and len(stages) == len(chunks)
    want = 1000.0 * sum((s.end_ns - s.start_ns) * 1e-9 for s in stages) / len(chunks)
    got = harness.metric_reader("stage_ms.train")(_as_read_on(run, monkeypatch, device=CARD))
    assert got == pytest.approx(want, rel=1e-12)
