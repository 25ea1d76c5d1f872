"""Each traffic driver on the port's CPU path at a small size, and the
measurement path's refusal to run without a card."""

import time

import pytest
import torch

from gpubench import harness, run

BENCH = harness.load_bench()


def test_train_cell_on_the_cpu(small, kernel_route):
    res = harness.run_cell(BENCH, "paper_train", 2 ** 31 + 77, 1.0, False, torch.device("cpu"),
                           time.perf_counter(), small)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 8 and res["attempted"] % 8 == 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert list(res)[-1] == "checks" and res["device"]["platform"] == "cpu"


def test_serve_cell_on_the_cpu_traced(small, kernel_route):
    res = harness.run_cell(BENCH, "stretch_serve", 2 ** 31 + 78, 1.0, True, torch.device("cpu"),
                           time.perf_counter(), small)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    # no device on the CPU: no roofline share, every other per-layer metric of the cell
    assert set(res["metrics"]) == {"mfu.serve", "device_idle_pct.serve", "setup_share_pct.serve"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "paper_train", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["paper_train", "stretch_train", "stretch_serve"])
def test_cells_on_the_card(card, workload):
    res = harness.run_cell(BENCH, workload, 2 ** 31 + 79, 3.0, False, card, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(card)
