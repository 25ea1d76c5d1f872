"""A run with its timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a small size (set-up, window, check) with one fault planted in the
program: a step that leaves its state unchanged, half of the batch left
out with the mean taken over the rest, and an answer altered where it is
produced.  (No cell spans chips, so no exchange between chips can be left
out.)  A sound run at the same size comes out correct
(``test_bench_loops.py``).
"""

import time

import pytest
import torch

from gpubench import harness

BENCH = harness.load_bench()


def _run(cell, small):
    return harness.run_cell(BENCH, cell, 2 ** 31 + 91, 0.5, False, torch.device("cpu"),
                            time.perf_counter(), small)


def _train_fault(monkeypatch, fault):
    import ct_pvae_tpu_torch.vi.train as train

    if fault == "state_unchanged":
        monkeypatch.setattr(train, "adam_", lambda *args, **kw: None)
        return
    elbo = train.elbo_loss

    def broken(enc, dec, inputs, mask, proj, draws, **kw):
        if fault == "half_batch":
            h = inputs.shape[0] // 2
            return elbo(enc, dec, inputs[:h], mask[:h], proj[:h], draws, **kw)
        loss, aux = elbo(enc, dec, inputs, mask, proj, draws, **kw)
        return loss * 1.001, aux  # the step's loss altered where it is produced

    monkeypatch.setattr(train, "elbo_loss", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_train_fault_is_not_correct(monkeypatch, small, kernel_route, fault):
    _train_fault(monkeypatch, fault)
    res = _run("paper_train", small)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_serve_fault_is_not_correct(monkeypatch, small, kernel_route, fault):
    from ct_pvae_tpu_torch.vi.serve import Server

    step = Server.eval_step

    def broken(self, batch_idx, draws):
        if fault == "half_batch":  # the second half of the batch answered from the first
            h = batch_idx.shape[0] // 2
            batch_idx = torch.cat([batch_idx[:h], batch_idx[:batch_idx.shape[0] - h]])
            return step(self, batch_idx, draws)
        loss, aux = step(self, batch_idx, draws)
        mean = aux.recon_mean.clone()
        mean[0] *= 1.001
        return loss, aux._replace(recon_mean=mean)

    monkeypatch.setattr(Server, "eval_step", broken)
    res = _run("stretch_serve", small)
    assert not res["correct"], res["checks"]
