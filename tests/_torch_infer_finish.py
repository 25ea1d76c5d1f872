"""The yardstick for ``amortized_infer``'s outputs: each pass's maps, kept
by a wrapped ``Server.eval_step``, and the finish of them in numpy that the
request once ran on the host (float32 sums of a batch's passes, float64
accumulators, mean, clamped variance and std).  The device's finish is held
to it bitwise, on the CPU and on the card.  Imports no JAX."""

import numpy as np
import torch

from ct_pvae_tpu_torch.vi.serve import Server


def record_passes(monkeypatch):
    """Patch ``Server.eval_step`` to keep each pass's (loss, recon_mean,
    recon_sample), in the order the passes run; returns that list."""
    passes = []
    real = Server.eval_step

    def recording(self, batch_idx, draws):
        loss, aux = real(self, batch_idx, draws)
        passes.append((loss, aux.recon_mean, aux.recon_sample))
        return loss, aux

    monkeypatch.setattr(Server, "eval_step", recording)
    return passes


def host_finish(passes, n, batch_size, num_passes):
    """{"mean", "std", "sample", "loss"} of ``n`` scans in batches of
    ``batch_size`` (the tail batch's clamped duplicates sliced off) from the
    recorded passes, ``num_passes`` a batch."""
    num_batches = -(-n // batch_size)
    assert len(passes) == num_batches * num_passes
    shape = tuple(passes[0][1].shape)
    mean_acc = np.zeros((n, *shape[1:]), np.float64)
    sq_acc = np.zeros_like(mean_acc)
    sample = np.zeros((n, *shape[1:]), np.float32)
    losses = np.zeros(num_batches, np.float64)
    for bi in range(num_batches):
        group = passes[bi * num_passes : (bi + 1) * num_passes]
        rows = slice(bi * batch_size, min((bi + 1) * batch_size, n))
        take = rows.stop - rows.start
        ma = np.zeros(shape, np.float32)
        sa = np.zeros_like(ma)
        for _, m, _ in group:
            m = m.cpu().numpy()
            ma += m
            sa += m * m
        mean_acc[rows] += ma[:take]
        sq_acc[rows] += sa[:take]
        losses[bi] = float(torch.stack([loss for loss, _, _ in group]).mean())
        sample[rows] = group[0][2].cpu().numpy()[:take]
    mean = (mean_acc / num_passes).astype(np.float32)
    var = np.maximum(sq_acc / num_passes - (mean_acc / num_passes) ** 2, 0.0)
    std = np.sqrt(var).astype(np.float32)
    return {"mean": mean[..., None], "std": std[..., None], "sample": sample[..., None],
            "loss": losses.astype(np.float32)}


def assert_bitwise(out, want):
    for k in ("mean", "std", "sample", "loss"):
        assert out[k].dtype == want[k].dtype == np.float32, k
        assert out[k].shape == want[k].shape, k
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
