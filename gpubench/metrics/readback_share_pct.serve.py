"""Share of the traced stretch of a serve cell in the batches' reads back to
the host (``ctpvae.infer.readback``: the maps' copies, the loss, the float64
accumulators), %.  The wait for the passes still queued on the card comes
before it, in ``ctpvae.infer.wait``, and is not counted."""

from gpubench.metrics._spans import share_pct


def read(run):
    return share_pct(run, "serve", "ctpvae.infer.readback")
