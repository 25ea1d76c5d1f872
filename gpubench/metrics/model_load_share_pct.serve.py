"""Share of the traced stretch of a serve cell in building the request's
models (``ctpvae.setup.models``) and restoring their checkpoint
(``ctpvae.setup.restore``: the read, the msgpack decode, the load), %."""

from gpubench.metrics._spans import share_pct


def read(run):
    return share_pct(run, "serve", "ctpvae.setup.models", "ctpvae.setup.restore")
