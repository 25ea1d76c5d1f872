"""Share of the traced stretch of a serve cell in the request's masks and
Poisson draws (``ctpvae.setup.masks``), %."""

from gpubench.metrics._spans import share_pct


def read(run):
    return share_pct(run, "serve", "ctpvae.setup.masks")
