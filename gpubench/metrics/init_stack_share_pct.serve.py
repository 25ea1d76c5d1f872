"""Share of the traced stretch of a serve cell in the request's classical
init stack (``ctpvae.setup.init_stack``: each algorithm, the mask channel,
the read back to the host), %."""

from gpubench.metrics._spans import share_pct


def read(run):
    return share_pct(run, "serve", "ctpvae.setup.init_stack")
