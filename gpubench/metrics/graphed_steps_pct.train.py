"""Share of the traced stretch's train steps that replayed the captured step
graph (``ctpvae.train.replay``) among all its steps (replays and eager
``ctpvae.train.step``), %: 100 on the card unless a step fell back to eager."""

from gpubench.metrics._spans import recorded


def read(run):
    spans = recorded(run) if run.kind == "train" else None
    if not spans:
        return None
    replays = sum(s.name == "ctpvae.train.replay" for s in spans)
    steps = replays + sum(s.name == "ctpvae.train.step" for s in spans)
    return 100.0 * replays / steps if steps else None
