"""Host time of a train chunk's staging (``ctpvae.train.stage``: the float
and int slots of its steps, ``pin_memory`` and the copies to the card) over
the chunks of the traced stretch (``ctpvae.train.chunk``), ms a chunk."""

from gpubench.metrics._spans import recorded, seconds


def read(run):
    spans = recorded(run) if run.kind == "train" else None
    chunks = sum(s.name == "ctpvae.train.chunk" for s in spans) if spans else 0
    if not chunks:
        return None
    return 1000.0 * seconds(spans, "ctpvae.train.stage") / chunks
