"""matplotlib for the eval stage's PNGs, imported when a figure is drawn.

The compute functions of ``eval/`` return arrays and metrics without it; the
functions that write figures call ``pyplot()``, which raises an
``ImportError`` naming matplotlib where it is not installed (the GPU
machine has none), so a figure is never skipped silently.
"""

from __future__ import annotations


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("writing the eval stage's PNGs needs matplotlib, which is not installed; "
                          "the compute functions of ct_pvae_tpu_torch.eval run without it") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
