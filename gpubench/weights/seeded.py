"""Weights drawn on the device from the run's seed by the reference's ``draw_weights``."""

from gpubench import inputs


def make(ref, sizes, cfg, seed, device):
    return ref.draw_weights(sizes, inputs.sub_seed(seed, 11), device)
