"""Seeds of a run's inputs: each use of the run seed draws from a seed of its own."""

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run seed (``path`` names the use)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0]) >> 1
