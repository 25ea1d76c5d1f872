"""What the drivers share (no driver of its own)."""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

# keys of a configuration file that the harness reads and the port's Config does not have
HARNESS_KEYS = ("name", "source", "reference", "dataset", "objects", "n_pixel", "num_angles",
                "assumed", "deployment")


def port_config(cfg: Dict, **kw):
    """The port's ``Config`` of a configuration file, with ``kw`` on top."""
    from ct_pvae_tpu_torch.config import Config

    fields = {k: v for k, v in cfg.items() if k not in HARNESS_KEYS}
    fields.update(kw)
    return Config(**fields)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def annotate(name: str):
    return torch.profiler.record_function(name)


class Phases:
    """Seconds of each named stage of a driver's set-up, in order."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t
