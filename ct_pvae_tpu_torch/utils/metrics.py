"""Structured training metrics (port of ``ct_pvae_tpu/utils/metrics.py``).

One ``metrics.jsonl`` record per step plus the reference's ``.npy``
artifact names (``train_loss_vec.npy``, ``train_loss_kl.npy``,
``train_loss_loglik.npy``, ``iter_vec.npy``), and the loss curves as PNGs
when matplotlib is installed (metrics.py:19-79).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

_NPY = {"loss": "train_loss_vec", "kl": "train_loss_kl", "loglik": "train_loss_loglik"}
_TITLES = {
    "loss": "Training loss",
    "kl": "Training loss KL divergence",
    "loglik": "Training loss loglikelihood",
}


class MetricsLogger:
    def __init__(self, save_path: Optional[str] = None):
        self.save_path = save_path
        self.history: Dict[str, List[float]] = {}
        self.iters: List[int] = []
        self._fh = None
        if save_path is not None:
            os.makedirs(save_path, exist_ok=True)
            self._fh = open(os.path.join(save_path, "metrics.jsonl"), "a")

    def log(self, step: int, **values: float) -> None:
        self.iters.append(step)
        for k, v in values.items():
            self.history.setdefault(k, []).append(float(v))
        if self._fh is not None:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in values.items()})
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def save_npy_contract(self) -> None:
        """Write the reference's artifact names (main_ct_vae.py:411-414)."""
        if self.save_path is None:
            return
        for key, name in _NPY.items():
            if key in self.history:
                np.save(os.path.join(self.save_path, name + ".npy"), np.asarray(self.history[key]))
        np.save(os.path.join(self.save_path, "iter_vec.npy"), np.asarray(self.iters))

    def save_plots(self) -> None:
        if self.save_path is None:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        for key, title in _TITLES.items():
            if key in self.history:
                plt.figure()
                plt.title(title)
                plt.plot(self.history[key])
                plt.savefig(os.path.join(self.save_path, _NPY[key] + ".png"))
                plt.close()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
