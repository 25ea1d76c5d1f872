"""Foam-generator and classical-reconstruction fidelity study (port of
``ct_pvae_tpu/eval/fidelity.py``).

Two self-contained measurements (fidelity.py:44-150):

  1. ``porosity_fidelity``: the packer's achieved void fraction against its
     target (the reference draws targets from U(0, 1), so a packer that
     saturates early makes denser foams than xdesign's); host numpy, bitwise
     the JAX package's (the port's ``_pack_voids`` is a copy).
  2. ``recon_fidelity``: MSE/SSIM/PSNR distributions of the ramp FBP of N
     fresh foams' full sinograms at the paper's operating point (180
     angles, pnm 1e4), noiseless (the algorithm's floor) and Poisson-noised
     (merit's full-sinogram row), and by porosity bin.  The sinograms come
     from ``images_to_sinograms`` (kernel C on the card, in chunks of
     ``batch``), the FBP from the gather backprojector (184 bins), and the
     noise from a ``torch.Generator`` seeded with ``seed``.

``fidelity_report`` writes ``fidelity.json`` with the JAX package's keys.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.foam import _pack_voids, generate_foam_images
from ..data.masks import poisson_measurements
from ..data.sinogram import images_to_sinograms
from ..device import DeviceLike, exact_f32, resolve_device
from ..ops.fbp import fbp
from .metrics import compare


def porosity_fidelity(targets: Optional[np.ndarray] = None, trials: int = 3, seed: int = 0) -> Dict:
    """{"curve": [{target, achieved_mean, achieved_std}], "saturation"}: the
    packer's void fraction (void area over disk area) at each target."""
    if targets is None:
        targets = np.linspace(0.05, 0.95, 10)
    rows = []
    for t in targets:
        ach = []
        for s in range(trials):
            rng = np.random.default_rng(seed + 1000 + s)
            _, radii = _pack_voids(rng, float(t), 0.01, 0.2, 0.0)
            ach.append(float(np.sum(radii**2)))
        rows.append({"target": float(t), "achieved_mean": float(np.mean(ach)),
                     "achieved_std": float(np.std(ach))})
    return {"curve": rows, "saturation": max(r["achieved_mean"] for r in rows)}


def _summarize(m: np.ndarray) -> Dict:
    return {
        "mse_median": float(np.median(m[:, 0])),
        "ssim_median": float(np.median(m[:, 1])),
        "psnr_median": float(np.median(m[:, 2])),
        "mse_iqr": [float(np.percentile(m[:, 0], q)) for q in (25, 75)],
        "ssim_iqr": [float(np.percentile(m[:, 1], q)) for q in (25, 75)],
        "psnr_iqr": [float(np.percentile(m[:, 2], q)) for q in (25, 75)],
    }


def recon_fidelity(
    num: int = 100,
    n_pixel: int = 128,
    num_angles: int = 180,
    pnm: float = 1.0e4,
    seed: int = 0,
    batch: int = 25,
    device: DeviceLike = "cuda",
) -> Dict:
    """Per-porosity-bin medians and the noiseless and noisy metric summaries
    of the full-sinogram ramp FBP (clipped to [0, 1], as merit clips) of
    ``num`` foams drawn with seed ``seed + 7``."""
    exact_f32()
    dev = resolve_device(device)
    imgs = generate_foam_images(num, n_pixel=n_pixel, seed=seed + 7)
    # void fraction inside the unit disk, which covers pi/4 of the square
    porosity = 1.0 - imgs.reshape(num, -1).mean(axis=1) / (np.pi / 4.0)
    theta = np.linspace(0, np.pi, num_angles, endpoint=False).astype(np.float32)
    sinos = torch.as_tensor(images_to_sinograms(imgs, theta, pad=True, batch=batch, device=dev),
                            device=dev)
    noisy = poisson_measurements(sinos, pnm, torch.Generator(device=dev).manual_seed(seed))

    def metric_rows(s: torch.Tensor) -> np.ndarray:
        out = []
        for lo in range(0, num, batch):
            rec = np.clip(fbp(s[lo:lo + batch], theta, n_pixel, n_pixel, "ramp").cpu().numpy(), 0.0, 1.0)
            out += [compare(g, r) for r, g in zip(rec, imgs[lo:lo + batch])]
        return np.asarray(out)  # (N, 3)

    clean, noised = metric_rows(sinos), metric_rows(noisy)
    bins = np.digitize(porosity, [0.25, 0.5, 0.75])
    by_porosity = []
    for b, label in enumerate(["<0.25", "0.25-0.5", "0.5-0.75", ">0.75"]):
        sel = bins == b
        if sel.any():
            by_porosity.append({"bin": label, "n": int(sel.sum()),
                                "noisy_psnr_median": float(np.median(noised[sel, 2])),
                                "noisy_ssim_median": float(np.median(noised[sel, 1]))})
    return {
        "num": num, "pnm": pnm, "num_angles": num_angles,
        "porosity_mean": float(porosity.mean()),
        "noiseless_floor": _summarize(clean),
        "noisy_operating_point": _summarize(noised),
        "by_porosity": by_porosity,
        "reference_full_sino_point": {"mse": 6.95e-3, "ssim": 0.933, "psnr": 21.74},
    }


def fidelity_report(out_dir: str, num: int = 100, seed: int = 0, device: DeviceLike = "cuda") -> Dict:
    """Both studies, written to ``out_dir/fidelity.json``."""
    os.makedirs(out_dir, exist_ok=True)
    res = {"porosity": porosity_fidelity(seed=seed),
           "recon": recon_fidelity(num=num, seed=seed, device=device)}
    with open(os.path.join(out_dir, "fidelity.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res
