"""Sinogram synthesis: images -> projections (port of ``ct_pvae_tpu/data/sinogram.py``).

The whole dataset is projected in chunks on the device with ``radon_fast``:
kernel C (the static Joseph projector) on the card, where the JAX package
takes its Pallas kernel on a TPU, and the gather projector on the CPU, as
the JAX package does off the TPU.  So a dataset made on the card differs
from one made on the CPU by the two projectors' discretisations, as the JAX
package's TPU and CPU datasets differ.  Each chunk is projected on its own,
so the result does not depend on the chunking.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.radon import radon_fast
from . import io
from .foam import generate_foam_images
from .toy import generate_toy_images, toy_theta


def images_to_sinograms(images: np.ndarray, theta: np.ndarray, pad: bool = True, batch: int = 64,
                        device: DeviceLike = "cuda") -> np.ndarray:
    """Project a stack of images to (N, A, P) sinograms, ``batch`` images at
    a time on ``device``; negatives clamped to zero (images_to_sinograms.py:72)."""
    dev = resolve_device(device)
    images = np.asarray(images, np.float32)
    theta = np.asarray(theta, np.float32)
    outs = []
    for i in range(0, images.shape[0], batch):
        chunk = torch.as_tensor(images[i : i + batch], device=dev)
        outs.append(radon_fast(chunk, theta, pad=pad).cpu().numpy())
    return np.clip(np.concatenate(outs, axis=0), 0.0, None)


def make_dataset(
    img_type: str,
    num_train: int,
    save_path: Optional[str] = None,
    num_angles: int = 180,
    n_pixel: int = 128,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Make a dataset (foam or toy) and write it in the on-disk contract.

    foam: n_pixel^2 phantoms, theta = linspace(0, pi, num_angles), padded
    projections (images_to_sinograms.py:34-37).  toy: the 2x2 discrete
    objects, theta = [0, pi/2], no padding (:28-31).  The ground truth goes
    next to the dataset, named as ``io.load_ground_truth`` finds it.

    Returns (images, sinograms, theta).
    """
    if img_type == "foam":
        images = generate_foam_images(num_train, n_pixel=n_pixel, seed=seed)
        theta = np.linspace(0, np.pi, num_angles, endpoint=False).astype(np.float32)
        sinos = images_to_sinograms(images, theta, pad=True, device=device)
    elif img_type in ("toy", "toy_discrete2"):
        images = generate_toy_images(max(1, num_train // 4), discrete=True)
        theta = toy_theta()
        sinos = images_to_sinograms(images, theta, pad=False, batch=1024, device=device)
    else:
        raise ValueError(f"unknown img_type {img_type!r}")

    if save_path is not None:
        io.save_dataset(save_path, sinos, theta, images.shape[1], images.shape[2])
        # '<root>/dataset_<name>' gets '<root>/<name>_training.npy', which
        # io.load_ground_truth finds (reference main_ct_vae.py:566); any other
        # folder name gets the image type's file
        norm = os.path.normpath(save_path)
        base = os.path.basename(norm)
        if base.startswith("dataset_"):
            name = base[len("dataset_"):]
        else:
            name = img_type if img_type != "toy" else "toy_discrete2"
        io.save_ground_truth(images, name, os.path.dirname(norm) or ".")
    return images, sinos, theta
