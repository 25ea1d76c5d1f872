"""Classical-reconstruction encoder inputs (port of ``data/recon_init.py``).

For each algorithm of the run, the mask-unnormalised sparse sinogram is
reconstructed at detector resolution and centre-cropped; one more channel is
the unfiltered backprojection of the mask itself (reference
helper_functions.py:477-529):

  gridrec         -> FBP with the ramp filter
  gridrec_fourier -> Fourier regridding (``ops/gridrec.py``)
  fbp             -> FBP with the shepp-logan filter
  sirt            -> 30 SIRT iterations  } on the static Joseph pair at detector
  tv              -> 60 Chambolle-Pock   } resolution (kernels C and D), as the JAX
                                           package's TPU route does (recon_init.py:144-153)

The FBP channels (and the mask channel) take ``fbp``'s route: kernel D on
the card from a 512-pixel detector on, the gather backprojector otherwise.
With ``cheap_init`` (serving), sirt and tv become the ramp-FBP, keeping the
channel count and order (recon_init.py:99-100).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops.fbp import fbp
from ..ops.gridrec import gridrec
from ..ops.joseph_radon import backproject_static, radon_static
from ..ops.sirt import sirt_with_ops
from ..ops.tv import tv_with_ops
from ..utils.trace import span
from .io import save_npy_atomic

_EPS = float(np.finfo(np.float32).eps)
_FILTER = {"gridrec": "ramp", "fbp": "shepp-logan"}


def crop_center(img: np.ndarray, final_x: int, final_y: int):
    """Centre crop of the trailing two dims (reference helper_functions.py:420-430)."""
    x, y = img.shape[-2], img.shape[-1]
    rx, ry = final_x % 2, final_y % 2
    return img[
        ...,
        x // 2 - final_x // 2 : x // 2 + final_x // 2 + rx,
        y // 2 - final_y // 2 : y // 2 + final_y // 2 + ry,
    ]


def _check_algorithms(algorithms: List[str]) -> None:
    for alg in algorithms:
        if alg not in _FILTER and alg not in ("gridrec_fourier", "sirt", "tv"):
            raise NotImplementedError(f"init algorithm {alg!r} is not ported")


def _recon(alg: str, sino: torch.Tensor, theta_t: torch.Tensor, theta: tuple,
           size: int) -> torch.Tensor:
    if alg in _FILTER:
        return fbp(sino, theta_t, size, size, _FILTER[alg])
    if alg == "gridrec_fourier":
        return gridrec(sino, theta_t, size, size, "ramp")

    def fwd(img):
        return radon_static(img, theta, size)

    def adj(s):
        return backproject_static(s, theta, size, size)

    if alg == "sirt":
        return sirt_with_ops(sino, fwd, adj, size, size, num_iter=30)
    return tv_with_ops(sino, fwd, adj, size, size, num_iter=60)


def classical_recon_stack(
    all_proj_samples: np.ndarray,
    all_masks: np.ndarray,
    theta: np.ndarray,
    algorithms: List[str],
    x_size: int,
    y_size: int,
    device: torch.device,
    save_path: Optional[str] = None,
    batch: int = 32,
    reuse_cache: bool = False,
    cheap_init: bool = False,
    write_cache: bool = True,
) -> np.ndarray:
    """The (N, x, y, num_algorithms+1) encoder-input stack as a host array.

    Cached to ``all_input_encode_cheap.npy`` (``all_input_encode.npy``
    without ``cheap_init``) under ``save_path``; ``reuse_cache`` reloads a
    file of the requested shape.
    """
    if cheap_init:
        algorithms = ["gridrec" if a in ("sirt", "tv") else a for a in algorithms]
    _check_algorithms(algorithms)
    cache_name = "all_input_encode_cheap.npy" if cheap_init else "all_input_encode.npy"
    n, a, p = all_proj_samples.shape
    if save_path is not None and reuse_cache:
        cache = os.path.join(save_path, cache_name)
        if os.path.exists(cache):
            stack = np.load(cache)
            if stack.shape == (n, x_size, y_size, len(algorithms) + 1):
                return stack

    proj = torch.as_tensor(np.asarray(all_proj_samples, np.float32), device=device)
    masks = torch.as_tensor(np.asarray(all_masks, np.float32), device=device)
    theta_t = torch.as_tensor(np.asarray(theta, np.float32), device=device)
    theta_f = tuple(float(t) for t in np.asarray(theta, np.float32))
    mask_expand = masks[:, :, None].expand(n, a, p)
    measured = mask_expand > _EPS
    unnorm = torch.where(measured, proj / torch.where(measured, mask_expand, 1.0), proj)

    size = p  # reconstruct at detector resolution, then crop (like tomopy)
    batch = max(1, min(batch, int(batch * (184.0 / size) ** 2)))
    outs = []
    for i in range(0, n, batch):
        sino_b, mask_b = unnorm[i : i + batch], mask_expand[i : i + batch]
        chans = []
        for alg in algorithms:
            with span(f"ctpvae.setup.init_stack.{alg}"):
                chans.append(_recon(alg, sino_b.contiguous(), theta_t, theta_f, size))
        with span("ctpvae.setup.init_stack.mask"):
            chans.append(fbp(mask_b, theta_t, size, size, "none"))
        with span("ctpvae.setup.init_stack.readback"):
            outs.append(torch.stack(chans, dim=1).cpu().numpy())  # (B, C, size, size)
    with span("ctpvae.setup.init_stack.assemble"):
        stack = crop_center(np.concatenate(outs, axis=0), x_size, y_size)
        stack = np.ascontiguousarray(np.moveaxis(stack, 1, -1), dtype=np.float32)

    if save_path is not None and write_cache:  # rank 0 writes, atomically: other ranks read it
        os.makedirs(save_path, exist_ok=True)
        save_npy_atomic(os.path.join(save_path, cache_name), stack)
    return stack
