"""Random-roll angle augmentation (port of ``ct_pvae_tpu/vi/augment.py``).

For uniform angles theta_a = a pi / A, rotating the object by phi = theta_k
shifts the sinogram's angle axis by k rows, and a row that wraps past pi
comes back with its detector axis flipped:

  R[rot_phi f](theta, s) = R[f](theta - phi, s),   R[f](theta + pi, s) = R[f](theta, -s)

So ``roll_batch`` rolls each example's sinogram by its k (flipping the
wrapped rows), rolls its mask without a flip, and rotates its encoder-input
stack by +phi with ``rotate_image``, the projector's convention.  The roll
indices ``k`` come from the caller: the Trainer draws them from its own
seeded generator when ``Config.roll_augment`` is set.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.radon import rotate_image


def roll_batch(batch: Dict[str, torch.Tensor], theta: torch.Tensor,
               k: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Roll example b's angle axis by ``k[b]`` (vi/augment.py:30-55).

    batch: proj_sample (B, A, P), mask (B, A), input_encode (B, X, Y, C).
    """
    sino, mask = batch["proj_sample"], batch["mask"]
    num_angles = theta.shape[0]
    a = torch.arange(num_angles, device=k.device)
    src = torch.remainder(a[None, :] - k[:, None], num_angles)   # rolled[a] = x[(a - k) % A]
    rolled = torch.gather(sino, 1, src[:, :, None].expand(-1, -1, sino.shape[-1]))
    wrap = (a[None, :] < k[:, None])[:, :, None]                 # rows that crossed pi
    return {
        "proj_sample": torch.where(wrap, rolled.flip(-1), rolled),
        "mask": torch.gather(mask, 1, src),
        "input_encode": rotate_image(batch["input_encode"], theta.index_select(0, k)),
    }
