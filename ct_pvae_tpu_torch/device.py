"""Device selection shared by the port's entry points.

The entry points run on the GPU unless the caller names the CPU: there is no
silent CPU fallback when no card is present.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port's plain CPU path explicitly"
        )
    return dev


def exact_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convs (the reference is exact f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
