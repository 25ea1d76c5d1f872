"""A trained run's directory, written by the benchmark for the serving cell.

``write_run`` writes ``config.json`` and
``training_checkpoints/ckpt-<step>.msgpack`` in the layout a run trained by
the paper's code keeps (a flax ``TrainState`` serialised as msgpack: every
array an ext-1 object holding ``[shape, dtype name, raw bytes]``; params as
``encoder``/``decoder`` trees of ``ConvBlock_<i>`` with the two maxout
branches ``Conv_0``/``Conv_1`` or ``ConvTranspose_0``/``_1``, each an HWIO
``kernel`` and a ``bias``).  The msgpack writer is the subset that tree
needs.  A transposed conv's kernel is stored as flax correlates it with the
dilated input: the ``conv_transpose2d`` weight flipped in both spatial axes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List

import numpy as np
import torch

from .reference.pvae import Sizes


def _len(out: bytearray, n: int, fix: int, fix_max: int, tags) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} too large")


def _int(out: bytearray, x: int) -> None:
    """A non-negative int (array dims) in msgpack's shortest form."""
    if x <= 0x7F:
        out.append(x)
    else:
        tag, fmt = ((0xCC, ">B") if x <= 0xFF else (0xCD, ">H") if x <= 0xFFFF else (0xCE, ">I"))
        out.append(tag)
        out += struct.pack(fmt, x)


def pack(out: bytearray, x: Any) -> None:
    """msgpack of dicts, lists, str, int, bytes and numpy arrays (ext 1)."""
    if isinstance(x, int):
        _int(out, x)
    elif isinstance(x, str):
        raw = x.encode()
        _len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, bytes):
        _len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, list):
        _len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            pack(out, v)
    elif isinstance(x, dict):
        _len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            pack(out, k)
            pack(out, v)
    elif isinstance(x, np.ndarray):
        inner = bytearray()
        pack(inner, [[int(d) for d in x.shape], x.dtype.name, np.ascontiguousarray(x).tobytes()])
        n = len(inner)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)
        else:
            _len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", 1)
        out += inner
    else:
        raise TypeError(f"cannot write {type(x).__name__}")


def flax_tree(blocks, tensors: List[torch.Tensor]) -> Dict:
    """A model's params tree from its stored (weight, bias) pairs."""
    tree = {}
    for i, blk in enumerate(blocks):
        w = tensors[2 * i].detach().cpu().numpy()
        b = tensors[2 * i + 1].detach().cpu().numpy()
        base = "ConvTranspose" if blk.transpose else "Conv"
        leaves = {}
        for h in range(2):
            part = slice(h * blk.features, (h + 1) * blk.features)
            if blk.transpose:  # (C, 2F, k, k), flipped -> HWIO
                kern = w[:, part].transpose(2, 3, 0, 1)[::-1, ::-1]
            else:              # (2F, C, k, k) -> HWIO
                kern = w[part].transpose(2, 3, 1, 0)
            leaves[f"{base}_{h}"] = {"bias": np.ascontiguousarray(b[part], np.float32),
                                     "kernel": np.ascontiguousarray(kern, np.float32)}
        tree[f"ConvBlock_{i}"] = leaves
    return tree


def write_run(path: str, config: Dict, sizes: Sizes, weights: Dict[str, List[torch.Tensor]],
              step: int) -> None:
    """``path/config.json`` and ``path/training_checkpoints/ckpt-<step>.msgpack``:
    ``weights`` at ``step``, kl anneal 1 and the run's starting pnm."""
    os.makedirs(os.path.join(path, "training_checkpoints"), exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    state = {
        "params": {"decoder": flax_tree(sizes.decoder, weights["decoder"]),
                   "encoder": flax_tree(sizes.encoder, weights["encoder"])},
        "opt_state": {},
        "kl_anneal": np.array(1.0, np.float32),
        "pnm": np.array(config["pnm_start"], np.float32),
        "step": np.array(step, np.int32),
    }
    out = bytearray()
    pack(out, state)
    with open(os.path.join(path, "training_checkpoints", f"ckpt-{step}.msgpack"), "wb") as f:
        f.write(bytes(out))
