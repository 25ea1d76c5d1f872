"""Build and bind the port's CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

Each source is compiled at first use, for ``sm_90a``, into a shared library
with a plain C interface under ``ct_pvae_tpu_torch/build/`` (git-ignored),
named by a hash of the source and flags so an edited source rebuilds.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was cached)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


# C signatures of the libraries' entry points: (name, argtypes, restype)
_SIGNATURES = {
    "joseph_fwd": [(
        "joseph_fwd",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    )],
}


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it and declare its C signatures."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builds never load a partial file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes, restype in _SIGNATURES[name]:
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    _LIBS[name] = lib
    return lib


def joseph_fwd(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Launch the fused Joseph kernel on CUDA tensors: (B, N, N) x (A, 5) -> (B, A, n_det)."""
    for name, x in (("image", image), ("table", table)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if image.device != table.device:
        raise ValueError(f"image on {image.device} but table on {table.device}")
    b, n, n2 = image.shape
    a = table.shape[0]
    if n != n2 or table.shape != (a, 5):
        raise ValueError(f"bad shapes image {tuple(image.shape)} table {tuple(table.shape)}")
    if not (0 < a <= 65535 and 0 < b <= 65535 and n_det > 0):
        raise ValueError(f"grid out of range: batch {b}, angles {a}, n_det {n_det}")
    lib = load_library("joseph_fwd")
    out = torch.empty((b, a, n_det), dtype=torch.float32, device=image.device)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.joseph_fwd(
            image.data_ptr(), table.data_ptr(), out.data_ptr(), b, n, a, n_det, stream
        )
    if err != 0:
        raise RuntimeError(f"joseph_fwd launch failed: cudaError {err}")
    return out
