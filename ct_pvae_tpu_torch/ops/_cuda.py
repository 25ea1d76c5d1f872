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
# wall seconds of the parallel build each library took part in (0.0 when cached)
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


# C signatures of the libraries' entry points: (name, argtypes, restype).
# Both take (input, table, output, batch, n, n_angles, n_det, stream).
_JOSEPH_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_SIGNATURES = {
    "joseph_fwd": [("joseph_fwd", _JOSEPH_ARGS, ctypes.c_int)],
    "joseph_adj": [("joseph_adj", _JOSEPH_ARGS, ctypes.c_int)],
}

# table rows the adjoint kernel keeps in shared memory (kMaxRows in joseph_adj.cu)
ADJ_MAX_ANGLES = 1024


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_libraries(*names: str) -> Dict[str, ctypes.CDLL]:
    """Build ``csrc/<name>.cu`` for each name not yet built, one nvcc process
    each, all started together; load them and declare their C signatures."""
    todo = [n for n in names if n not in _LIBS]
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, so)  # atomic: concurrent builds never load a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        BUILD_SECONDS[name] = time.perf_counter() - t0 if name in procs else 0.0
        lib = ctypes.CDLL(str(_so_path(name)))
        for fn_name, argtypes, restype in _SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[name] = lib
    return {n: _LIBS[n] for n in names}


def _check_cuda_f32(**tensors: torch.Tensor) -> None:
    devices = {x.device for x in tensors.values()}
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(devices) > 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _launch(lib_name: str, src: torch.Tensor, table: torch.Tensor, out: torch.Tensor,
            n: int, n_det: int) -> torch.Tensor:
    batch, a = src.shape[0], table.shape[0]
    if not (0 < a <= 65535 and 0 < batch <= 65535 and n > 0 and n_det > 0):
        raise ValueError(f"grid out of range: batch {batch}, angles {a}, n {n}, n_det {n_det}")
    fn = getattr(load_libraries(lib_name)[lib_name], lib_name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), table.data_ptr(), out.data_ptr(), batch, n, a, n_det, stream)
    if err != 0:
        raise RuntimeError(f"{lib_name} launch failed: cudaError {err}")
    return out


def joseph_fwd(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Launch the fused Joseph kernel on CUDA tensors: (B, N, N) x (A, 5) -> (B, A, n_det)."""
    _check_cuda_f32(image=image, table=table)
    b, n, n2 = image.shape
    if n != n2 or table.shape != (table.shape[0], 5):
        raise ValueError(f"bad shapes image {tuple(image.shape)} table {tuple(table.shape)}")
    out = torch.empty((b, table.shape[0], n_det), dtype=torch.float32, device=image.device)
    return _launch("joseph_fwd", image, table, out, n, n_det)


def joseph_adj(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the Joseph adjoint kernel on CUDA tensors: (B, A, T) x (A, 5) -> (B, n, n)."""
    _check_cuda_f32(sino=sino, table=table)
    b, a, n_det = sino.shape
    if table.shape != (a, 5):
        raise ValueError(f"bad shapes sinogram {tuple(sino.shape)} table {tuple(table.shape)}")
    if a > ADJ_MAX_ANGLES:
        raise ValueError(f"the adjoint kernel takes at most {ADJ_MAX_ANGLES} angles, got {a}")
    out = torch.empty((b, n, n), dtype=torch.float32, device=sino.device)
    return _launch("joseph_adj", sino, table, out, n, n_det)
