"""Build and bind the port's CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

Each source is compiled at first use, for ``sm_90a``, into a shared library
with a plain C interface under ``ct_pvae_tpu_torch/build/`` (git-ignored),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds.  ``-Xptxas -v`` puts each kernel's
registers, shared memory and spills into ``BUILD_LOG``.  Nothing is compiled
when this module is imported.
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
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the largest image kernel C stages: four lines of n + 5 pixels x 4 images in
# its 96 KB slab
FWD_STATIC_MAX_N = 96 * 1024 // (4 * 16) - 5

_LIBS: Dict[str, ctypes.CDLL] = {}
# wall seconds of the parallel build each library took part in (0.0 when cached)
BUILD_SECONDS: Dict[str, float] = {}
# ptxas's report (registers, shared memory, spills) of each library built here
BUILD_LOG: Dict[str, str] = {}


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
# The Joseph kernels take (input, table or rows, output, batch, n, n_angles,
# n_det, stream); each picks its launch shape from the sizes.
_JOSEPH_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
# (x, kern, bias, out, batch, h, w, c_in, f_out, stream)
_CONV_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_SIGNATURES = {
    "joseph_fwd": [("joseph_fwd", _JOSEPH_ARGS, ctypes.c_int)],
    "joseph_adj": [("joseph_adj", _JOSEPH_ARGS, ctypes.c_int)],
    "joseph_fwd_static": [("joseph_fwd_static", _JOSEPH_ARGS, ctypes.c_int)],
    "joseph_adj_static": [("joseph_adj_static", _JOSEPH_ARGS, ctypes.c_int)],
    "conv_fused": [("conv_fused_maxout", _CONV_ARGS, ctypes.c_int)],
}


def _so_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
            BUILD_LOG[name] = err
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


def _call(lib_name: str, device: torch.device, *args) -> None:
    """Launch the entry point of library ``lib_name`` with ``args`` on
    ``device``'s current stream; raise if the launch failed."""
    fn_name = _SIGNATURES[lib_name][0][0]
    fn = getattr(load_libraries(lib_name)[lib_name], fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")


def _check_grid(ok: bool, **sizes: int) -> None:
    if not ok:
        raise ValueError("grid out of range: " + ", ".join(f"{k} {v}" for k, v in sizes.items()))


def joseph_fwd(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Launch the first design of kernel A (``csrc/joseph_fwd.cu``, a yardstick:
    no path calls it) on CUDA tensors: (B, N, N) x (A, 5) -> (B, A, n_det)."""
    _check_cuda_f32(image=image, table=table)
    b, n, n2 = image.shape
    a = table.shape[0]
    if n != n2 or table.shape != (a, 5):
        raise ValueError(f"bad shapes image {tuple(image.shape)} table {tuple(table.shape)}")
    _check_grid(0 < a <= 65535 and 0 < b <= 65535 and n > 0 and n_det > 0,
                batch=b, angles=a, n=n, n_det=n_det)
    out = torch.empty((b, a, n_det), dtype=torch.float32, device=image.device)
    _call("joseph_fwd", image.device, image.data_ptr(), table.data_ptr(), out.data_ptr(),
          b, n, a, n_det)
    return out


def joseph_adj(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the first design of kernel B (``csrc/joseph_adj.cu``, a yardstick:
    no path calls it) on CUDA tensors: (B, A, T) x (A, 5) -> (B, n, n).
    Any number of angles: the kernel stages the table in chunks."""
    _check_cuda_f32(sino=sino, table=table)
    b, a, n_det = sino.shape
    if table.shape != (a, 5):
        raise ValueError(f"bad shapes sinogram {tuple(sino.shape)} table {tuple(table.shape)}")
    _check_grid(0 < a and 0 < b <= 65535 and 0 < n and -(-n // 8) <= 65535, batch=b, angles=a, n=n)
    out = torch.empty((b, n, n), dtype=torch.float32, device=sino.device)
    _call("joseph_adj", sino.device, sino.data_ptr(), table.data_ptr(), out.data_ptr(),
          b, n, a, n_det)
    return out


def _check_rows(rows: torch.Tensor, n_rows: int) -> None:
    if rows.shape != (n_rows, 8):
        raise ValueError(f"kernel rows must be ({n_rows}, 8), got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("kernel rows must be 16-byte aligned (read as float4)")


def joseph_fwd_static(image: torch.Tensor, rows: torch.Tensor, n_det: int) -> torch.Tensor:
    """Launch the forward kernel (C, and A) on CUDA tensors: (B, N, N) x (A, 8)
    kernel rows in any order -> (B, A, n_det), output angle a from row a."""
    _check_cuda_f32(image=image, rows=rows)
    b, n, n2 = image.shape
    if n != n2:
        raise ValueError(f"image must be (B, N, N), got {tuple(image.shape)}")
    a = rows.shape[0]
    _check_rows(rows, a)
    if n > FWD_STATIC_MAX_N:
        raise ValueError(f"kernel C takes images up to {FWD_STATIC_MAX_N} pixels, got {n}")
    # grid (detector tiles, row groups of 8 or 16 and a spare, batch chunks
    # of 4 x halves of the lines)
    _check_grid(0 < a <= 8 * 65534 and 0 < b and -(-b // 4) * 2 <= 65535 and n > 0 and n_det > 0,
                batch=b, rows=a, n=n, n_det=n_det)
    out = torch.zeros((b, a, n_det), dtype=torch.float32, device=image.device)
    _call("joseph_fwd_static", image.device, image.data_ptr(), rows.data_ptr(), out.data_ptr(),
          b, n, a, n_det)
    return out


def joseph_adj_static(sino: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the adjoint kernel (D, and B) on CUDA tensors: (B, A, T) x (A, 8)
    kernel rows -> (B, n, n), sinogram angle a against row a.  Any number of
    angles: the kernel stages the rows in chunks."""
    _check_cuda_f32(sino=sino, rows=rows)
    b, a, n_det = sino.shape
    _check_rows(rows, a)
    # grid (column tiles, row tiles, batch chunks of at least 4)
    _check_grid(0 < a and 0 < b and -(-b // 4) <= 65535 and 0 < n and -(-n // 8) <= 65535,
                batch=b, angles=a, n=n)
    out = torch.empty((b, n, n), dtype=torch.float32, device=sino.device)
    _call("joseph_adj_static", sino.device, sino.data_ptr(), rows.data_ptr(), out.data_ptr(),
          b, n, a, n_det)
    return out


# output channel pairs per block (kMaxPairs in conv_fused.cu)
CONV_MAX_PAIRS = 64


def conv_fused_maxout(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch kernel E on CUDA tensors: (B, H, W, C) x (3, 3, C, 2F) x (2F,) -> (B, H, W, F)."""
    _check_cuda_f32(x=x, kern=kern, bias=bias)
    b, h, w, c = x.shape
    f = kern.shape[-1] // 2
    if kern.shape != (3, 3, c, 2 * f) or f < 1 or bias.shape != (2 * f,):
        raise ValueError(f"bad shapes x {tuple(x.shape)} kern {tuple(kern.shape)} "
                         f"bias {tuple(bias.shape)}")
    z = b * -(-f // min(f, CONV_MAX_PAIRS))
    if not (b > 0 and h > 0 and w > 0 and c > 0 and z <= 65535 and -(-h // 8) <= 65535):
        raise ValueError(f"grid out of range: x {tuple(x.shape)}, F {f}")
    out = torch.empty((b, h, w, f), dtype=torch.float32, device=x.device)
    _call("conv_fused", x.device, x.data_ptr(), kern.data_ptr(), bias.data_ptr(), out.data_ptr(),
          b, h, w, c, f)
    return out
