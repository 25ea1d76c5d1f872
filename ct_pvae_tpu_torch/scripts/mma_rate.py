"""The card's mma.sync rate for TF32 (m16n8k8, float32 accumulate), on one GPU.

    python -m ct_pvae_tpu_torch.scripts.mma_rate

Kernel E (``csrc/conv_fused_mma.cu``) issues its 3xTF32 products as
``mma.sync.m16n8k8`` from 8 warps a block, one block per SM, each warp
with 20 independent accumulator tiles (2 m-tiles x 10 n-tiles).  This
script builds a kernel that does nothing else, in that shape (operands in
registers, no loads), times it with the host held out
(``step_cost.cuda_time``) and prints one JSON line: the TF32 rate in
TFLOP/s and in products a second per SM, its share of the published 495
TFLOP/s of the TF32 tensor cores (reached through wgmma), and what that
rate makes of E's 3xTF32 work at the probe's shape.  It needs a CUDA GPU and nvcc, and
exits 1 without them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__global__ void __launch_bounds__(256, 1) mma_rate_kernel(float* out, int iters) {
  float acc[2][10][4] = {};
  uint32_t a[2][4], b[10][2];
  for (int m = 0; m < 2; ++m)
    for (int r = 0; r < 4; ++r) a[m][r] = threadIdx.x * (m + 3) + r;
  for (int n = 0; n < 10; ++n)
    for (int r = 0; r < 2; ++r) b[n][r] = threadIdx.x + 5 * n + r;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 10; ++n)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[m][n][0]), "+f"(acc[m][n][1]), "+f"(acc[m][n][2]), "+f"(acc[m][n][3])
            : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]), "r"(b[n][0]), "r"(b[n][1]));
  }
  float s = 0.0f;
  for (int m = 0; m < 2; ++m)
    for (int n = 0; n < 10; ++n)
      for (int r = 0; r < 4; ++r) s += acc[m][n][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(void* out, int blocks, int iters, void* stream) {
  mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""

TF32_FLOPS_PER_S = 495e12
MMA_FLOPS = 2 * 16 * 8 * 8
PROBE_FLOPS_3XTF32 = 3 * 2 * 10 * 128 * 128 * 9 * 40 * 80  # E's three products at the probe's shape


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: torch.cuda.is_available() is False; this needs a CUDA GPU", file=sys.stderr)
        return 1
    from ..ops import _cuda
    from .step_cost import cuda_time

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _cuda.BUILD_DIR / "mma_rate.cu"
    so = _cuda.BUILD_DIR / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    iters = 2000
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ms = cuda_time(lambda: lib.mma_rate(out.data_ptr(), sms, iters, stream()), 5, per_sample=3)[0]
    products = sms * 8 * iters * 20
    rate = products * MMA_FLOPS / (ms * 1e-3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sms": sms,
        "ms": ms, "tf32_tflops": rate / 1e12, "share_of_495": rate / TF32_FLOPS_PER_S,
        "products_per_s_per_sm": products / sms / (ms * 1e-3),
        "probe_3xtf32_ms_at_this_rate": PROBE_FLOPS_3XTF32 / rate * 1e3,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
