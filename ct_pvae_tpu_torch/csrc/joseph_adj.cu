// Adjoint of the fused Joseph projector (backprojection) for Hopper (sm_90a).
//
// Replaces the TPU kernels `_adj_kernel_fused` (ct_pvae_tpu/ops/pallas_radon.py,
// driven by `_fused_adj_impl`, the VJP of `radon_pallas_fused`) and, fed the
// full static-angle table, `_adj_kernel` (driven by `_run_group_adj`, behind
// `backproject_pallas` and the VJP of `radon_pallas`).  For a (B, A, T)
// float32 sinogram g and the (A, 5) table of joseph_fwd.cu it computes the
// exact transpose of that kernel:
//
//   img[b, i, j] = sum_a w_a * sum_t g[b, a, t] * max(0, 1 - |y - pos_a(r, t)|)
//   pos_a(r, t)  = offset_a + slope_t_a * t + slope_r_a * r
//
// with (r, y) = (i, j) for an x-major row (flag 0) and (j, i) for a y-major
// row (flag 1), i.e. the y-major rows land on the transposed image.
//
// Design.  The TPU kernel scatters each angle into a straight and a
// transposed image buffer with dense (T, W) weight tiles and sums the two
// afterwards.  Here the sum is a gather: one thread owns one output pixel
// (b, i, j) and walks the table rows, so no atomics and no second buffer are
// needed and the result is deterministic.  Every row has |slope_t| >= 1, so
// for fixed (r, y) the hat is non-zero for at most two detector bins, those
// within 1/|slope_t| of u = (y - offset - slope_r * r) / slope_t.  The thread
// takes t0 = floor(u) and tests t0-1 .. t0+2, recomputing each hat with the
// forward kernel's own expression (base = offset + slope_t * t, then
// pos = base + slope_r * r), so the taps it finds are bitwise the forward's
// taps: <A x, g> = <x, A^T g> holds to float rounding.  A candidate whose hat
// is zero adds exactly zero.
//
// Bound.  Per pixel and row: a few flops and at most two loads of g from a
// data-dependent address.  g (20 x 20 x 184 floats in training, 32 x 180 x
// 184 in the init stack) stays in L2, and the table sits in shared memory,
// so the kernel is bound by load throughput and latency, not by device-memory
// bytes or float32 arithmetic.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launch.  The caller allocates `img`.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileJ = 32;
constexpr int kTileI = 8;
constexpr int kMaxRows = 1024;  // table rows held in shared memory

__global__ void joseph_adj_kernel(const float* __restrict__ sino,
                                  const float* __restrict__ table,
                                  float* __restrict__ img,
                                  int n, int n_angles, int n_det) {
  __shared__ float tab[kMaxRows * 5];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < n_angles * 5; k += blockDim.x * blockDim.y) {
    tab[k] = table[k];
  }
  __syncthreads();

  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const int i = blockIdx.y * kTileI + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= n || j >= n) return;

  const float* g = sino + static_cast<size_t>(b) * n_angles * n_det;
  float acc = 0.0f;
  for (int a = 0; a < n_angles; ++a) {
    const float slope_t = tab[5 * a + 0];
    const float slope_r = tab[5 * a + 1];
    const float offset = tab[5 * a + 2];
    const float weight = tab[5 * a + 3];
    const bool is_y = tab[5 * a + 4] > 0.5f;
    const float rf = static_cast<float>(is_y ? j : i);
    const float yf = static_cast<float>(is_y ? i : j);
    const int t0 = static_cast<int>(floorf((yf - offset - slope_r * rf) / slope_t));
    const float* row = g + static_cast<size_t>(a) * n_det;
    float part = 0.0f;
    for (int t = t0 - 1; t <= t0 + 2; ++t) {
      if (t < 0 || t >= n_det) continue;
      const float base = offset + slope_t * static_cast<float>(t);
      const float pos = base + slope_r * rf;
      const float hat = fmaxf(0.0f, 1.0f - fabsf(yf - pos));
      if (hat > 0.0f) part += __ldg(row + t) * hat;
    }
    acc += part * weight;
  }
  img[(static_cast<size_t>(b) * n + i) * n + j] = acc;
}

}  // namespace

extern "C" int joseph_adj(const void* sino, const void* table, void* img,
                          int batch, int n, int n_angles, int n_det,
                          void* stream) {
  if (n_angles > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileJ, kTileI);
  const dim3 grid((n + kTileJ - 1) / kTileJ, (n + kTileI - 1) / kTileI, batch);
  joseph_adj_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sino), static_cast<const float*>(table),
      static_cast<float*>(img), n, n_angles, n_det);
  return static_cast<int>(cudaGetLastError());
}
