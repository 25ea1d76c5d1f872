// Fused Joseph forward projector for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_fused` (ct_pvae_tpu/ops/pallas_radon.py,
// driven by `_fused_fwd_impl` / `radon_pallas_fused`).  It computes, for a
// square (B, N, N) float32 image and an (A, 5) table of per-angle rows
// (slope_t, slope_r, offset, weight, is_y):
//
//   out[b, a, t] = w_a * sum_r sum_y src[b, r, y] * max(0, 1 - |y - pos|)
//   pos          = offset_a + slope_t_a * t + slope_r_a * r
//
// where src is the image, or its transpose when the row's is_y flag is set.
//
// Design.  The TPU kernel builds a dense (W, T) hat-weight tile per image row
// so that the sum runs on its matrix unit.  Each hat has only two non-zeros
// per (row, detector): y0 = floor(pos) with weight 1-f and y0+1 with weight
// f, and pixels outside [0, N) count as zero.  This kernel evaluates just
// those two taps, about N/2 (64x at N = 128) fewer multiply-adds than the
// dense tile.  One thread owns one (b, a, t) ray: it walks the N rows,
// gathers the two taps through strides that select the straight or the
// transposed image by the flag (no transposed copy is made), and scales by
// w_a once at the end.  Float32 throughout, no atomics: the result is
// deterministic.
//
// Bound.  The gather reads.  Every tap is a load from a data-dependent
// address followed by one multiply-add, so the kernel is limited by how fast
// loads issue and return from L1/L2 (a (N, N) image is 64 KB at N = 128 and
// stays cached), not by device-memory bytes (about 4 MB per serving call)
// nor by float32 arithmetic.  The transposed rows (is_y) read down a column,
// one cache line per thread of a warp.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launch.  The caller allocates `out`.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;

__global__ void joseph_fwd_kernel(const float* __restrict__ img,
                                  const float* __restrict__ table,
                                  float* __restrict__ out,
                                  int n, int n_angles, int n_det) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  if (t >= n_det) return;

  const float* row = table + 5 * a;
  const float slope_t = row[0];
  const float slope_r = row[1];
  const float offset = row[2];
  const float weight = row[3];
  const bool is_y = row[4] > 0.5f;

  const float* src = img + static_cast<size_t>(b) * n * n;
  // straight image: src[r, y] at r*n + y; transposed: src[y, r] at y*n + r
  const int stride_r = is_y ? 1 : n;
  const int stride_y = is_y ? n : 1;

  const float base = offset + slope_t * static_cast<float>(t);
  float acc = 0.0f;
  for (int r = 0; r < n; ++r) {
    const float pos = base + slope_r * static_cast<float>(r);
    const float y0f = floorf(pos);
    const int y0 = static_cast<int>(y0f);
    const float* line = src + static_cast<size_t>(r) * stride_r;
    if (y0 >= 0 && y0 < n) {
      acc += __ldg(line + static_cast<size_t>(y0) * stride_y) *
             fmaxf(0.0f, 1.0f - fabsf(y0f - pos));
    }
    if (y0 + 1 >= 0 && y0 + 1 < n) {
      acc += __ldg(line + static_cast<size_t>(y0 + 1) * stride_y) *
             fmaxf(0.0f, 1.0f - fabsf(y0f + 1.0f - pos));
    }
  }
  out[(static_cast<size_t>(b) * n_angles + a) * n_det + t] = acc * weight;
}

}  // namespace

extern "C" int joseph_fwd(const void* img, const void* table, void* out,
                          int batch, int n, int n_angles, int n_det,
                          void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((n_det + kThreads - 1) / kThreads, n_angles, batch);
  joseph_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(table),
      static_cast<float*>(out), n, n_angles, n_det);
  return static_cast<int>(cudaGetLastError());
}
