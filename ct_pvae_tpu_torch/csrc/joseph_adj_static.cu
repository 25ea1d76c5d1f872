// Static-angle Joseph adjoint (backprojection) for Hopper (sm_90a): kernel D.
//
// Replaces the TPU kernel `_adj_kernel` (ct_pvae_tpu/ops/pallas_radon.py:152,
// driven per major-axis group by `_run_group_adj` :224 behind
// `backproject_pallas` :308 and the VJP of `radon_pallas`).  For a (B, A, T)
// float32 sinogram g and the (A, 8) kernel rows of joseph_tap.cuh it
// computes the exact transpose of kernel C (joseph_fwd_static.cu):
//
//   img[b, i, j] = sum_a w_a * sum_t g[b, a, t] * max(0, 1 - |y - pos_a(r, t)|)
//
// with (r, y) = (i, j) for an x-major row and (j, i) for a y-major row.
//
// Design.  The TPU kernel builds one (T, W) hat tile per (angle, line) and
// applies it to a whole batch tile in one matrix product (P[a, B, :] @ G).
// The first port (kernel B's entry point fed the full table) ran one thread
// per (b, i, j) and searched the taps again for every image, with a float
// division and four candidate bins per (pixel, angle).  Here:
//
//  * A block owns a tile of 8 x 32 pixels and a chunk of CB batch images (4,
//    8 or 16, by the batch); a thread owns one pixel and keeps the sums of
//    its CB images in registers.  For each angle it finds the pixel's taps
//    once and applies each to all CB images: hat * w_a times a float4 of
//    the chunk, CB fmaf.  A ragged last chunk stages zeros.
//  * The tap search costs one multiply by the row's 1/slope_t, no division:
//    u = (y - offset - slope_r * r) / slope_t is where the ray through the
//    pixel's centre meets the detector.  Every row has |slope_t| >= 1, so in
//    exact arithmetic only floor(u) and floor(u) + 1 can carry a non-zero
//    hat (|t - u| < 1/|slope_t| <= 1).  The thread takes k = floor(u + 0.5)
//    and the two bins around u, k - 1 and k or k and k + 1 by the sign of
//    u - k; when u lies within kNear of k, where rounding of u or of the
//    forward's pos can give the bin on the far side of k a hat, it tests
//    that guard bin too.  Each bin's hat is the forward's own expression
//    (`joseph_pos`, `joseph_hat`), so the taps are bitwise kernel C's and a
//    bin outside the hat adds nothing.
//  * The kernel rows go through shared memory kChunkRows at a time (so any
//    number of angles is taken), and with them each row's band start for
//    the tile: a multiple of 4 at least two bins below the smallest k over
//    the tile's four corners (u is affine in the pixel).  The tile's bins
//    then lie within kBand = 40 of it, since |cos|, |sin| <= 1 bound u's
//    spread over 8 x 32 pixels by 32 bins.
//  * The bands, kBand bins x CB images per angle, go through shared memory
//    kAngles angles at a time, batch-innermost, so one bin is CB/4 float4
//    loads.  The staging reads g along t in 16-byte loads, 4 bins of 4
//    images per thread, transposes them in registers, and issues the next
//    angles' loads before the block computes these ones, so that their
//    latency hides behind the compute.  The tile reads each staged bin
//    about 8 + 32 times.
//  * tests/test_torch_static_taps.py holds the bins against every tap of the
//    forward and the band against every bin, on the paper geometry.
//
// Exact float32 fmaf on the CUDA cores (no TF32, no tensor cores), one fixed
// order per pixel (angle, then bin); no atomics, deterministic.
//
// Bound.  At the init stack's shape ((32, 180, 184) -> (32, 184, 184)) the
// in-range taps need 663,503,360 flops, 0.0099 ms at 67 TFLOP/s, and 8.5 MB
// of traffic, 0.0026 ms at 3.35 TB/s: bound by operations on paper.  Here
// every tap of every image is a float read from shared memory for one fmaf,
// so the kernel is bound by shared-memory bandwidth (128 bytes a clock per
// SM: about 0.05 ms for the two bins per pixel and angle at that shape) and
// by the issue slots of the tap search and the staging.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launch.  The caller allocates `img`.

#include <cuda_runtime.h>

#include <cstddef>

#include "joseph_tap.cuh"

namespace {

// Batch images per thread for a batch of `batch`: 4, 8 or 16.
int batch_chunk(int batch) { return batch <= 4 ? 4 : batch <= 8 ? 8 : 16; }

constexpr int kTileJ = 32;   // pixels along a row per block (blockDim.x)
constexpr int kTileI = 8;    // rows per block (blockDim.y)
constexpr int kThreads = kTileJ * kTileI;
constexpr int kChunkRows = 256;  // kernel rows in shared memory at a time
constexpr int kAngles = 6;       // angles whose bands are staged at a time
constexpr int kBand = 40;        // bins staged per angle: the tile's taps need 39
// u within kNear of an integer: the guard bin is tested too.  Rounding moves
// u and pos by about 1e-4 bins at these sizes; the forward's taps need the
// guard bin only when u is that close (tests/test_torch_static_taps.py).
constexpr float kNear = 1e-3f;

// u = (y - offset - slope_r * r) / slope_t, through the row's reciprocal
__device__ __forceinline__ float detector_u(float4 lo, float inv, float r, float y) {
  return (y - __fmaf_rn(lo.y, r, lo.z)) * inv;
}

// floats per staged bin: CB, padded so that S/4 is odd and eight lanes
// reading neighbouring bins as float4 hit eight different bank groups
__host__ __device__ constexpr int bin_stride(int cb) { return (cb / 4) % 2 ? cb : cb + 4; }

// hat * w_a of bin t for the pixel (r, y): the forward's own expression
__device__ __forceinline__ float bin_weight(float4 lo, int t, float r, float y) {
  return joseph_hat(y, joseph_pos(lo.x, lo.y, lo.z, static_cast<float>(t), r)) * lo.w;
}

// acc[c] += w * bin[c] for the CB images of a staged bin
template <int CB>
__device__ __forceinline__ void add_bin(float (&acc)[CB], const float* bin, float w) {
  const float4* v = reinterpret_cast<const float4*>(bin);
#pragma unroll
  for (int c4 = 0; c4 < CB / 4; ++c4) {
    const float4 x = v[c4];
    acc[4 * c4 + 0] = fmaf(w, x.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, x.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, x.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, x.w, acc[4 * c4 + 3]);
  }
}

// Units of 4 bins x 4 images that stage q0 .. q0 + count - 1 of the
// current table chunk (kAngles angles at most) spread over the block's
// threads: at most kUnits for one thread.
template <int CB>
struct Stage {
  static constexpr int kPerAngle = kBand / 4 * (CB / 4);
  static constexpr int kUnits = (kAngles * kPerAngle + kThreads - 1) / kThreads;
  float4 px[kUnits][4];

  // Issue the loads of the thread's units: 16-byte loads of 4 bins of one
  // image each; band_lo is a multiple of 4, so with n_det % 4 == 0 a unit
  // is whole, aligned, and all on or all off the detector.
  __device__ __forceinline__ void load(const float* g, size_t plane, int nb, int n_det, bool vec,
                                       const int* band_lo, int a0, int q0, int count, int tid) {
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int u = tid + m * kThreads;
      const int c4 = u % (CB / 4), w = 4 * (u / (CB / 4) % (kBand / 4));
      const bool unit = u < count * kPerAngle;
      const int q = q0 + (unit ? u / kPerAngle : 0);
      const int t = band_lo[q] + w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * c4 + k;
        const float* p = g + c * plane + (a0 + q) * n_det + t;
        px[m][k] = load4(p, unit && c < nb && t >= 0 && t < n_det, vec, n_det - t);
      }
    }
  }

  // Store them transposed, batch-innermost: band[q - q0][bin][image].
  __device__ __forceinline__ void store(float* band, int count, int tid) const {
    constexpr int S = bin_stride(CB);
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int u = tid + m * kThreads;
      if (u >= count * kPerAngle) continue;
      const int c4 = u % (CB / 4), w = 4 * (u / (CB / 4) % (kBand / 4)), q = u / kPerAngle;
      store_transposed(reinterpret_cast<float4*>(band + (q * kBand + w) * S + 4 * c4), S / 4,
                       px[m]);
    }
  }
};

template <int CB>
__global__ void __launch_bounds__(kThreads) joseph_adj_static_kernel(
    const float* __restrict__ sino, const float* __restrict__ rows,
    float* __restrict__ img, int batch, int n, int n_angles, int n_det) {
  constexpr int S = bin_stride(CB);
  __shared__ __align__(16) float band[kAngles * kBand * S];
  __shared__ float4 tab[2 * kChunkRows];
  __shared__ int band_lo[kChunkRows];

  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  const int i0 = blockIdx.y * kTileI;
  const int j0 = blockIdx.x * kTileJ;
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  const int b0 = blockIdx.z * CB;
  const int nb = min(CB, batch - b0);
  const bool inside = i < n && j < n;
  const float fi = static_cast<float>(i);
  const float fj = static_cast<float>(j);
  const size_t plane = static_cast<size_t>(n_angles) * n_det;
  const float* g = sino + b0 * plane;
  const bool vec = vec_loads(sino, n_det);

  float acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.0f;

  Stage<CB> stage;
  for (int a0 = 0; a0 < n_angles; a0 += kChunkRows) {
    const int rows_here = min(kChunkRows, n_angles - a0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int q = tid; q < rows_here; q += kThreads) {
      const float4* row = reinterpret_cast<const float4*>(rows + kRowFloats * (a0 + q));
      const float4 lo = __ldg(row);
      const float4 hi = __ldg(row + 1);
      tab[2 * q] = lo;
      tab[2 * q + 1] = hi;
      // the smallest window centre over the tile's corners, less the window
      // and one bin of slack, rounded down to a multiple of 4
      const bool is_y = hi.x > 0.5f;
      int k_min = 0x7fffffff;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const float ci = static_cast<float>(i0 + (corner & 1) * (kTileI - 1));
        const float cj = static_cast<float>(j0 + (corner >> 1) * (kTileJ - 1));
        const float u = detector_u(lo, hi.y, is_y ? cj : ci, is_y ? ci : cj);
        k_min = min(k_min, __float2int_rd(u + 0.5f));
      }
      band_lo[q] = (k_min - 2) & ~3;
    }
    __syncthreads();
    // kAngles angles at a time; the next ones' loads are in flight while
    // the block computes these
    stage.load(g, plane, nb, n_det, vec, band_lo, a0, 0, min(kAngles, rows_here), tid);
    for (int q0 = 0; q0 < rows_here; q0 += kAngles) {
      const int count = min(kAngles, rows_here - q0);
      __syncthreads();  // every thread is done with the band
      stage.store(band, count, tid);
      __syncthreads();
      if (q0 + kAngles < rows_here) {
        stage.load(g, plane, nb, n_det, vec, band_lo, a0, q0 + kAngles,
                   min(kAngles, rows_here - q0 - kAngles), tid);
      }
      if (!inside) continue;
      for (int q = q0; q < q0 + count; ++q) {
        const float4 lo = tab[2 * q];      // slope_t, slope_r, offset, weight
        const float4 hi = tab[2 * q + 1];  // is_y, 1/slope_t, angle index, 0
        const bool is_y = hi.x > 0.5f;
        const float rf = is_y ? fj : fi;
        const float yf = is_y ? fi : fj;
        const float u = detector_u(lo, hi.y, rf, yf);
        const int k = __float2int_rd(u + 0.5f);
        const float d = u - static_cast<float>(k);  // in [-0.5, 0.5]
        // the two bins on either side of u, and, when u is within kNear of
        // k, the guard bin on the far side of k
        const int t0 = d < 0.0f ? k - 1 : k;
        const int first = (q - q0) * kBand - band_lo[q];  // band bin of detector bin 0
        add_bin<CB>(acc, band + (first + t0) * S, bin_weight(lo, t0, rf, yf));
        add_bin<CB>(acc, band + (first + t0 + 1) * S, bin_weight(lo, t0 + 1, rf, yf));
        if (fabsf(d) < kNear) {
          const int t2 = d < 0.0f ? k + 1 : k - 1;
          add_bin<CB>(acc, band + (first + t2) * S, bin_weight(lo, t2, rf, yf));
        }
      }
    }
  }
  if (!inside) return;
  float* o = img + (static_cast<size_t>(b0) * n + i) * n + j;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (c < nb) o[static_cast<size_t>(c) * n * n] = acc[c];
  }
}

template <int CB>
void launch(const float* sino, const float* rows, float* img, int batch, int n, int n_angles,
            int n_det, cudaStream_t stream) {
  const dim3 block(kTileJ, kTileI);
  const dim3 grid((n + kTileJ - 1) / kTileJ, (n + kTileI - 1) / kTileI, (batch + CB - 1) / CB);
  joseph_adj_static_kernel<CB><<<grid, block, 0, stream>>>(sino, rows, img, batch, n, n_angles,
                                                           n_det);
}

}  // namespace

extern "C" int joseph_adj_static(const void* sino, const void* rows, void* img, int batch,
                                 int n, int n_angles, int n_det, void* stream) {
  const auto* g = static_cast<const float*>(sino);
  const auto* r = static_cast<const float*>(rows);
  auto* x = static_cast<float*>(img);
  auto s = static_cast<cudaStream_t>(stream);
  switch (batch_chunk(batch)) {
    case 4: launch<4>(g, r, x, batch, n, n_angles, n_det, s); break;
    case 8: launch<8>(g, r, x, batch, n, n_angles, n_det, s); break;
    default: launch<16>(g, r, x, batch, n, n_angles, n_det, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
