// Static-angle Joseph forward projector for Hopper (sm_90a): kernel C.
//
// Replaces the TPU kernel `_fwd_kernel` (ct_pvae_tpu/ops/pallas_radon.py:124,
// driven per major-axis group by `_run_group` :187 behind `radon_pallas`
// :261).  For a square (B, N, N) float32 image and (A', 8) kernel rows of
// joseph_tap.cuh, grouped by major axis (`forward_rows` in
// ops/joseph_radon.py), it computes
//
//   out[b, a, t] = w_a * sum_r sum_y src[b, r, y] * max(0, 1 - |y - pos_a(r, t)|)
//
// with src the image for an x-major row (is_y 0) and its transpose for a
// y-major row (is_y 1), two taps per line (y0 = floor(pos) and y0 + 1).
//
// Design.  The TPU kernel holds a batch tile of images in VMEM and, per
// angle, builds one (W, T) hat tile per line and applies it to the whole
// batch tile in one matrix product.  The first port (kernel A's entry point
// fed the full table) ran one thread per (b, a, t): it found the same taps
// again for every image, read down a column of the image for the y-major
// half of the angles, and read the whole batch of images again from L2 for
// every angle (180 x 4.3 MB at the init shape).  Here:
//
//  * A block owns 8 or 16 kernel rows of one major axis (the rows come
//    grouped, padded with empty rows), a tile of at most kMaxTile detector
//    bins, a chunk of 4 batch images and one half of the image's lines; a
//    thread owns one bin t and one or two of the rows (two for batches
//    above 4: more angles per staged slab; one below: more blocks), and keeps
//    each ray's sums for the 4 images in a float4.  Two blocks split each
//    ray's lines and add their halves into the zeroed output with
//    atomicAdd: two terms added to zero give the same sum in either order,
//    so the result stays deterministic.
//  * The block walks its lines in slabs of up to 32 lines (at most 96 KB of
//    shared memory).  It stages each slab once, batch-innermost, from the
//    image for x-major rows or from its transpose for y-major rows: the
//    transposition happens in the staging (16-byte loads, 4 pixels of 4
//    images per thread, transposed in registers), so no transposed copy is
//    made; all the block's rays read the slab, so it is read from L2 once
//    per 8 or 16 angles and detector tile.
//  * For each line a ray finds its two taps once (`joseph_pos`, floor, two
//    hats) and applies each to the 4 images: one float4 load from shared
//    memory and 4 fmaf.  A warp's 32 neighbouring rays read neighbouring
//    float4s of one staged line, for either major axis.  Each staged line
//    sits between zeros, so a tap off the image reads 0 and adds exactly
//    nothing, and the loop has no branch.
//
// Exact float32 fmaf on the CUDA cores (no TF32, no tensor cores), one fixed
// order per half ray (line, then tap y0, then y0 + 1, as the plain version).
//
// Bound.  At the init stack's shape ((32, 184, 184) x 180 angles -> 184
// detector bins) the in-range taps need 663,503,360 flops, 0.0099 ms at 67
// TFLOP/s, and 8.6 MB of traffic, 0.0026 ms at 3.35 TB/s: bound by
// operations on paper.  Here every tap of every image is a float read from
// shared memory for one fmaf, so the kernel is bound by shared-memory
// bandwidth (128 bytes a clock per SM: about 0.06 ms for the two taps per
// ray and line at that shape) and by the issue slots of the tap search.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launch.  The caller allocates `out`
// and fills it with zeros.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

#include "joseph_tap.cuh"

namespace {

constexpr int kChunk = 4;               // batch images per block: one float4
constexpr int kRowsY = 8;               // threadIdx.y
constexpr int kMaxTile = 128;           // detector bins per block: threadIdx.x
constexpr int kMaxSlabRows = 32;
constexpr int kSlabBytes = 96 * 1024;   // dynamic shared memory for a slab
constexpr int kUnits = 2;               // staging units a thread keeps in flight
constexpr int kRowParts = 2;            // blocks that split a ray's lines

// float4s per staged line: the line at [2, n + 2) between two zero float4s
// on each side, so that taps off the image read zeros, and an odd count, so
// that neighbouring lines' stores in the transposed staging hit different
// bank groups
__host__ __device__ inline int line_stride(int n) { return (n + 4) | 1; }

// A slab is staged in units of 4 pixels x 4 images, loaded along the
// images' rows (x-major rows: line rr is image row r0 + rr; unit u = (rr,
// pixels y .. y+3)) or columns (y-major rows: line rr is image column r0 +
// rr; unit u = (pixel y, lines rr .. rr+3)) and stored transposed, one
// float4 of 4 images per pixel.  Lines come in fours, so with n % 4 == 0 a
// unit is whole, and aligned when the image is (`vec_loads`).
struct SlabUnits {
  const float* src;  // image b0 of the chunk
  size_t plane;
  int n, nb, r0, lines, quads, count;
  bool vec, is_y;

  __device__ SlabUnits(const float* src, size_t plane, int n, int nb, bool vec, bool is_y, int r0,
                       int lines)
      : src(src), plane(plane), n(n), nb(nb), r0(r0), lines(lines), quads((n + 3) / 4),
        count(is_y ? n * ((lines + 3) / 4) : lines * ((n + 3) / 4)), vec(vec), is_y(is_y) {}

  __device__ __forceinline__ void load(int u, float4 (&px)[4]) const {
    const int y = is_y ? u % n : 4 * (u % quads);
    const int rr = is_y ? 4 * (u / n) : u / quads;
    const float* p = is_y ? src + y * n + r0 + rr : src + (r0 + rr) * n + y;
    const int avail = is_y ? lines - rr : n - y;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) px[k] = load4(p + k * plane, u < count && k < nb, vec, avail);
  }

  __device__ __forceinline__ void store(int u, float4* slab, int len, const float4 (&px)[4]) const {
    if (u >= count) return;
    if (is_y) {
      store_transposed(slab + 4 * (u / n) * len + u % n + 2, len, px);
    } else {
      store_transposed(slab + (u / quads) * len + 4 * (u % quads) + 2, 1, px);
    }
  }

  // The whole slab: each thread's first kUnits units with all their loads
  // in flight at once, then any others one by one.
  __device__ __forceinline__ void stage(float4* slab, int len, int tid, int threads) const {
    float4 px[kUnits][4];
#pragma unroll
    for (int m = 0; m < kUnits; ++m) load(tid + m * threads, px[m]);
#pragma unroll
    for (int m = 0; m < kUnits; ++m) store(tid + m * threads, slab, len, px[m]);
    for (int u = tid + kUnits * threads; u < count; u += threads) {
      load(u, px[0]);
      store(u, slab, len, px[0]);
    }
  }
};

// kRays rays (kernel rows) per thread: 2 for batches above 4, so that a
// slab serves 16 angles; 1 for the rest, for more blocks.
template <int kRays>
__global__ void __launch_bounds__(kRowsY * kMaxTile) joseph_fwd_static_kernel(
    const float* __restrict__ img, const float* __restrict__ rows, float* __restrict__ out,
    int batch, int n, int n_angles, int n_det, int slab_rows) {
  constexpr int kAngles = kRays * kRowsY;  // kernel rows per block
  extern __shared__ float4 slab[];  // [line][pixel + 2], a float4 of 4 images each
  __shared__ float4 tab[2 * kAngles];

  const int threads = blockDim.x * kRowsY;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.z / kRowParts * kChunk;
  const int nb = min(kChunk, batch - b0);
  // this block's lines: the first or the second half (a multiple of 4)
  const int half = (n / kRowParts + 3) / 4 * 4;
  const int row_begin = blockIdx.z % kRowParts * half;
  const int row_end = min(n, row_begin + half);
  const int len = line_stride(n);
  const size_t plane = static_cast<size_t>(n) * n;
  const float* src = img + b0 * plane;
  const bool vec = vec_loads(img, n);

  if (tid < 2 * kAngles) {
    tab[tid] = __ldg(reinterpret_cast<const float4*>(rows + kRowFloats * blockIdx.y * kAngles) + tid);
  }
  for (int k = tid; k < slab_rows * 4; k += threads) {  // the zeros around each line
    const int col = k % 4;
    slab[(k / 4) * len + (col < 2 ? col : n + col)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const bool is_y = tab[1].x > 0.5f;  // the block's rows share one major axis
  const float tf = static_cast<float>(t);
  float4 lo[kRays], acc[kRays];  // the thread's rows: threadIdx.y + kRowsY * m
#pragma unroll
  for (int m = 0; m < kRays; ++m) {
    lo[m] = tab[2 * (threadIdx.y + kRowsY * m)];  // slope_t, slope_r, offset, weight
    acc[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int r0 = row_begin; r0 < row_end; r0 += slab_rows) {
    const int lines = min(slab_rows, row_end - r0);
    __syncthreads();  // every thread is done with the previous slab
    SlabUnits(src, plane, n, nb, vec, is_y, r0, lines).stage(slab, len, tid, threads);
    __syncthreads();
    if (t >= n_det) continue;
    for (int rr = 0; rr < lines; ++rr) {
#pragma unroll
      for (int m = 0; m < kRays; ++m) {
        const float pos = joseph_pos(lo[m].x, lo[m].y, lo[m].z, tf, static_cast<float>(r0 + rr));
        const float y0f = floorf(pos);
        // taps off the image read the zeros: no branch
        const int y0 = min(max(static_cast<int>(y0f), -2), n);
        const float h0 = joseph_hat(y0f, pos);
        const float h1 = joseph_hat(y0f + 1.0f, pos);
        const float4 a = slab[rr * len + y0 + 2];
        const float4 b = slab[rr * len + y0 + 3];
        acc[m].x = fmaf(b.x, h1, fmaf(a.x, h0, acc[m].x));
        acc[m].y = fmaf(b.y, h1, fmaf(a.y, h0, acc[m].y));
        acc[m].z = fmaf(b.z, h1, fmaf(a.z, h0, acc[m].z));
        acc[m].w = fmaf(b.w, h1, fmaf(a.w, h0, acc[m].w));
      }
    }
  }
  if (t >= n_det) return;
  const size_t image = static_cast<size_t>(n_angles) * n_det;
#pragma unroll
  for (int m = 0; m < kRays; ++m) {
    const int q = threadIdx.y + kRowsY * m;
    const int a = static_cast<int>(tab[2 * q + 1].z);  // the row's angle; -1: an empty row
    if (a < 0) continue;
    float* o = out + (static_cast<size_t>(b0) * n_angles + a) * n_det + t;
    const float sums[kChunk] = {acc[m].x, acc[m].y, acc[m].z, acc[m].w};
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < nb) atomicAdd(o + k * image, sums[k] * lo[m].w);
    }
  }
}

// Lets the kernel take a kSlabBytes slab on the current device.  The
// attribute belongs to the device, so it is set once per device (a bit each
// for devices 0-63; others set it on every launch).
template <int kRays>
cudaError_t allow_slab() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(joseph_fwd_static_kernel<kRays>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int kRays>
int launch(const float* img, const float* rows, float* out, int batch, int n, int n_rows,
           int n_angles, int n_det, cudaStream_t stream) {
  constexpr int kAngles = kRays * kRowsY;
  const cudaError_t attr = allow_slab<kRays>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (n_det + kMaxTile - 1) / kMaxTile;
  const dim3 block(((n_det + tiles - 1) / tiles + 31) / 32 * 32, kRowsY);
  const int line_bytes = line_stride(n) * static_cast<int>(sizeof(float4));
  const int slab_rows = std::min(kMaxSlabRows, kSlabBytes / line_bytes) / 4 * 4;  // in fours
  if (slab_rows < 4 || n_rows % kAngles) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, n_rows / kAngles, (batch + kChunk - 1) / kChunk * kRowParts);
  joseph_fwd_static_kernel<kRays><<<grid, block, slab_rows * line_bytes, stream>>>(
      img, rows, out, batch, n, n_angles, n_det, slab_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows` holds n_rows kernel rows, a multiple of 16; their angle indices are
// < n_angles, the output's angle count.  `out` must hold zeros: the two
// halves of each ray's lines add into it.
extern "C" int joseph_fwd_static(const void* img, const void* rows, void* out, int batch, int n,
                                 int n_rows, int n_angles, int n_det, void* stream) {
  const auto* x = static_cast<const float*>(img);
  const auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch <= 4) return launch<1>(x, r, o, batch, n, n_rows, n_angles, n_det, s);
  return launch<2>(x, r, o, batch, n, n_rows, n_angles, n_det, s);
}
