// Fused 3x3 periodic conv + bias + maxout on Hopper's tensor cores (sm_90a):
// kernel E, second design.
//
// Replaces the TPU kernel `kernel` of scripts/probe_conv_fused.py:97 (its
// pallas_call in `f_pallas`, :113-133), as csrc/conv_fused.cu did before it
// (that first design stays built as a yardstick).  For an NHWC float32
// input x (B, H, W, C), an HWIO kernel (3, 3, C, 2F) and a bias (2F,):
//
//   y[b, i, j, o]   = bias[o] + sum_{dy, dx, c} x[b, (i+dy-1) mod H, (j+dx-1) mod W, c]
//                                               * kern[dy, dx, c, o]
//   out[b, i, j, f] = max(y[b, i, j, f], y[b, i, j, f + F])        (B, H, W, F)
//
// Bounds.  At the probe's shape (B 10, H = W = 128, C 40, F 40) the work is
// 2*B*H*W*9*C*2F = 9,437,184,000 flops and the bytes 52.5 MB: 0.14085 ms at
// the 67 TFLOP/s float32 peak outside the tensor cores, 0.0157 ms at 3.35
// TB/s.  On the TF32 tensor cores (495 TFLOP/s dense) three products per
// multiply-add (below) take 0.0572 ms: the ceiling of this design.
//
// Design: an implicit GEMM that is never materialised, M = B*H*W pixels,
// N = the output channels of both maxout halves, K = 9 taps x C channels.
//  * Precision.  Each operand v is split into big = tf32(v) and small =
//    tf32(v - big) (cvt.rna), and every k-step accumulates small_a*big_b,
//    big_a*small_b, then big_a*big_b into float32 registers with
//    mma.sync.m16n8k8 (TF32 in, f32 accumulate): about 2^-21 relative per
//    product, float32's own order of error.  Single TF32 would be 1e-3.
//    mma.sync, not wgmma: the taps shift the A operand by arbitrary
//    shared-memory offsets, which fragments read as plain loads take easily.
//  * Tiles.  A block owns 16 x 16 output pixels of one image at a time and
//    a group of 40 channel pairs (80 columns: pairs f0..f0+39 of the first
//    half, then the same pairs of the second).  Its 8 multiplying warps own
//    two tile rows each (warp w rows 2w and 2w + 1, one m-tile of 16 pixels
//    a row) against all 10 n-tiles: pair f0 + 8n + c sits in n-tile n and
//    its partner in n-tile n + 5, at the same register of the same lane, so
//    the maxout is a register max (NaN-propagating, as conv_fused.cu).  F is
//    padded to groups of 40 with zero weights; padded pairs are computed
//    and never stored.
//  * K order.  Channels go in chunks of 8 (zero-padded past C); for each
//    chunk the nine taps, each one k-step of 8 channels.  Within a k-step
//    lane t takes channels 2t and 2t+1 as its k = t and k = t + 4 (the same
//    permutation for A and B).
//  * Operands in shared memory as fragments, split once.  split_weights_kernel
//    splits the weights once a call into a workspace laid out as B
//    fragments: lane (g, t) of an n-tile finds (big 2t, big 2t+1, small 2t,
//    small 2t+1) of its column in 16 bytes.  The halo is split once a stage
//    into A fragments: (column q, column q + 8) x (channel 2t, 2t + 1), big
//    and small apart, 16 bytes each (columns 8 and 9 sit in two such
//    quads).  So each fragment is one 16-byte load straight into the
//    registers mma.sync reads, on 32 distinct banks per quarter-warp.
//    Split in registers per warp and tap, or loaded in another order, the
//    operands cost as many instructions (moves into register quads) as the
//    products themselves.
//  * Stagers.  4 more warps copy and split: in their pass s they copy stage
//    s (one tile's 18 x 18 halo for one chunk of 8 channels by cp.async,
//    and that chunk's split weights, 46,080 B from L2), wait for their
//    copies, and split the halo, while the multiplying warps work on stage
//    s - 1 from the other slot; one block barrier a stage hands over.  Done
//    by the multiplying warps themselves, the copies and splits wait behind
//    the products in each warp's in-order stream while the tensor cores
//    idle, and the stages do not overlap.  A halo index in [-1, H]
//    wraps by compare-and-select (no integer division); rows or columns
//    past H (tiles hanging over the image's edge) fill with zeros, since no
//    stored output reads them.  16-byte copies where C % 4 == 0 and x
//    starts on 16 bytes, else 4-byte copies; channels past C fill with
//    zeros (cp.async's source size 0).  Any C fits: the weights are copied
//    a chunk at a time.
//  * Epilogue.  At an item's end the multiplying warps add the bias, take
//    the max and leave the 16 x 16 x 40 outputs in shared memory; the
//    stagers store them with 16-byte stores during the next stages.
//  * Persistent blocks: one block of 12 warps per SM (189,568 B of shared
//    memory, at most 168 registers a thread) walks over the (image, row
//    tile, column tile) items of its pair group.
// Forward only, like the TPU kernel.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launches (or the error of a failed
// device query).  The caller allocates `out` and the workspace `work`
// (conv_fused_mma_work_floats floats).

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 16;                         // output rows and columns per item
constexpr int kHalo = kTile + 2;
constexpr int kQuads = kHalo - 8;                 // column pairs (q, q + 8) an m-tile reads
constexpr int kWarps = 8;                         // multiplying warps; w: tile rows 2w, 2w + 1
constexpr int kStagers = 4;                       // warps that copy and split the stages
constexpr int kStagerThreads = 32 * kStagers;
constexpr int kThreads = 32 * (kWarps + kStagers);
constexpr int kChunk = 8;                         // channels per stage (one k-step a tap)
constexpr int kHalfTiles = 5;                     // n-tiles per maxout half
constexpr int kPairs = 8 * kHalfTiles;            // channel pairs per block
constexpr int kCols = 2 * kPairs;                 // both halves
constexpr int kXRaw = kHalo * kHalo * kChunk;     // floats of one halo chunk as copied
constexpr int kXSplit = kHalo * 2 * kQuads * 16;  // the same as A fragments, big and small
constexpr int kWSplit = 9 * kCols * 16;           // one chunk's weights as B fragments
constexpr int kOut = kTile * kTile * kPairs;      // one item's outputs, [row][column][pair]
constexpr int kSmemFloats = kXRaw + 2 * kXSplit + 2 * kWSplit + kOut;

struct Params {
  const float* x;
  const float* wsplit;  // split_weights_kernel's output
  const float* bias;
  float* out;
  int h, w, c, f;
  int chunks;       // ceil(c / kChunk)
  int tiles_w;      // column tiles of an image
  int tiles_img;    // tiles of an image
  int items;        // batch * tiles_img
  int vec;          // 16-byte copies of x
  int vec_out;      // 16-byte stores of out: F % 4 == 0, out on 16 bytes
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; when !ok nothing is read and dst gets zeros
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::); }

// v = big + small in TF32, each rounded to nearest, ties away from zero
__device__ __forceinline__ float2 split(float v) {
  uint32_t big, small;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(v - __uint_as_float(big)));
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}

// d += a * b on one 16x8x8 TF32 tile
__device__ __forceinline__ void mma(float4& d, const float4& a, const float2& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(__float_as_uint(b.x)), "r"(__float_as_uint(b.y)));
}

// The weights of every pair group and channel chunk as B fragments, laid
// out [group][chunk][tap][column][t][4]: lane (g, t) of n-tile n reads
// column 8n + g as (big 2t, big 2t+1, small 2t, small 2t+1), channels 2t
// and 2t + 1 being its k = t and k = t + 4.  Column n < kPairs is pair
// f0 + n, n >= kPairs its partner; zeros past C and past F.  One thread a
// (column, channel).
__global__ void split_weights_kernel(const float* __restrict__ kern, float* __restrict__ wsplit,
                                     int c_in, int f_out, int chunks, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int cc = e % kChunk;
  const int n = (e / kChunk) % kCols;
  const int tap = (e / (kChunk * kCols)) % 9;
  const int q = (e / (kChunk * kCols * 9)) % chunks;
  const int group = e / (kChunk * kCols * 9 * chunks);
  const int c = q * kChunk + cc;
  const int pair = group * kPairs + (n < kPairs ? n : n - kPairs);
  const int o = n < kPairs ? pair : f_out + pair;
  const float v = c < c_in && pair < f_out
                      ? __ldg(kern + (static_cast<size_t>(tap) * c_in + c) * 2 * f_out + o)
                      : 0.0f;
  const float2 bs = split(v);
  float* frag = wsplit + (e - cc) * 2 + (cc >> 1) * 4 + (cc & 1);
  frag[0] = bs.x;
  frag[2] = bs.y;
}

// A halo index v in [-1, n + kTile] of a periodic axis of length n: wrapped
// for v in [-1, n], -1 (fill with zeros) past n
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? n - 1 : (v < n ? v : (v == n ? 0 : -1));
}

struct Tile {
  int b, i0, j0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int stage) {
  const int item = blockIdx.x + (stage / p.chunks) * gridDim.x;
  const int b = item / p.tiles_img;
  const int r = item - b * p.tiles_img;
  const int ti = r / p.tiles_w;
  return {b, ti * kTile, (r - ti * p.tiles_w) * kTile};
}

// Start the copies of stage s's halo, its tile for its channel chunk, into
// xraw as [row][column][8 channels]; st is the stager thread's index
__device__ void copy_halo(const Params& p, int s, int st, float* xraw) {
  const Tile t = tile_of(p, s);
  const int c0 = (s % p.chunks) * kChunk;
  const float* xb = p.x + static_cast<size_t>(t.b) * p.h * p.w * p.c;
  if (p.vec) {
    for (int e = st; e < kXRaw / 4; e += kStagerThreads) {
      const int px = e >> 1;
      const int hr = px / kHalo;
      const int gi = wrap(t.i0 + hr - 1, p.h);
      const int gj = wrap(t.j0 + px - hr * kHalo - 1, p.w);
      const int c = c0 + 4 * (e & 1);
      const bool ok = gi >= 0 && gj >= 0 && c < p.c;  // C % 4 == 0: all four or none
      copy16(xraw + 4 * e, ok ? xb + (static_cast<size_t>(gi) * p.w + gj) * p.c + c : p.x, ok);
    }
  } else {
    for (int e = st; e < kXRaw; e += kStagerThreads) {
      const int px = e >> 3;
      const int hr = px / kHalo;
      const int gi = wrap(t.i0 + hr - 1, p.h);
      const int gj = wrap(t.j0 + px - hr * kHalo - 1, p.w);
      const int c = c0 + (e & 7);
      const bool ok = gi >= 0 && gj >= 0 && c < p.c;
      copy4(xraw + e, ok ? xb + (static_cast<size_t>(gi) * p.w + gj) * p.c + c : p.x, ok);
    }
  }
}

// Start the copies of stage s's chunk of split weights into ws
__device__ void copy_weights(const Params& p, int s, int st, float* ws) {
  const float* src = p.wsplit + (static_cast<size_t>(blockIdx.y) * p.chunks + s % p.chunks) * kWSplit;
  for (int e = st; e < kWSplit / 4; e += kStagerThreads) copy16(ws + 4 * e, src + 4 * e, true);
}

// The landed halo as A fragments, [row][big | small][q][t][4]: lane (g, t)
// reading halo columns q = g + dx and q + 8 (m-tile rows g and g + 8) finds
// (column q, column q + 8) x (channel 2t, channel 2t + 1) there.  Columns
// 8 and 9 are in two quads.
__device__ void split_halo(const float* xraw, int st, float* xs) {
  for (int e = st; e < kHalo * kQuads * 4; e += kStagerThreads) {
    const int t = e & 3;
    const int q = (e >> 2) % kQuads;
    const int r = (e >> 2) / kQuads;
    const float2 lo = *reinterpret_cast<const float2*>(xraw + (r * kHalo + q) * kChunk + 2 * t);
    const float2 hi = *reinterpret_cast<const float2*>(xraw + (r * kHalo + q + 8) * kChunk + 2 * t);
    const float2 s0 = split(lo.x), s1 = split(hi.x), s2 = split(lo.y), s3 = split(hi.y);
    float* quad = xs + ((r * 2 * kQuads + q) * 4 + t) * 4;
    *reinterpret_cast<float4*>(quad) = make_float4(s0.x, s1.x, s2.x, s3.x);
    *reinterpret_cast<float4*>(quad + kQuads * 16) = make_float4(s0.y, s1.y, s2.y, s3.y);
  }
}

// Named barriers: kAll for the whole block, kStagersOnly for the stagers,
// kTileFree from the stagers to the multiplying warps
constexpr int kAll = 1;
constexpr int kStagersOnly = 2;
constexpr int kTileFree = 3;

__device__ __forceinline__ void barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// acc += the nine taps of one channel chunk: 9 k-steps of 2 x 10 tiles, three
// TF32 products each.  Every fragment is one 16-byte load in the register
// order mma.sync takes, so nothing is moved between the loads and the mma.
__device__ __forceinline__ void multiply_chunk(const float* xs, const float* ws, int warp, int g,
                                               int t, float4 (&acc)[2][2 * kHalfTiles]) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    float4 a_big[2], a_small[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* a = xs + (((2 * warp + mt + dy) * 2 * kQuads + g + dx) * 4 + t) * 4;
      a_big[mt] = *reinterpret_cast<const float4*>(a);
      a_small[mt] = *reinterpret_cast<const float4*>(a + kQuads * 16);
    }
    float4 b[2 * kHalfTiles];  // (big k t, big k t + 4, small k t, small k t + 4)
#pragma unroll
    for (int nt = 0; nt < 2 * kHalfTiles; ++nt) {
      b[nt] = *reinterpret_cast<const float4*>(ws + ((tap * kCols + nt * 8 + g) * 4 + t) * 4);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * kHalfTiles; ++nt)
        mma(acc[mt][nt], a_small[mt], make_float2(b[nt].x, b[nt].y));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * kHalfTiles; ++nt)
        mma(acc[mt][nt], a_big[mt], make_float2(b[nt].z, b[nt].w));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * kHalfTiles; ++nt)
        mma(acc[mt][nt], a_big[mt], make_float2(b[nt].x, b[nt].y));
  }
}

// Bias and maxout of one item's sums into the output tile os, then zero
// the sums.  Registers (x, y) of n-tile n hold pixel g, (z, w) pixel g + 8,
// each for pairs f0 + 8n + 2t and f0 + 8n + 2t + 1.
__device__ __forceinline__ void finish_item(const Params& p, int f0, int warp, int g, int t,
                                            float4 (&acc)[2][2 * kHalfTiles], float* os) {
  // max that propagates NaN from either half, as jnp.maximum / torch.maximum
  const auto maxout = [](float v0, float v1) { return (v0 > v1 || v0 != v0) ? v0 : v1; };
#pragma unroll
  for (int nt = 0; nt < kHalfTiles; ++nt) {
    const int pair = f0 + nt * 8 + 2 * t;
    const float b0 = pair < p.f ? __ldg(p.bias + pair) : 0.0f;
    const float b1 = pair + 1 < p.f ? __ldg(p.bias + pair + 1) : 0.0f;
    const float c0 = pair < p.f ? __ldg(p.bias + p.f + pair) : 0.0f;
    const float c1 = pair + 1 < p.f ? __ldg(p.bias + p.f + pair + 1) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float4 y = acc[mt][nt];
      const float4 z = acc[mt][nt + kHalfTiles];
      float* o = os + ((2 * warp + mt) * kTile + g) * kPairs + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(maxout(y.x + b0, z.x + c0), maxout(y.y + b1, z.y + c1));
      *reinterpret_cast<float2*>(o + 8 * kPairs) =
          make_float2(maxout(y.z + b0, z.z + c0), maxout(y.w + b1, z.w + c1));
      acc[mt][nt] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[mt][nt + kHalfTiles] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The stagers' store of an output tile to out: 16 bytes at a time where F
// and out allow it; pixels past H or W and pairs past F are not stored.
__device__ void store_tile(const Params& p, const Tile& tile, int f0, int st, const float* os) {
  const int width = p.vec_out ? 4 : 1;
  for (int e = st; e < kOut / width; e += kStagerThreads) {
    const int k = e * width % kPairs;
    const int px = e * width / kPairs;
    const int i = tile.i0 + px / kTile;
    const int j = tile.j0 + px % kTile;
    if (i >= p.h || j >= p.w || f0 + k >= p.f) continue;
    float* o = p.out + ((static_cast<size_t>(tile.b) * p.h + i) * p.w + j) * p.f + f0 + k;
    if (p.vec_out) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(os + e * 4);
    } else {
      *o = os[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) conv_fused_mma_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xraw = smem;                      // [kXRaw]: the stagers' halo in flight
  float* xsplit = xraw + kXRaw;            // [2][kXSplit]
  float* wsplit = xsplit + 2 * kXSplit;    // [2][kWSplit]
  float* os = wsplit + 2 * kWSplit;        // [kOut]: the last item's outputs
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * kPairs;
  const int stages = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x * p.chunks;

  // Stage s lives in slot s & 1.  In their pass s the stagers fill stage s
  // while the multiplying warps work on stage s - 1; block barrier s ends
  // both (so the slot of stage s - 1 is free for stage s + 1).  At the end
  // of an item's last stage the multiplying warps leave its outputs in os;
  // the stagers store them two passes later (after the barrier that ends
  // that stage), and the multiplying warps wait on kTileFree for that
  // before they fill os again.
  if (warp >= kWarps) {
    const int st = threadIdx.x - 32 * kWarps;
    for (int s = 0; s <= stages + 1; ++s) {
      if (s < stages) {
        copy_halo(p, s, st, xraw);
        copy_weights(p, s, st, wsplit + (s & 1) * kWSplit);
        commit();
      }
      if (s >= 2 && (s - 2) % p.chunks == p.chunks - 1) {  // stage s - 2 ended an item
        store_tile(p, tile_of(p, s - 2), f0, st, os);
        if (s - 2 < stages - 1) barrier_arrive(kTileFree, kThreads);  // not the last item
      }
      if (s < stages) {
        wait_copies();
        barrier(kStagersOnly, kStagerThreads);  // every stager's copies have landed
        split_halo(xraw, st, xsplit + (s & 1) * kXSplit);
      }
      if (s <= stages) barrier(kAll, kThreads);
    }
    return;
  }

  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  float4 acc[2][2 * kHalfTiles];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * kHalfTiles; ++nt) acc[mt][nt] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  barrier(kAll, kThreads);
  for (int s = 0; s < stages; ++s) {
    multiply_chunk(xsplit + (s & 1) * kXSplit, wsplit + (s & 1) * kWSplit, warp, g, t, acc);
    if (s % p.chunks == p.chunks - 1) {
      if (s >= p.chunks) barrier(kTileFree, kThreads);  // the stagers have stored the last item
      finish_item(p, f0, warp, g, t, acc, os);
    }
    barrier(kAll, kThreads);
  }
}

// The SM count of the current device (0-63 cached), with the kernel's
// shared-memory attribute set for it.
cudaError_t device_sms(int* sms) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev].load() > 0) {
    *sms = cached[dev].load();
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_fused_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemFloats * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return err;
  if (dev < 64) cached[dev].store(*sms);
  return cudaSuccess;
}

}  // namespace

// Floats of the workspace that the caller passes as `work`.
extern "C" long long conv_fused_mma_work_floats(int c_in, int f_out) {
  const long long groups = (f_out + kPairs - 1) / kPairs;
  return groups * ((c_in + kChunk - 1) / kChunk) * kWSplit;
}

extern "C" int conv_fused_mma(const void* x, const void* kern, const void* bias, void* out,
                              void* work, int batch, int h, int w, int c_in, int f_out,
                              void* stream) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int groups = (f_out + kPairs - 1) / kPairs;
  Params p;
  p.x = static_cast<const float*>(x);
  p.wsplit = static_cast<const float*>(work);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.w = w;
  p.c = c_in;
  p.f = f_out;
  p.chunks = (c_in + kChunk - 1) / kChunk;
  p.tiles_w = (w + kTile - 1) / kTile;
  p.tiles_img = (h + kTile - 1) / kTile * p.tiles_w;
  p.items = batch * p.tiles_img;
  p.vec = c_in % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  p.vec_out = f_out % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int total = static_cast<int>(conv_fused_mma_work_floats(c_in, f_out) / 2);
  split_weights_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(kern), static_cast<float*>(work), c_in, f_out, p.chunks, total);
  int blocks = sms / groups > 1 ? sms / groups : 1;
  if (blocks > p.items) blocks = p.items;
  conv_fused_mma_kernel<<<dim3(blocks, groups), kThreads, kSmemFloats * sizeof(float), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
