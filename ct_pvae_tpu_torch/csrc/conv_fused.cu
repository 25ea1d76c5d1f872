// Fused 3x3 periodic conv + bias + maxout for Hopper (sm_90a): kernel E.
//
// Replaces the TPU kernel `kernel` of scripts/probe_conv_fused.py:97 (its
// pallas_call in `f_pallas`, :113-133).  For an NHWC float32 input x
// (B, H, W, C), an HWIO kernel (3, 3, C, 2F) and a bias (2F,) it computes
//
//   y[b, i, j, o]   = bias[o] + sum_{dy, dx, c} x[b, (i+dy-1) mod H, (j+dx-1) mod W, c]
//                                               * kern[dy, dx, c, o]
//   out[b, i, j, f] = max(y[b, i, j, f], y[b, i, j, f + F])        (B, H, W, F)
//
// which is what the probe's `f_lax`, `f_im2col` and `f_pallas` compute, and
// what the model's stride-1 3x3 ConvBlock computes (periodic pad of 1, VALID
// conv to 2F channels, bias, maxout of the two halves).
//
// Design.  The TPU kernel works on row tiles with a one-row halo that XLA
// cuts out of a wrap-padded copy of x, builds the nine im2col slices in
// VMEM and runs one (R*W, 9C) x (9C, 2F) product on the matrix unit.  Here
// neither the padded copy nor the halo tiles exist: a block owns a tile of
// 8 output rows x 16 output columns of one image and up to 64 output
// channel pairs, and reads the unpadded x with wrapped indices itself.
// Input channels go through shared memory 8 at a time: the tile's 10 x 18
// halo of x and the matching (3, 3, 8, 2, pairs) slice of the kernel.  Each
// thread owns one pair (f, f + F) and one row of 16 output pixels, keeps
// its 32 sums in registers, and accumulates in one fixed order (channel
// chunk, dy, c, dx) with fmaf in float32: no TF32, no tensor cores, as the
// port's precision rule asks.  A warp's threads hold consecutive f, so the
// weight reads from shared memory hit consecutive banks, the x reads are
// broadcasts, and the output stores are coalesced along F.  Then the thread
// adds the bias and writes the max.  Forward only, like the TPU kernel.
//
// Bound.  At the probe's default shape (B 10, H = W = 128, C 40, F 40) the
// work is 2*B*H*W*9*C*2F = 9,437,184,000 flops, 0.141 ms at the 67 TFLOP/s
// float32 peak outside the tensor cores; the bytes are 26.2 MB in, 26.2 MB
// out and 115 KB of weights, 0.016 ms at 3.35 TB/s.  So E is bound by
// arithmetic.  The design spends two shared-memory loads and 32 fmaf per
// weight pair and 18 broadcast loads per (dy, c): its ceiling is the rate
// at which an SM issues fmaf next to those loads.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int;
// returns cudaGetLastError() after the launch.  The caller allocates `out`.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileRows = 8;    // output rows per block (blockDim.y)
constexpr int kTileCols = 16;   // output columns per block, all in one thread
constexpr int kChanChunk = 8;   // input channels staged per pass
constexpr int kMaxPairs = 64;   // output channel pairs per block (blockDim.x)
constexpr int kHaloCols = kTileCols + 2;
constexpr int kXsFloats = (kTileRows + 2) * kChanChunk * kHaloCols;

__global__ void conv_fused_maxout_kernel(const float* __restrict__ x,
                                         const float* __restrict__ kern,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out,
                                         int h, int w, int c_in, int f_out,
                                         int pairs, int pair_blocks) {
  extern __shared__ float smem[];
  float* xs = smem;               // [kTileRows + 2][kChanChunk][kHaloCols]
  float* ws = smem + kXsFloats;   // [9][kChanChunk][2][pairs]

  const int b = blockIdx.z / pair_blocks;
  const int f0 = (blockIdx.z % pair_blocks) * pairs;
  const int i0 = blockIdx.y * kTileRows;
  const int j0 = blockIdx.x * kTileCols;
  const int tf = threadIdx.x;
  const int tr = threadIdx.y;
  const int tid = tr * blockDim.x + tf;
  const int n_threads = blockDim.x * blockDim.y;
  const int f = f0 + tf;
  const int two_f = 2 * f_out;
  const float* xb = x + static_cast<size_t>(b) * h * w * c_in;

  float acc0[kTileCols];
  float acc1[kTileCols];
#pragma unroll
  for (int p = 0; p < kTileCols; ++p) {
    acc0[p] = 0.0f;
    acc1[p] = 0.0f;
  }

  for (int c0 = 0; c0 < c_in; c0 += kChanChunk) {
    // the halo tile of x, channels fastest in the reads (contiguous in NHWC)
    for (int e = tid; e < kXsFloats; e += n_threads) {
      const int c = e % kChanChunk;
      const int col = (e / kChanChunk) % kHaloCols;
      const int r = e / (kChanChunk * kHaloCols);
      const int gi = (i0 + r - 1 + h) % h;
      const int gj = (j0 + col - 1 + w) % w;
      const int gc = c0 + c;
      xs[(r * kChanChunk + c) * kHaloCols + col] =
          gc < c_in ? __ldg(xb + (static_cast<size_t>(gi) * w + gj) * c_in + gc) : 0.0f;
    }
    // the weights of this chunk for the block's pairs, both maxout halves
    const int ws_n = 9 * kChanChunk * 2 * pairs;
    for (int e = tid; e < ws_n; e += n_threads) {
      const int t = e % pairs;
      const int half = (e / pairs) % 2;
      const int c = (e / (2 * pairs)) % kChanChunk;
      const int tap = e / (2 * pairs * kChanChunk);
      const int gc = c0 + c;
      const int gf = f0 + t;
      ws[e] = (gc < c_in && gf < f_out)
                  ? __ldg(kern + (static_cast<size_t>(tap) * c_in + gc) * two_f + half * f_out + gf)
                  : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
      for (int c = 0; c < kChanChunk; ++c) {
        const float* xrow = xs + ((tr + dy) * kChanChunk + c) * kHaloCols;
        float xv[kHaloCols];
#pragma unroll
        for (int q = 0; q < kHaloCols; ++q) xv[q] = xrow[q];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = ws + ((dy * 3 + dx) * kChanChunk + c) * 2 * pairs + tf;
          const float w0 = wp[0];
          const float w1 = wp[pairs];
#pragma unroll
          for (int p = 0; p < kTileCols; ++p) {
            acc0[p] = fmaf(xv[p + dx], w0, acc0[p]);
            acc1[p] = fmaf(xv[p + dx], w1, acc1[p]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int i = i0 + tr;
  if (f >= f_out || i >= h) return;
  const float b0 = __ldg(bias + f);
  const float b1 = __ldg(bias + f_out + f);
  float* orow = out + (static_cast<size_t>(b) * h + i) * w * f_out;
#pragma unroll
  for (int p = 0; p < kTileCols; ++p) {
    const int j = j0 + p;
    if (j < w) {
      const float y0 = acc0[p] + b0;
      const float y1 = acc1[p] + b1;
      // max that propagates NaN from either half, as jnp.maximum / torch.maximum
      orow[static_cast<size_t>(j) * f_out + f] = (y0 > y1 || y0 != y0) ? y0 : y1;
    }
  }
}

}  // namespace

extern "C" int conv_fused_maxout(const void* x, const void* kern, const void* bias,
                                 void* out, int batch, int h, int w, int c_in,
                                 int f_out, void* stream) {
  const int pairs = f_out < kMaxPairs ? f_out : kMaxPairs;
  const int pair_blocks = (f_out + pairs - 1) / pairs;
  const dim3 block(pairs, kTileRows);
  const dim3 grid((w + kTileCols - 1) / kTileCols, (h + kTileRows - 1) / kTileRows,
                  batch * pair_blocks);
  const size_t smem = (kXsFloats + 9 * kChanChunk * 2 * pairs) * sizeof(float);
  conv_fused_maxout_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(kern),
      static_cast<const float*>(bias), static_cast<float*>(out), h, w, c_in, f_out,
      pairs, pair_blocks);
  return static_cast<int>(cudaGetLastError());
}
