// The one expression for the taps of the static-angle Joseph pair, shared by
// kernel C (joseph_fwd_static.cu) and kernel D (joseph_adj_static.cu).
//
// A kernel row is 8 floats (32 bytes, two float4 loads):
//
//   slope_t, slope_r, offset, weight | is_y, inv_slope_t, angle index, 0
//
// the (A, 5) row of `angle_table_fused` followed by 1/slope_t, rounded once
// from float64 when the table is put on the device, and the row's angle
// (`kernel_rows` in ops/joseph_radon.py).  Ray t of row a meets image line r at
//
//   pos = (offset + slope_t * t) + slope_r * r
//
// and its two taps are y0 = floor(pos) and y0 + 1, with the hat weight
// max(0, 1 - |y - pos|).  `joseph_pos` evaluates pos as two explicit fused
// multiply-adds, so that C and D find bitwise the same taps whatever the
// compiler contracts elsewhere: that is what makes <Cx, g> = <x, Dg> hold
// to float rounding.  No kernel may step pos incrementally across lines: it
// would change one kernel's taps and not the other's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kRowFloats = 8;

__device__ __forceinline__ float joseph_pos(float slope_t, float slope_r, float offset,
                                            float t, float r) {
  const float base = __fmaf_rn(slope_t, t, offset);
  return __fmaf_rn(slope_r, r, base);
}

__device__ __forceinline__ float joseph_hat(float y, float pos) {
  return fmaxf(0.0f, 1.0f - fabsf(y - pos));
}

// Staging into shared memory, batch-innermost, moves units of 4 x 4: four
// 16-byte loads (one per image, along the image's memory) transposed in
// registers into four 16-byte stores (one per position, 4 images each).

// Whether a tensor of lines `line` floats long, from `base`, is read in
// 16-byte loads: every line must start on 16 bytes.  A view at another
// storage offset takes the element-by-element loads.
__device__ __forceinline__ bool vec_loads(const float* base, int line) {
  return line % 4 == 0 && reinterpret_cast<std::uintptr_t>(base) % 16 == 0;
}

// Four consecutive floats at p (the first `count` of them exist), or zeros
// for a missing image: one 16-byte load when `vec` (p aligned, all four
// there), else element by element.
__device__ __forceinline__ float4 load4(const float* p, bool image, bool vec, int count) {
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!image) return r;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  if (count > 0) r.x = __ldg(p);
  if (count > 1) r.y = __ldg(p + 1);
  if (count > 2) r.z = __ldg(p + 2);
  if (count > 3) r.w = __ldg(p + 3);
  return r;
}

// d[j * stride] = (px[0][j], px[1][j], px[2][j], px[3][j]) for j = 0..3:
// element j of four images' float4s, as one float4 of the chunk
__device__ __forceinline__ void store_transposed(float4* d, int stride, const float4 (&px)[4]) {
  d[0] = make_float4(px[0].x, px[1].x, px[2].x, px[3].x);
  d[stride] = make_float4(px[0].y, px[1].y, px[2].y, px[3].y);
  d[2 * stride] = make_float4(px[0].z, px[1].z, px[2].z, px[3].z);
  d[3 * stride] = make_float4(px[0].w, px[1].w, px[2].w, px[3].w);
}
