// Arithmetic shared by kernel A (grid_encode.cu) and kernel A'
// (grid_encode_backward.cu): a point's position in the unit box, its cell
// and fractions at one level, and each corner's table row and weight.
//
// Both kernels take it from here, so the backward scatters into exactly the
// rows, with exactly the weights, that the forward gathered, and the forward
// stays bit for bit with its plain twin (ops/grid_encode.py
// grid_encode_plain): the same float32 ops in the same order, and the
// library is built with -fmad=false, so x01*scale + 0.5 and every product
// chain is rounded op by op as PyTorch rounds it.
//
// Layout shared by both kernels: blockDim = (points, L); each warp is 32
// consecutive points at one level, so the level and its constants are
// warp-uniform and, at the coarse levels, neighbouring samples of a ray
// read (and add into) the same table rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grid {

constexpr int kMaxLevels = 32;  // blockDim.y = L; 32 * L threads at most 1024

// One level's constants from the wrapper's tables: the fp32 scale, and the
// int32 row [offset, size, stride_0 .. stride_{D-1}] (ops/grid_encode.py
// _level_tables).
template <int D>
struct Level {
  float scale;
  uint32_t offset, size;
  uint32_t stride[D];
};

template <int D>
__device__ __forceinline__ Level<D> load_level(const float* __restrict__ scales,
                                               const int* __restrict__ params, int l) {
  Level<D> lv;
  lv.scale = scales[l];
  const int* p = params + l * (2 + D);
  lv.offset = (uint32_t)p[0];
  lv.size = (uint32_t)p[1];
#pragma unroll
  for (int d = 0; d < D; ++d) lv.stride[d] = (uint32_t)p[2 + d];
  return lv;
}

// x in [-bound, bound]^D -> p in [0, 1]^D; false outside the box, where the
// encoding is exactly zero and so is every gradient.
template <int D>
__device__ __forceinline__ bool unit_position(const float* __restrict__ x, float bound,
                                              float two_bound, float p[D]) {
  bool oob = false;  // the twin's test, NaN included: NaN is not out of the box
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float v = (x[d] + bound) / two_bound;
    oob |= (v < 0.0f) || (v > 1.0f);
    p[d] = v;
  }
  return !oob;
}

// The cell's lower corner and the fractions within it at one level.
template <int D>
__device__ __forceinline__ void cell(const float p[D], float scale, uint32_t pg[D],
                                     float frac[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = p[d] * scale + 0.5f;
    const float fl = floorf(pos);
    frac[d] = pos - fl;
    pg[d] = (uint32_t)fl;
  }
}

// Table row of corner `corner` (bit d set: +1 in dim d): the uint32 index of
// the reference's get_grid_index, wrapped into the level. A level's size is
// either its dense n^D rounded up to 8 (the index never reaches it) or
// 2^log2_hashmap_size, a power of two: both avoid the division.
template <int D>
__device__ __forceinline__ uint32_t corner_row(const Level<D>& lv, const uint32_t pg[D],
                                               int corner) {
  uint32_t idx = 0;  // uint32 wraparound, as the reference index
#pragma unroll
  for (int d = 0; d < D; ++d) idx += (pg[d] + ((corner >> d) & 1u)) * lv.stride[d];
  if (idx >= lv.size) idx = (lv.size & (lv.size - 1)) ? idx % lv.size : idx & (lv.size - 1);
  return idx + lv.offset;
}

// The corner's weight: the product over dims, in dim order, of frac or
// 1 - frac (the twin's order; 1.0f * w is exact).
template <int D>
__device__ __forceinline__ float corner_weight(const float frac[D], int corner) {
  float w = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) w = w * (((corner >> d) & 1u) ? frac[d] : 1.0f - frac[d]);
  return w;
}

// Corners 2q and 2q + 1 differ only in dim 0, whose stride is 1, so their
// rows are r0 and r0 + 1 unless the index wraps at the level's size; with r0
// even the two rows are one aligned 16-byte pair, read (or added) at once.
__device__ __forceinline__ bool pair_aligned(uint32_t r0, uint32_t r1) {
  return r1 == r0 + 1 && (r0 & 1u) == 0;
}

__device__ __forceinline__ void load_pair(const float2* __restrict__ emb, uint32_t r0,
                                          uint32_t r1, float2& e0, float2& e1) {
  if (pair_aligned(r0, r1)) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(emb + r0));
    e0 = make_float2(v.x, v.y);
    e1 = make_float2(v.z, v.w);
  } else {
    e0 = __ldg(emb + r0);
    e1 = __ldg(emb + r1);
  }
}

// d weight / d frac_d: the other dims' factors, signed by the corner's bit
// in dim d.
template <int D>
__device__ __forceinline__ float corner_weight_grad(const float frac[D], int corner, int d) {
  float dw = ((corner >> d) & 1u) ? 1.0f : -1.0f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    if (e == d) continue;
    dw = dw * (((corner >> e) & 1u) ? frac[e] : 1.0f - frac[e]);
  }
  return dw;
}

}  // namespace grid
