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
//
// Float32 tables take every grid the JAX package does
// (radnerf_tpu/ops/grid_encode.py _corner_index :142, grid_encode01 :168):
// at D in {2, 3}, at most kMaxLevels levels and kMaxChannels channels (every
// grid RAD-NeRF and its -O recipe build), C in {1, 2, 4, 8} channels as a
// template argument, so a row is one 4- to 16-byte load (two at C = 8),
// and any other C as a run-time argument, a row then read in units of the
// widest load that divides it (unit_floats); hashed levels (:160); per call
// the shift (0.5, or 0 under align_corners, :190) and smoothstep (:194).
// Every other grid -- any D from 1 (D up to 7 on a hashed level: the hash
// has seven primes, as JAX's _PRIMES), any level count, any channel count
// -- runs the general path (general_shape, the *_general kernels): D, L and
// C at run time, the cell's corners and fractions in shared memory, the
// channels in chunks of kChunk, 64-bit element offsets. A level's row is
// [offset, size, stride_0 .. stride_{D-1}]; a hashed level uses no stride,
// so its row carries stride 0 in dim 0, where a dense level's is always 1,
// and that is its hash flag.
//
// The bf16 policy of -O (radnerf_tpu/ops/grid_encode.py
// build_packed_table(dtype=bfloat16) + grid_encode01_packed :395-400)
// takes the same C, shift and smoothstep on tiled grids (a hash grid has
// no packed rows). A bf16 row of C channels is C/2 32-bit words (channel
// 2j in the low half of word j); values are widened to float exactly (a
// bf16 is the high half of a float32) and each corner weight, computed in
// float32, is rounded to bf16. The bf16 forward (grid_encode.cu, on
// corner-packed rows) forms its corner terms with bf16_terms below where C
// is even, and as scalar products round_bf16(bf16(w) * e) where it is odd:
// each weight x value product rounded to bf16, the products summed in
// float32 and the sum rounded to bf16 once: where XLA rounds when JAX runs
// the lerp op by op (ops/grid_encode.py _grid_encode_plain_bf16 is the
// twin).
//
// What bounds the -O kernels on an H100 80GB HBM3 (700 W; PERF.md §6):
// A-bf16 was bound by its scattered corner gathers, not by bytes or its
// bf16 arithmetic, so it reads corner-packed rows (grid_encode.cu);
// A'-bf16 by the global reductions it issues, so it issues one float4 a
// corner pair into pair keys (grid_encode_backward.cu). Float32 A and A'
// keep the row layout and add rows (and aligned row pairs) as vector
// reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace grid {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 tables: a row is two bf16s in one 32-bit word (channel 0 in the low
// half, as they lie in memory), and so are the output and grad_out
// elements of a (point, level)
struct Bf16 {
  __device__ static float2 widen(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
  __device__ static float2 load(const uint32_t* __restrict__ p) { return widen(__ldg(p)); }
  __device__ static void load2(const uint32_t* __restrict__ p, float2& e0, float2& e1) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    e0 = widen(v.x);
    e1 = widen(v.y);
  }
  __device__ static uint32_t store(float2 v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  }
};

// The most levels and channels the specialised kernels take, set by the
// build from ops/_kernels.py (GRID_MAX_LEVELS, GRID_MAX_CHANNELS). A block
// of theirs is 32 points x L levels; a grid past them runs the general path.
#if !defined(GRID_MAX_LEVELS) || !defined(GRID_MAX_CHANNELS)
#error "build with ops/_kernels.py NVCC_FLAGS (-DGRID_MAX_LEVELS, -DGRID_MAX_CHANNELS)"
#endif
constexpr int kMaxLevels = GRID_MAX_LEVELS;
constexpr int kMaxChannels = GRID_MAX_CHANNELS;
static_assert(32 * kMaxLevels <= 1024, "a block of 32 points x L levels");

// True unless D, L and C describe a grid; every entry point refuses such a
// call with cudaErrorInvalidValue.
inline bool bad_shape(int D, int L, int C) { return D < 1 || L < 1 || C < 1; }

// True where the specialised kernels do not take the grid (D outside
// {2, 3}, more than kMaxLevels levels or kMaxChannels channels): the
// general path runs it.
inline bool general_shape(int D, int L, int C) {
  return (D != 2 && D != 3) || L > kMaxLevels || C > kMaxChannels;
}

// The widest unit of at most 16 bytes (in floats: 4, 2 or 1) that divides a
// float32 row of C channels, for the run-time-C kernels.
__host__ __device__ constexpr int unit_floats(int C) {
  return C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
}

// W float32 values at p (aligned to 4W bytes) as one load.
template <int W>
__device__ __forceinline__ void load_unit(const float* __restrict__ p, float e[W]) {
  if constexpr (W == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    e[0] = v.x;
    e[1] = v.y;
  } else {
    e[0] = __ldg(p);
  }
}

// bf16 <-> its 16 bits: widened exactly, rounded to nearest even.
__device__ __forceinline__ float bf16_bits_float(uint32_t b) { return __uint_as_float(b << 16); }
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The C bf16 values of a (point, level) output element: one 2-, 4-, 8- or
// 16-byte store at C = 1, 2, 4, 8.
template <int C> struct Bf16Elem;
template <> struct Bf16Elem<1> { using T = unsigned short; };
template <> struct Bf16Elem<2> { using T = uint32_t; };
template <> struct Bf16Elem<4> { using T = uint2; };
template <> struct Bf16Elem<8> { using T = uint4; };

// C float32 values rounded to bf16 as one output element.
template <int C>
__device__ __forceinline__ typename Bf16Elem<C>::T pack_bf16(const float v[C]) {
  if constexpr (C == 1) {
    return (unsigned short)bf16_bits(v[0]);
  } else {
    uint32_t w[C / 2];
#pragma unroll
    for (int j = 0; j < C / 2; ++j) w[j] = Bf16::store(make_float2(v[2 * j], v[2 * j + 1]));
    if constexpr (C == 2) {
      return w[0];
    } else if constexpr (C == 4) {
      return make_uint2(w[0], w[1]);
    } else {
      static_assert(C == 8, "bf16 output elements of 1, 2, 4 or 8 channels");
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// kWords 32-bit words at p in the widest loads they allow: 16-byte loads
// where kWords is a multiple of 4, else one 8- or 4-byte load.
template <int kWords>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t e[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
      e[4 * q] = v.x;
      e[4 * q + 1] = v.y;
      e[4 * q + 2] = v.z;
      e[4 * q + 3] = v.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    e[0] = v.x;
    e[1] = v.y;
  } else {
    static_assert(kWords == 1, "a packed cell is 1, 2 or 4k words");
    e[0] = __ldg(p);
  }
}

// the spatial hash's prime of dim d < 7 (reference gridencoder.cu:50-63;
// the wrapper refuses a hashed level at D > 7, which JAX has no prime for)
__device__ __forceinline__ constexpr uint32_t hash_prime(int d) {
  return d == 0   ? 1u
         : d == 1 ? 2654435761u
         : d == 2 ? 805459861u
         : d == 3 ? 3674653429u
         : d == 4 ? 2097192037u
         : d == 5 ? 1434869437u
                  : 2165219737u;
}

// One level's constants from the wrapper's tables: the fp32 scale, and the
// int32 row [offset, size, stride_0 .. stride_{D-1}] (ops/grid_encode.py
// _level_tables); a hashed level's row has stride 0 in dim 0.
template <int D>
struct Level {
  float scale;
  uint32_t offset, size;
  uint32_t stride[D];
  bool hashed;
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
  lv.hashed = lv.stride[0] == 0;
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

// The cell's lower corner at one level, the fractions the weights are
// formed from (kSmooth: f * f * (3 - 2 f) of the cell fraction f, in the
// plain version's op order) and, for the x gradient, d frac / d pos (1, or
// 6 f (1 - f) under smoothstep).
template <int D, bool kSmooth>
__device__ __forceinline__ void cell(const float p[D], float scale, float shift,
                                     uint32_t pg[D], float frac[D], float slope[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = p[d] * scale + shift;
    const float fl = floorf(pos);
    const float f = pos - fl;
    pg[d] = (uint32_t)fl;
    if constexpr (kSmooth) {
      frac[d] = f * f * (3.0f - 2.0f * f);
      slope[d] = 6.0f * f * (1.0f - f);
    } else {
      frac[d] = f;
      slope[d] = 1.0f;
    }
  }
}

// Table row of corner `corner` (bit d set: +1 in dim d): the uint32 index of
// the reference's get_grid_index, or on a hashed level the XOR of coord_d *
// prime_d in uint32, wrapped into the level. A level's size is either its
// dense n^D rounded up to 8 (the index never reaches it) or
// 2^log2_hashmap_size, a power of two: both avoid the division. kHash false:
// the level is never hashed (the bf16 kernels, tiled grids only).
template <int D, bool kHash = true>
__device__ __forceinline__ uint32_t corner_row(const Level<D>& lv, const uint32_t pg[D],
                                               int corner) {
  uint32_t idx = 0;  // uint32 wraparound, as the reference index
  if (kHash && lv.hashed) {
#pragma unroll
    for (int d = 0; d < D; ++d) idx ^= (pg[d] + ((corner >> d) & 1u)) * hash_prime(d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) idx += (pg[d] + ((corner >> d) & 1u)) * lv.stride[d];
  }
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
// rows are r0 and r0 + 1 unless the index wraps at the level's size (or
// the level is hashed); with r0 even the two rows are one aligned pair,
// read (or added) at once.
__device__ __forceinline__ bool pair_aligned(uint32_t r0, uint32_t r1) {
  return r1 == r0 + 1 && (r0 & 1u) == 0;
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

// The C float32 channels of a (point, level) output element, one 4-, 8- or
// 16-byte access (two at C = 8).
template <int C>
struct alignas(C >= 4 ? 16 : 4 * C) Channels {
  float v[C];
};

// A float32 row of C channels: one 4- or 8-byte load at C = 1 or 2, one or
// two 16-byte loads at C = 4 or 8.
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ emb, uint32_t r, float e[C]) {
  if constexpr (C == 1) {
    e[0] = __ldg(emb + r);
  } else if constexpr (C == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(emb) + r);
    e[0] = v.x;
    e[1] = v.y;
  } else {
    const float4* row = reinterpret_cast<const float4*>(emb + (size_t)r * C);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = __ldg(row + q);
      e[4 * q] = v.x;
      e[4 * q + 1] = v.y;
      e[4 * q + 2] = v.z;
      e[4 * q + 3] = v.w;
    }
  }
}

// The rows of corners 2q and 2q + 1: at C <= 2 one load of both where they
// are an aligned pair (8 or 16 bytes; at C = 2 that cuts the scattered L1
// requests a quarter), else a load each.
template <int C>
__device__ __forceinline__ void load_row_pair(const float* __restrict__ emb, uint32_t r0,
                                              uint32_t r1, float e0[C], float e1[C]) {
  if constexpr (C == 1) {
    if (pair_aligned(r0, r1)) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(emb + r0));
      e0[0] = v.x;
      e1[0] = v.y;
      return;
    }
  } else if constexpr (C == 2) {
    if (pair_aligned(r0, r1)) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(emb + 2 * (size_t)r0));
      e0[0] = v.x;
      e0[1] = v.y;
      e1[0] = v.z;
      e1[1] = v.w;
      return;
    }
  }
  load_row<C>(emb, r0, e0);
  load_row<C>(emb, r1, e1);
}

// The bf16 rows of corners 2q and 2q + 1, widened: one 8-byte load where
// they are an aligned pair.
__device__ __forceinline__ void load_pair_bf16(const uint32_t* __restrict__ emb, uint32_t r0,
                                               uint32_t r1, float2& e0, float2& e1) {
  if (pair_aligned(r0, r1)) {
    Bf16::load2(emb + r0, e0, e1);
  } else {
    e0 = Bf16::load(emb + r0);
    e1 = Bf16::load(emb + r1);
  }
}

// C bf16 values at p (aligned to 2C bytes), widened: one 2-, 4-, 8- or
// 16-byte load at C = 1, 2, 4, 8.
template <int C>
__device__ __forceinline__ void load_bf16(const unsigned short* __restrict__ p, float e[C]) {
  if constexpr (C == 1) {
    e[0] = bf16_bits_float(__ldg(p));
  } else {
    uint32_t w[C / 2];
    load_words<C / 2>(reinterpret_cast<const uint32_t*>(p), w);
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const float2 v = Bf16::widen(w[j]);
      e[2 * j] = v.x;
      e[2 * j + 1] = v.y;
    }
  }
}

// bf16(w0) in the low half, bf16(w1) in the high: one cvt rounds both
// weights of a corner pair.
__device__ __forceinline__ uint32_t bf16x2_weights(float w0, float w1) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(w1), "f"(w0));
  return w;
}

// The bf16 terms bf16(bf16(w0) * e0) and bf16(bf16(w1) * e1) of two corner
// rows' channel pairs e0, e1 (bf16x2 words: the even channel in the low
// half), widened to float2, in bf16x2 arithmetic: w the pair's weights
// (bf16x2_weights), one fma.rn.bf16x2 a corner's two channels. The exact
// product of two bf16s fits a float32, so that single rounding equals the
// plain twin's round_bf16(bf16(w) * e), subnormals included (float32 keeps
// 16 more bits than bf16 at every exponent, so rounding its exact product
// again rounds as once); the addend -0 is __hmul2's, which keeps a zero
// product's sign.
__device__ __forceinline__ void bf16_terms(uint32_t e0, uint32_t e1, uint32_t w, float2& a,
                                           float2& b) {
  constexpr uint32_t kMinusZeros = 0x80008000u;
  uint32_t p0, p1;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(p0)
      : "r"(__byte_perm(w, 0, 0x1010)), "r"(e0), "r"(kMinusZeros));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(p1)
      : "r"(__byte_perm(w, 0, 0x3232)), "r"(e1), "r"(kMinusZeros));
  a = Bf16::widen(p0);
  b = Bf16::widen(p1);
}

// ---------------------------------------------------------------------------
// The general path (any D, L and C; general_shape). A block is 32 points x
// Y warps; warp y walks the levels y, y + Y, ... of its 32 points. D is a
// run-time argument, so a (point, level)'s cell -- each dim's lower corner
// and fraction, and for the x gradient its slope -- lies in shared memory
// at stride 32 (a warp's lanes side by side: no bank conflicts), and each
// corner's row and weight are formed from it in the specialised kernels'
// op order. The channels go in chunks of kChunk, whose sums stay in
// registers.

constexpr int kChunk = 16;

// The general path's warps a block: the most of 8 and L whose shared
// memory (`fixed` bytes and `per_warp` a warp) stays within the 48 KB a
// block gets without opting in, at least 1.
inline int general_warps(int L, size_t per_warp, size_t fixed) {
  int Y = L < 8 ? L : 8;
  while (Y > 1 && fixed + Y * per_warp > 48 * 1024) --Y;
  return Y;
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that is
// above the default 48 KB; 0 or the CUDA error.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// unit_position's test at run-time D: false outside [-bound, bound]^D
__device__ __forceinline__ bool in_box(const float* __restrict__ x, int D, float bound,
                                       float two_bound) {
  bool oob = false;  // NaN is not out of the box
  for (int d = 0; d < D; ++d) {
    const float v = (__ldg(x + d) + bound) / two_bound;
    oob |= (v < 0.0f) || (v > 1.0f);
  }
  return !oob;
}

// A level's constants (load_level) at run-time D: its strides stay in the
// level's row of params.
struct LevelAny {
  float scale;
  uint32_t offset, size;
  const int* stride;
  bool hashed;
};

__device__ __forceinline__ LevelAny load_level_any(const float* __restrict__ scales,
                                                   const int* __restrict__ params, int l,
                                                   int D) {
  LevelAny lv;
  lv.scale = __ldg(scales + l);
  const int* p = params + (size_t)l * (2 + D);
  lv.offset = (uint32_t)__ldg(p);
  lv.size = (uint32_t)__ldg(p + 1);
  lv.stride = p + 2;
  lv.hashed = __ldg(p + 2) == 0;
  return lv;
}

// unit_position + cell at run-time D, into pg[32 d], frac[32 d] and (where
// slope is not null) slope[32 d], in the same float32 ops as theirs.
template <bool kSmooth>
__device__ __forceinline__ void cell_any(const float* __restrict__ x, int D, float bound,
                                         float two_bound, float scale, float shift,
                                         uint32_t* pg, float* frac, float* slope) {
  for (int d = 0; d < D; ++d) {
    const float p = (__ldg(x + d) + bound) / two_bound;
    const float pos = p * scale + shift;
    const float fl = floorf(pos);
    const float f = pos - fl;
    pg[32 * d] = (uint32_t)fl;
    if constexpr (kSmooth) {
      frac[32 * d] = f * f * (3.0f - 2.0f * f);
      if (slope != nullptr) slope[32 * d] = 6.0f * f * (1.0f - f);
    } else {
      frac[32 * d] = f;
      if (slope != nullptr) slope[32 * d] = 1.0f;
    }
  }
}

// corner_row at run-time D: the same uint32 index, hash and wrap.
template <bool kHash>
__device__ __forceinline__ uint32_t corner_row_any(const LevelAny& lv, const uint32_t* pg,
                                                   int D, uint32_t corner) {
  uint32_t idx = 0;
  if (kHash && lv.hashed) {
    for (int d = 0; d < D; ++d) idx ^= (pg[32 * d] + ((corner >> d) & 1u)) * hash_prime(d);
  } else {
    for (int d = 0; d < D; ++d) {
      idx += (pg[32 * d] + ((corner >> d) & 1u)) * (uint32_t)__ldg(lv.stride + d);
    }
  }
  if (idx >= lv.size) idx = (lv.size & (lv.size - 1)) ? idx % lv.size : idx & (lv.size - 1);
  return idx + lv.offset;
}

// corner_weight at run-time D
__device__ __forceinline__ float corner_weight_any(const float* frac, int D, uint32_t corner) {
  float w = 1.0f;
  for (int d = 0; d < D; ++d) w = w * (((corner >> d) & 1u) ? frac[32 * d] : 1.0f - frac[32 * d]);
  return w;
}

// corner_weight_grad at run-time D
__device__ __forceinline__ float corner_weight_grad_any(const float* frac, int D,
                                                        uint32_t corner, int d) {
  float dw = ((corner >> d) & 1u) ? 1.0f : -1.0f;
  for (int e = 0; e < D; ++e) {
    if (e == d) continue;
    dw = dw * (((corner >> e) & 1u) ? frac[32 * e] : 1.0f - frac[32 * e]);
  }
  return dw;
}

// W float32 values at p (aligned to 4W bytes) stored as one access.
template <int W>
__device__ __forceinline__ void store_unit(float* __restrict__ p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The general path's table policies: the element of a table row and of
// the output (or grad_out), the load and store of W channels, and the
// rounding of a corner weight and of a term (the bf16 policy rounds both,
// as its plain twin does; float32 neither). kPacked: the forward reads a
// cell's 2^D corner rows side by side from the corner-packed copy.
struct F32Table {
  using T = float;
  static constexpr bool kPacked = false;
  template <int W>
  __device__ static void load(const float* __restrict__ p, float* v) { load_unit<W>(p, v); }
  template <int W>
  __device__ static void store(float* __restrict__ p, const float* v) { store_unit<W>(p, v); }
  __device__ static float round(float v) { return v; }
};

struct Bf16Table {
  using T = unsigned short;
  static constexpr bool kPacked = true;
  template <int W>
  __device__ static void load(const unsigned short* __restrict__ p, float* v) {
    load_bf16<W>(p, v);
  }
  template <int W>
  __device__ static void store(unsigned short* __restrict__ p, const float* v) {
    *reinterpret_cast<typename Bf16Elem<W>::T*>(p) = pack_bf16<W>(v);
  }
  __device__ static float round(float v) { return round_bf16(v); }
};

}  // namespace grid
