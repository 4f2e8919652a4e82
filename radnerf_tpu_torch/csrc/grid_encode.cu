// Kernel A: multiresolution tiled grid encoder, forward.
//
// Replaces radnerf_tpu/ops/grid_encode.py: grid_encode01 (:168) and its TPU
// form grid_encode01_packed + build_packed_table (:243-404). The TPU form
// packed each cell's 2^D corners into one wide row (per-level rolls, an
// appended zero row, a one-hot MXU fetch for small levels) because a TPU
// gather costs per row. For float32 none of that carries over: a Hopper
// thread reads the 2^D corner rows straight from the [n_emb, C] fp32 table
// (the bf16 variant below does pack its rows, for another reason). It takes
// every grid the JAX package does (grid_common.cuh): hashed levels,
// smoothstep and align_corners at any D, level count and channel count.
//
// What bounds it on an H100: bytes. Per (point, level) it reads 2^D rows of
// 4C B and writes 4C B, against ~10 flops per corner. The tables on the
// render path are 7.2 MB (3-D) and 4.4 MB (2-D), so they sit in the 50 MB
// L2 and the corner reads are L2 (or L1) hits; the output [N, 2L] is the
// largest stream. Design (grid_common.cuh): a block is 32 points x L
// levels, each warp 32 consecutive points at one level, so at the coarse
// levels neighbouring samples of a ray read the same L1 lines; C at compile
// time, so a corner row is one 4- to 16-byte load (two at C = 8), and at C
// <= 2 the two corners that differ in dim 0 (adjacent rows) one load when
// the pair is aligned, which cuts the scattered L1 requests a quarter at C =
// 2; each warp puts its (point, level) elements of C floats into a
// shared-memory tile [32][L + 1] (the +1 keeps a warp's stores on distinct
// banks), and the block writes its 32 output rows, one contiguous run of
// out, with coalesced stores of one element a thread. Index math is 32-bit
// and divides by nothing but a level's size, and only past it. C in {1, 2,
// 4, 8} is a template argument (RAD-NeRF's C = 2 among them); any other C
// up to 16 runs grid_encode_kernel_any, where C is a run-time argument and
// the channels a loop over units of the widest load that divides a row
// (4, 2 or 1 floats), staged as single floats through a tile [32][L C +
// 1]: 65.7 KB at C = 16 and 32 levels, so the launch opts in to more than
// the 48 KB of dynamic shared memory a block gets by default
// (cudaFuncSetAttribute); a block stays 32 points x L levels. Every other
// grid -- D outside {2, 3}, more than 32 levels or 16 channels -- runs
// grid_encode_kernel_general (grid_common.cuh's general path): 32 points x
// Y warps, each warp walking its levels, the cell in shared memory, for
// each chunk of 16 channels the 2^D corners in order with their rows and
// weights formed again, the sums in registers, each (point, level)'s
// channels stored straight to out in units of the widest load that divides
// a row (64-bit offsets: N L C passes 2^31 at these sizes).
//
// Arithmetic mirrors the plain twin (ops/grid_encode.py grid_encode_plain)
// in the same order (grid_common.cuh): corners 0..2^D-1, the weight's
// product in dim order, the library built with -fmad=false; the result is
// bit for bit the twin's.
//
// The bf16 variant (grid_encode_fwd_bf16_packed, the -O policy; replaces
// the same functions with build_packed_table(dtype=bfloat16) and the bf16
// lerp at :395-400) reads corner-packed rows, JAX's own -O formulation
// made for Hopper: pack_kernel (grid_pack_bf16, its own launch count)
// writes, for each cell key k of each level (corner 0's row), the 2^D
// corner rows (k + delta_c) mod T of the bf16 table [n_emb, C] side by
// side -- 2^D x C bf16s: at C = 2 16 bytes at D = 2 and one 32-byte sector
// at D = 3 -- so a (point, level) reads one packed row in the widest loads
// it allows instead of 2^(D-1) scattered row-pair loads: one 8-byte load
// at C = 1, D = 2, one or two 16-byte loads at C = 2, up to eight at C = 8,
// D = 3 (four 32-byte sectors). The pass copies each corner's C values in
// the widest unit that divides them (2 bytes at C = 1 up to 16 at C = 8,
// two 16-byte units at C = 16). What bounded the row layout
// on an H100 80GB HBM3 (700 W; studies/grid_bf16.py, PERF.md §6) was
// the scattered gathers, not bytes or bf16 arithmetic: reading every corner
// from one fixed row cut the -O step's D = 3 call from 0.299 to 0.222 ms
// of device time and the same call on spread points from 0.537 to 0.226,
// while the rounding hooks set to the identity left the D = 3 call as it
// was (and cut the D = 2 call 11%). The packed rows took the D = 3 call to
// 0.146 ms, 0.168 with the packing pass, and the spread points' to 0.198
// with it. A-bf16 is templated on C in {1, 2, 4, 8} and smoothstep, the
// shift (align_corners) a run-time argument as in A. Where C is even the
// corner terms are formed two channels at a time in bf16x2 arithmetic
// (grid_common.cuh bf16_terms, one weight conversion a corner pair), at C =
// 1 as scalar products, bit for bit with the plain twin either way; the
// output is bf16 [N, L C], staged through a static tile of one C-element
// unit a (point, level) (16.9 KB at C = 8). Any other C up to 16 runs
// grid_encode_kernel_bf16_any: C a run-time argument, scalar products, the
// packed row read 2 bytes at a time. The packed copy is 2^D times the bf16
// table (28.9 MB for the 3-D head grid at C = 2, 8.9 MB a 2-D grid); the
// wrapper builds it once per table version (a train step's encode packs
// its freshly cast table). On the general path grid_encode_kernel_general
// on the bf16 policy (grid_common.cuh Bf16Table) reads the packed row of
// 2^D x C bf16s (512 bytes at D = 7, C = 2) in units of the widest of 1,
// 2, 4 or 8 channels that divides C, with scalar products as the
// run-time-C kernel's, and pack_kernel runs at run-time D (its template
// D = 0).
//
// Kernel A-tri (triplane_encode_fwd; ER-NeRF's tri-plane encode,
// ops/triplane_encode.py) encodes a point's three plane projections (x, y),
// (y, z), (x, z) through three 2-D tables of one level geometry in one
// launch: A's block of 32 points x L levels, each thread reading its point's
// xyz once and running A's D = 2 arithmetic on each projection in turn, the
// 32 x 3 L results staged through one tile and written as one run of the
// [N, 3 L C] output. Three A launches would need the projections sliced
// out of x (a gather copy each) and their outputs concatenated: on the
// ER-NeRF bench frame's 269,727 points (H100 80GB HBM3, 700 W;
// studies/triplane.py) A-tri took 0.069 ms of device time against 0.38-0.59
// for the slices, three A and the cat, and 0.085 for three A on points
// already sliced; its bytes bound it at 0.0127 ms (its 3 x 654 KB tables sit
// in L2). Bit for bit with three plain 2-D encodes concatenated.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

// Float32 table rows [n_emb, C] -> float32 out [N, L * C] (kernel A).
// kSmooth: smoothstep interpolation; kHash: a grid with hashed levels
template <int D, int C, bool kSmooth, bool kHash>
__global__ void __launch_bounds__(1024) grid_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ emb,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    grid::Channels<C>* __restrict__ out, int N, int L, float shift, float bound,
    float two_bound) {
  extern __shared__ float4 smem[];
  grid::Channels<C>* const tile = reinterpret_cast<grid::Channels<C>*>(smem);  // [32][L + 1]
  const int lane = threadIdx.x, l = threadIdx.y;
  const int row = L + 1;  // tile row stride in output elements
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;

  grid::Channels<C> acc;  // outside the box: exactly zero
#pragma unroll
  for (int c = 0; c < C; ++c) acc.v[c] = 0.0f;
  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D], slope[D];
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
#pragma unroll
    for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
      float e0[C], e1[C];
      grid::load_row_pair<C>(emb, grid::corner_row<D, kHash>(lv, pg, c0),
                             grid::corner_row<D, kHash>(lv, pg, c0 + 1), e0, e1);
      const float w0 = grid::corner_weight<D>(frac, c0);
      const float w1 = grid::corner_weight<D>(frac, c0 + 1);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc.v[c] = c0 == 0 ? w0 * e0[c] : acc.v[c] + w0 * e0[c];
        acc.v[c] = acc.v[c] + w1 * e1[c];
      }
    }
  }
  tile[lane * row + l] = acc;
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // t-th element (32 * L of them, one per thread)
  const int t = l * 32 + lane;
  const int q = t / L;
  if (n0 + q < N) out[(size_t)n0 * L + t] = tile[q * row + (t - q * L)];
}

// Float32 table rows [n_emb, C] -> float32 out [N, L * C] for any C up to
// kMaxChannels (kernel A outside C in {1, 2, 4, 8}): C at run time, each
// row read in units of W = unit_floats(C) floats, the channels of a
// (point, level) staged as single floats through a tile [32][L C + 1]
// (the + 1 spreads a warp's stores over the banks).
template <int D, int W, bool kSmooth, bool kHash>
__global__ void __launch_bounds__(1024) grid_encode_kernel_any(
    const float* __restrict__ x, const float* __restrict__ emb,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    float* __restrict__ out, int N, int L, int C, float shift, float bound, float two_bound) {
  extern __shared__ float4 smem[];
  float* const tile = reinterpret_cast<float*>(smem);  // [32][L * C + 1]
  const int lane = threadIdx.x, l = threadIdx.y;
  const int LC = L * C, row = LC + 1;
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;
  float* const mine = tile + lane * row + l * C;

  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D], slope[D];
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
    uint32_t rows[1 << D];
    float w[1 << D];
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      rows[k] = grid::corner_row<D, kHash>(lv, pg, k);
      w[k] = grid::corner_weight<D>(frac, k);
    }
    for (int u = 0; u < C; u += W) {
      float acc[W];
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) {  // corners in order, as the twin sums them
        float e[W];
        grid::load_unit<W>(emb + (size_t)rows[k] * C + u, e);
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = k == 0 ? w[k] * e[i] : acc[i] + w[k] * e[i];
      }
#pragma unroll
      for (int i = 0; i < W; ++i) mine[u + i] = acc[i];
    }
  } else {
    for (int c = 0; c < C; ++c) mine[c] = 0.0f;  // outside the box: exactly zero
  }
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // elements t, t + 32 L, ... (32 L C of them)
  for (int t = l * 32 + lane; t < 32 * LC; t += 32 * L) {
    const int q = t / LC;
    if (n0 + q < N) out[(size_t)n0 * LC + t] = tile[q * row + (t - q * LC)];
  }
}

// Corner-packed bf16 rows [n_emb, 2^D, C] -> bf16 out [N, L * C] (A-bf16;
// C in {1, 2, 4, 8}, tiled grids). kSmooth: smoothstep interpolation; the
// shift is 0.5, or 0 under align_corners.
template <int D, int C, bool kSmooth>
__global__ void __launch_bounds__(1024) grid_encode_kernel_bf16(
    const float* __restrict__ x, const uint32_t* __restrict__ packed,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    typename grid::Bf16Elem<C>::T* __restrict__ out, int N, int L, float shift, float bound,
    float two_bound) {
  using Elem = typename grid::Bf16Elem<C>::T;
  constexpr int kWords = (1 << D) * C / 2;  // 32-bit words in a packed row
  __shared__ Elem tile[32 * (grid::kMaxLevels + 1)];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int row = L + 1;  // tile row stride in output elements
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;

  float acc[C];  // outside the box: exactly zero
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D], slope[D];
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
    // the cell's 2^D corner rows in the widest loads they allow
    uint32_t e[kWords];
    grid::load_words<kWords>(packed + (size_t)grid::corner_row<D, false>(lv, pg, 0) * kWords,
                             e);
    if constexpr (C % 2 == 0) {
      // word j of corner k holds its channels 2j, 2j + 1
#pragma unroll
      for (int c0 = 0; c0 < (1 << D); c0 += 2) {
        const uint32_t w = grid::bf16x2_weights(grid::corner_weight<D>(frac, c0),
                                                grid::corner_weight<D>(frac, c0 + 1));
#pragma unroll
        for (int j = 0; j < C / 2; ++j) {
          float2 a, b;
          grid::bf16_terms(e[c0 * (C / 2) + j], e[(c0 + 1) * (C / 2) + j], w, a, b);
          acc[2 * j] = c0 == 0 ? a.x : acc[2 * j] + a.x;
          acc[2 * j + 1] = c0 == 0 ? a.y : acc[2 * j + 1] + a.y;
          acc[2 * j] = acc[2 * j] + b.x;
          acc[2 * j + 1] = acc[2 * j + 1] + b.y;
        }
      }
    } else {
      // C = 1: corners 2q and 2q + 1 share word q; scalar products
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) {
        const uint32_t v = (k & 1) ? e[k / 2] >> 16 : e[k / 2];
        const float t = grid::round_bf16(grid::round_bf16(grid::corner_weight<D>(frac, k)) *
                                         grid::bf16_bits_float(v & 0xffffu));
        acc[0] = k == 0 ? t : acc[0] + t;
      }
    }
  }
  tile[lane * row + l] = grid::pack_bf16<C>(acc);
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // t-th element (32 * L of them, one per thread)
  const int t = l * 32 + lane;
  const int q = t / L;
  if (n0 + q < N) out[(size_t)n0 * L + t] = tile[q * row + (t - q * L)];
}

// Corner-packed bf16 rows [n_emb, 2^D, C] -> bf16 out [N, L * C] for any
// other C up to kMaxChannels (A-bf16): C at run time, scalar products in
// corner order a channel, the packed row read 2 bytes at a time, staged
// through a tile [32][L C + 1] of bf16s.
template <int D, bool kSmooth>
__global__ void __launch_bounds__(1024) grid_encode_kernel_bf16_any(
    const float* __restrict__ x, const unsigned short* __restrict__ packed,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    unsigned short* __restrict__ out, int N, int L, int C, float shift, float bound,
    float two_bound) {
  extern __shared__ float4 smem[];
  unsigned short* const tile = reinterpret_cast<unsigned short*>(smem);  // [32][L * C + 1]
  const int lane = threadIdx.x, l = threadIdx.y;
  const int LC = L * C, row = LC + 1;
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;
  unsigned short* const mine = tile + lane * row + l * C;

  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D], slope[D];
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
    const unsigned short* cell =
        packed + (size_t)grid::corner_row<D, false>(lv, pg, 0) * ((1 << D) * C);
    float w[1 << D];
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) w[k] = grid::round_bf16(grid::corner_weight<D>(frac, k));
    for (int c = 0; c < C; ++c) {
      float acc;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) {
        const float t = grid::round_bf16(w[k] * grid::bf16_bits_float(__ldg(cell + k * C + c)));
        acc = k == 0 ? t : acc + t;
      }
      mine[c] = (unsigned short)grid::bf16_bits(acc);
    }
  } else {
    for (int c = 0; c < C; ++c) mine[c] = 0;  // outside the box: exactly zero
  }
  __syncthreads();

  for (int t = l * 32 + lane; t < 32 * LC; t += 32 * L) {
    const int q = t / LC;
    if (n0 + q < N) out[(size_t)n0 * LC + t] = tile[q * row + (t - q * LC)];
  }
}

// Kernel A and A-bf16 on the general path (any D, L and C;
// grid_common.cuh), on the table policy P: float32 rows [n_emb, C] ->
// float32 out, or corner-packed bf16 rows [n_emb, 2^D, C] (tiled grids) ->
// bf16 out [N, L * C]. W channels a load and a store (float32: 4, 2 or 1,
// unit_floats; bf16: 8, 4, 2 or 1), each corner's term rounded as the
// policy's twin does, the channels in chunks of kChunk; shared memory
// [Y][2][D][32] words (each warp's cell).
template <typename P, int W, bool kSmooth, bool kHash>
__global__ void __launch_bounds__(256) grid_encode_kernel_general(
    const float* __restrict__ x, const typename P::T* __restrict__ table,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    typename P::T* __restrict__ out, int N, int D, int L, int C, float shift, float bound,
    float two_bound) {
  using T = typename P::T;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x, y = threadIdx.y, Y = blockDim.y;
  uint32_t* const pg = reinterpret_cast<uint32_t*>(smem) + 2 * y * D * 32 + lane;
  float* const frac = reinterpret_cast<float*>(pg + D * 32);
  const int n = blockIdx.x * 32 + lane;
  if (n >= N) return;  // no barrier below
  const float* xn = x + (size_t)n * D;
  const bool live = grid::in_box(xn, D, bound, two_bound);
  for (int l = y; l < L; l += Y) {
    T* const o = out + ((size_t)n * L + l) * C;
    if (!live) {  // outside the box: exactly zero
      for (int c = 0; c < C; ++c) o[c] = T(0);
      continue;
    }
    const grid::LevelAny lv = grid::load_level_any(scales, level_params, l, D);
    grid::cell_any<kSmooth>(xn, D, bound, two_bound, lv.scale, shift, pg, frac, nullptr);
    const T* cell = table;  // packed: the cell's corner rows, at corner 0's row
    if constexpr (P::kPacked) {
      cell += (size_t)grid::corner_row_any<false>(lv, pg, D, 0) * ((size_t)C << D);
    }
    for (int c0 = 0; c0 < C; c0 += grid::kChunk) {
      float acc[grid::kChunk];
      for (uint32_t k = 0; k < (1u << D); ++k) {  // corners in order, as the twin sums them
        const float w = P::round(grid::corner_weight_any(frac, D, k));
        const T* e;
        if constexpr (P::kPacked) {
          e = cell + (size_t)k * C + c0;
        } else {
          e = table + (size_t)grid::corner_row_any<kHash>(lv, pg, D, k) * C + c0;
        }
#pragma unroll
        for (int u = 0; u < grid::kChunk; u += W) {
          if (c0 + u < C) {
            float v[W];
            P::template load<W>(e + u, v);
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const float t = P::round(w * v[i]);
              acc[u + i] = k == 0 ? t : acc[u + i] + t;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < grid::kChunk; u += W) {
        if (c0 + u < C) P::template store<W>(o + c0 + u, acc + u);
      }
    }
  }
}

// packed[(offset_l + k) * 2^D + c] = emb[offset_l + (k + delta_c) mod T_l]
// (a row of C bf16s each) for every row k of level l = blockIdx.y, delta_c
// the corner's sum of strides: corner c's row as corner_row forms it
// (uint32 sums wrap at 2^32, which a power-of-two T divides; a dense level
// never wraps). A row is kWords units U (kWords 0: `words` at run time);
// kD 0: D (`dims`) at run time.
template <int kD, typename U, int kWords>
__global__ void pack_kernel(const U* __restrict__ emb, const int* __restrict__ params,
                            U* __restrict__ packed, int words, int dims) {
  const int D = kD > 0 ? kD : dims;
  const int nw = kWords > 0 ? kWords : words;
  const int* p = params + blockIdx.y * (2 + D);
  const uint32_t offset = (uint32_t)p[0], size = (uint32_t)p[1];
  const long long n = (long long)size << D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t k = (uint32_t)(i >> D);
    const int c = (int)(i & ((1 << D) - 1));
    uint32_t idx = k;
#pragma unroll
    for (int d = 0; d < D; ++d) idx += ((c >> d) & 1) ? (uint32_t)p[2 + d] : 0u;
    if (idx >= size) idx = (size & (size - 1)) ? idx % size : idx & (size - 1);
    const U* src = emb + (size_t)(offset + idx) * nw;
    U* dst = packed + ((size_t)(offset + k) * (1 << D) + c) * nw;
    if constexpr (kWords > 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) dst[w] = __ldg(src + w);
    } else {
      for (int w = 0; w < words; ++w) dst[w] = __ldg(src + w);
    }
  }
}

template <int D, int C, bool kSmooth, bool kHash>
int launch(const void* x, const void* emb, const void* scales, const void* params, void* out,
           int N, int L, float shift, float bound, float two_bound, cudaStream_t s) {
  const size_t smem = sizeof(float) * C * 32 * (L + 1);  // at most 33.8 KB
  grid_encode_kernel<D, C, kSmooth, kHash><<<(N + 31) / 32, dim3(32, L), smem, s>>>(
      (const float*)x, (const float*)emb, (const float*)scales, (const int*)params,
      (grid::Channels<C>*)out, N, L, shift, bound, two_bound);
  return (int)cudaGetLastError();
}

template <int D, int W, bool kSmooth, bool kHash>
int launch_any(const void* x, const void* emb, const void* scales, const void* params,
               void* out, int N, int L, int C, float shift, float bound, float two_bound,
               cudaStream_t s) {
  constexpr size_t kMaxSmem =
      sizeof(float) * 32 * (grid::kMaxLevels * grid::kMaxChannels + 1);
  const size_t smem = sizeof(float) * 32 * ((size_t)L * C + 1);  // at most 65.7 KB
  auto kernel = grid_encode_kernel_any<D, W, kSmooth, kHash>;
  // above the default 48 KB of dynamic shared memory, opt in to the most any
  // call of it takes, at every such launch: the attribute is the current
  // device's, and setting it costs a host call
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != 0) return err;
  }
  kernel<<<(N + 31) / 32, dim3(32, L), smem, s>>>(
      (const float*)x, (const float*)emb, (const float*)scales, (const int*)params,
      (float*)out, N, L, C, shift, bound, two_bound);
  return (int)cudaGetLastError();
}

// a general-path forward (T: the table's and the output's element):
// shared memory [Y][2][D][32] words
template <typename T>
int launch_general(void (*kernel)(const float*, const T*, const float*, const int*, T*, int,
                                  int, int, int, float, float, float),
                   const void* x, const void* table, const void* scales, const void* params,
                   void* out, int N, int D, int L, int C, float shift, float bound,
                   float two_bound, cudaStream_t s) {
  const size_t per_warp = sizeof(uint32_t) * 2 * 32 * (size_t)D;
  const int Y = grid::general_warps(L, per_warp, 0);
  const size_t smem = Y * per_warp;
  const int err = grid::allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<(N + 31) / 32, dim3(32, Y), smem, s>>>((const float*)x, (const T*)table,
                                                 (const float*)scales, (const int*)params,
                                                 (T*)out, N, D, L, C, shift, bound, two_bound);
  return (int)cudaGetLastError();
}

int launch_general_f32(const void* x, const void* emb, const void* scales, const void* params,
                       void* out, int N, int D, int L, int C, int smoothstep, int hashed,
                       float shift, float bound, float two_bound, cudaStream_t s) {
#define GRID_FWD(W, SMOOTH, HASH)                                                               \
  launch_general<float>(grid_encode_kernel_general<grid::F32Table, W, SMOOTH, HASH>, x, emb,    \
                        scales, params, out, N, D, L, C, shift, bound, two_bound, s)
#define GRID_FWD_W(W)                                                                           \
  if (smoothstep) return hashed ? GRID_FWD(W, true, true) : GRID_FWD(W, true, false);          \
  return hashed ? GRID_FWD(W, false, true) : GRID_FWD(W, false, false)
  switch (grid::unit_floats(C)) {
    case 4: GRID_FWD_W(4);
    case 2: GRID_FWD_W(2);
    default: GRID_FWD_W(1);
  }
#undef GRID_FWD_W
#undef GRID_FWD
}

// the widest of 8, 4, 2 or 1 bf16 channels that divides C
constexpr int bf16_unit(int C) { return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1; }

int launch_general_bf16(const void* x, const void* packed, const void* scales,
                        const void* params, void* out, int N, int D, int L, int C,
                        int smoothstep, float shift, float bound, float two_bound,
                        cudaStream_t s) {
#define GRID_FWD_BF16(W, SMOOTH)                                                                \
  launch_general<unsigned short>(grid_encode_kernel_general<grid::Bf16Table, W, SMOOTH, false>, \
                                 x, packed, scales, params, out, N, D, L, C, shift, bound,     \
                                 two_bound, s)
#define GRID_FWD_BF16_W(W) return smoothstep ? GRID_FWD_BF16(W, true) : GRID_FWD_BF16(W, false)
  switch (bf16_unit(C)) {
    case 8: GRID_FWD_BF16_W(8);
    case 4: GRID_FWD_BF16_W(4);
    case 2: GRID_FWD_BF16_W(2);
    default: GRID_FWD_BF16_W(1);
  }
#undef GRID_FWD_BF16_W
#undef GRID_FWD_BF16
}

template <int D, int C>
int launch(const void* x, const void* emb, const void* scales, const void* params, void* out,
           int N, int L, int smoothstep, int hashed, float shift, float bound, float two_bound,
           cudaStream_t s) {
#define GRID_FWD(SMOOTH, HASH) \
  launch<D, C, SMOOTH, HASH>(x, emb, scales, params, out, N, L, shift, bound, two_bound, s)
  if (smoothstep) return hashed ? GRID_FWD(true, true) : GRID_FWD(true, false);
  return hashed ? GRID_FWD(false, true) : GRID_FWD(false, false);
#undef GRID_FWD
}

template <int D, int W>
int launch_any(const void* x, const void* emb, const void* scales, const void* params,
               void* out, int N, int L, int C, int smoothstep, int hashed, float shift,
               float bound, float two_bound, cudaStream_t s) {
#define GRID_FWD(SMOOTH, HASH)                                                                 \
  launch_any<D, W, SMOOTH, HASH>(x, emb, scales, params, out, N, L, C, shift, bound,          \
                                 two_bound, s)
  if (smoothstep) return hashed ? GRID_FWD(true, true) : GRID_FWD(true, false);
  return hashed ? GRID_FWD(false, true) : GRID_FWD(false, false);
#undef GRID_FWD
}

template <int D>
int launch(const void* x, const void* emb, const void* scales, const void* params, void* out,
           int N, int L, int C, int smoothstep, int hashed, float shift, float bound,
           float two_bound, cudaStream_t s) {
#define GRID_FWD(CH)                                                                     \
  launch<D, CH>(x, emb, scales, params, out, N, L, smoothstep, hashed, shift, bound,     \
                two_bound, s)
#define GRID_FWD_ANY(W)                                                                  \
  launch_any<D, W>(x, emb, scales, params, out, N, L, C, smoothstep, hashed, shift,      \
                   bound, two_bound, s)
  switch (C) {
    case 1: return GRID_FWD(1);
    case 2: return GRID_FWD(2);
    case 4: return GRID_FWD(4);
    case 8: return GRID_FWD(8);
    default:
      switch (grid::unit_floats(C)) {
        case 4: return GRID_FWD_ANY(4);
        case 2: return GRID_FWD_ANY(2);
        default: return GRID_FWD_ANY(1);
      }
  }
#undef GRID_FWD
#undef GRID_FWD_ANY
}

template <int D, int C, bool kSmooth>
void launch_bf16_fixed(const void* x, const void* packed, const void* scales,
                       const void* params, void* out, int N, int L, float shift, float bound,
                       float two_bound, cudaStream_t s) {
  grid_encode_kernel_bf16<D, C, kSmooth><<<(N + 31) / 32, dim3(32, L), 0, s>>>(
      (const float*)x, (const uint32_t*)packed, (const float*)scales, (const int*)params,
      (typename grid::Bf16Elem<C>::T*)out, N, L, shift, bound, two_bound);
}

template <int D, bool kSmooth>
void launch_bf16_any(const void* x, const void* packed, const void* scales,
                     const void* params, void* out, int N, int L, int C, float shift,
                     float bound, float two_bound, cudaStream_t s) {
  const size_t smem = sizeof(unsigned short) * 32 * ((size_t)L * C + 1);  // at most 32.8 KB
  grid_encode_kernel_bf16_any<D, kSmooth><<<(N + 31) / 32, dim3(32, L), smem, s>>>(
      (const float*)x, (const unsigned short*)packed, (const float*)scales,
      (const int*)params, (unsigned short*)out, N, L, C, shift, bound, two_bound);
}

template <int D, bool kSmooth>
void launch_bf16(const void* x, const void* packed, const void* scales, const void* params,
                 void* out, int N, int L, int C, float shift, float bound, float two_bound,
                 cudaStream_t s) {
#define GRID_FWD_BF16(CH)                                                                   \
  launch_bf16_fixed<D, CH, kSmooth>(x, packed, scales, params, out, N, L, shift, bound,     \
                                    two_bound, s)
  switch (C) {
    case 1: GRID_FWD_BF16(1); break;
    case 2: GRID_FWD_BF16(2); break;
    case 4: GRID_FWD_BF16(4); break;
    case 8: GRID_FWD_BF16(8); break;
    default:
      launch_bf16_any<D, kSmooth>(x, packed, scales, params, out, N, L, C, shift, bound,
                                  two_bound, s);
  }
#undef GRID_FWD_BF16
}

template <int D, typename U, int kWords>
void launch_pack_units(const void* emb, const void* params, void* packed, int L, int words,
                       int dims, cudaStream_t s) {
  const dim3 grid(264, L);  // 2 blocks an SM for each level
  pack_kernel<D, U, kWords><<<grid, 256, 0, s>>>((const U*)emb, (const int*)params, (U*)packed,
                                                 words, dims);
}

// a row of C bf16s (2C bytes) in the widest unit that divides it; D 0: at
// run time (dims)
template <int D>
void launch_pack(const void* emb, const void* params, void* packed, int L, int C, int dims,
                 cudaStream_t s) {
#define PACK(U, K, WORDS) launch_pack_units<D, U, K>(emb, params, packed, L, WORDS, dims, s)
  switch (C) {
    case 1: return PACK(unsigned short, 1, 1);
    case 2: return PACK(uint32_t, 1, 1);
    case 4: return PACK(uint2, 1, 1);
    case 8: return PACK(uint4, 1, 1);
    case 16: return PACK(uint4, 2, 2);
    default:
      if (C % 4 == 0) return PACK(uint2, 0, C / 4);
      if (C % 2 == 0) return PACK(uint32_t, 0, C / 2);
      return PACK(unsigned short, 0, C);
  }
#undef PACK
}

bool bad_shape(long long N, int D, int L, int C) {
  return grid::bad_shape(D, L, C) || N < 0 || N > 0x7fffffffLL;
}

// Kernel A-tri: ER-NeRF's tri-plane encode. Points [N, 3] -> float32 out
// [N, 3 L], the planes (x, y), (y, z), (x, z) in that order, each through
// its own 2-D table [n_emb, 1] of one shared level geometry (a hash grid's
// levels, each hashed or dense as its row says; linear, not aligned). A
// block is 32 points x L levels, as kernel A's: each thread reads its
// point's xyz once and forms its level's cell, weights and corner sums on
// the three projections in turn (each with its own in-box test, as three
// 2-D encodes have), the arithmetic of grid_encode_kernel<2, 1>
// (grid_common.cuh) in the same order; the block's 32 x 3 L values go
// through a shared tile [32][3 L + 1] (12.5 KB at 32 levels) and out as one
// contiguous run of 32 rows, so the result is written once, with no slice of
// x and no concatenation.
__global__ void __launch_bounds__(1024) triplane_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ emb_xy,
    const float* __restrict__ emb_yz, const float* __restrict__ emb_xz,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    float* __restrict__ out, int N, int L, float bound, float two_bound) {
  extern __shared__ float4 smem[];
  float* const tile = reinterpret_cast<float*>(smem);  // [32][3L + 1]
  const int lane = threadIdx.x, l = threadIdx.y;
  const int L3 = 3 * L, row = L3 + 1;  // tile row stride in output elements
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;

  float xyz[3] = {0.0f, 0.0f, 0.0f};
  if (n < N) {
#pragma unroll
    for (int d = 0; d < 3; ++d) xyz[d] = __ldg(x + (size_t)n * 3 + d);
  }
  const grid::Level<2> lv = grid::load_level<2>(scales, level_params, l);
#pragma unroll
  for (int plane = 0; plane < 3; ++plane) {
    const float* __restrict__ emb = plane == 0 ? emb_xy : (plane == 1 ? emb_yz : emb_xz);
    const float q[2] = {xyz[plane == 2 ? 0 : plane], xyz[plane == 0 ? 1 : 2]};
    float acc = 0.0f;  // outside the plane's square: exactly zero
    float p[2];
    if (n < N && grid::unit_position<2>(q, bound, two_bound, p)) {
      uint32_t pg[2];
      float frac[2], slope[2];
      grid::cell<2, false>(p, lv.scale, 0.5f, pg, frac, slope);
#pragma unroll
      for (int c0 = 0; c0 < 4; c0 += 2) {  // corners c0, c0 + 1: one row pair
        float e0[1], e1[1];
        grid::load_row_pair<1>(emb, grid::corner_row<2>(lv, pg, c0),
                               grid::corner_row<2>(lv, pg, c0 + 1), e0, e1);
        const float w0 = grid::corner_weight<2>(frac, c0);
        const float w1 = grid::corner_weight<2>(frac, c0 + 1);
        acc = c0 == 0 ? w0 * e0[0] : acc + w0 * e0[0];
        acc = acc + w1 * e1[0];
      }
    }
    tile[lane * row + plane * L + l] = acc;
  }
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // elements t, t + 32 L, t + 64 L (32 * 3 L of them)
  for (int t = l * 32 + lane; t < 32 * L3; t += 32 * L) {
    const int q = t / L3;
    if (n0 + q < N) out[(size_t)n0 * L3 + t] = tile[q * row + (t - q * L3)];
  }
}

}  // namespace

// kernel A: a float32 table [n_emb, C], the level rows, smoothstep 0 or 1,
// hashed 1 where a level may be hashed (a hash grid), the shift (0.5, or 0
// under align_corners); float32 out [N, L * C]
extern "C" int grid_encode_fwd(const void* x, const void* emb, const void* scales,
                               const void* level_params, void* out, long long N, int D, int L,
                               int C, int smoothstep, int hashed, float shift, float bound,
                               float two_bound, void* stream) {
  if (bad_shape(N, D, L, C)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (grid::general_shape(D, L, C)) {
    return launch_general_f32(x, emb, scales, level_params, out, (int)N, D, L, C, smoothstep,
                              hashed, shift, bound, two_bound, s);
  }
  return D == 3 ? launch<3>(x, emb, scales, level_params, out, (int)N, L, C, smoothstep, hashed,
                            shift, bound, two_bound, s)
                : launch<2>(x, emb, scales, level_params, out, (int)N, L, C, smoothstep, hashed,
                            shift, bound, two_bound, s);
}

// bf16 table [n_emb, C] -> its corner-packed rows [n_emb, 2^D, C]
extern "C" int grid_pack_bf16(const void* emb, const void* level_params, void* packed, int D,
                              int L, int C, void* stream) {
  if (bad_shape(0, D, L, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    launch_pack<3>(emb, level_params, packed, L, C, D, s);
  } else if (D == 2) {
    launch_pack<2>(emb, level_params, packed, L, C, D, s);
  } else {
    launch_pack<0>(emb, level_params, packed, L, C, D, s);
  }
  return (int)cudaGetLastError();
}

// A-bf16: the packed bf16 table [n_emb, 2^D, C], smoothstep 0 or 1, the
// shift (0.5, or 0 under align_corners); bf16 out [N, L * C]
extern "C" int grid_encode_fwd_bf16_packed(const void* x, const void* packed,
                                           const void* scales, const void* level_params,
                                           void* out, long long N, int D, int L, int C,
                                           int smoothstep, float shift, float bound,
                                           float two_bound, void* stream) {
  if (bad_shape(N, D, L, C)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
  if (grid::general_shape(D, L, C)) {
    return launch_general_bf16(x, packed, scales, level_params, out, n, D, L, C, smoothstep,
                               shift, bound, two_bound, s);
  }
#define GRID_FWD_BF16(DIM, SMOOTH)                                                         \
  launch_bf16<DIM, SMOOTH>(x, packed, scales, level_params, out, n, L, C, shift, bound,   \
                           two_bound, s)
  if (D == 3) {
    if (smoothstep) GRID_FWD_BF16(3, true); else GRID_FWD_BF16(3, false);
  } else {
    if (smoothstep) GRID_FWD_BF16(2, true); else GRID_FWD_BF16(2, false);
  }
#undef GRID_FWD_BF16
  return (int)cudaGetLastError();
}

// A-tri: points [N, 3], the three planes' float32 tables [n_emb, 1] (xy, yz,
// xz) of one 2-D level geometry (at most kMaxLevels levels; linear, not
// aligned); float32 out [N, 3 L]
extern "C" int triplane_encode_fwd(const void* x, const void* emb_xy, const void* emb_yz,
                                   const void* emb_xz, const void* scales,
                                   const void* level_params, void* out, long long N, int L,
                                   float bound, float two_bound, void* stream) {
  if (bad_shape(N, 2, L, 1) || L > grid::kMaxLevels) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * 32 * (3 * (size_t)L + 1);
  triplane_encode_kernel<<<((int)N + 31) / 32, dim3(32, L), smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)emb_xy, (const float*)emb_yz, (const float*)emb_xz,
      (const float*)scales, (const int*)level_params, (float*)out, (int)N, L, bound,
      two_bound);
  return (int)cudaGetLastError();
}
