// Kernel A: multiresolution tiled grid encoder, forward.
//
// Replaces radnerf_tpu/ops/grid_encode.py: grid_encode01 (:168) and its TPU
// form grid_encode01_packed + build_packed_table (:243-404). The TPU form
// packed each cell's 2^D corners into one wide row (per-level rolls, an
// appended zero row, a one-hot MXU fetch for small levels) because a TPU
// gather costs per row. For float32 none of that carries over: a Hopper
// thread reads the 2^D corner rows straight from the [n_emb, C] fp32 table
// (the bf16 variant below does pack its rows, for another reason). It takes
// every grid the JAX package does (grid_common.cuh): C in {1, 2, 4, 8}
// channels, hashed levels, smoothstep and align_corners.
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
// and divides by nothing but a level's size, and only past it.
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
// corner rows (k + delta_c) mod T of the bf16 table [n_emb, 2] side by side
// -- 2^D bf16x2 words, 16 bytes at D = 2 and one 32-byte sector at D = 3 --
// so a (point, level) makes one or two 16-byte loads from one sector
// instead of 2^(D-1) scattered row-pair loads. What bounded the row layout
// on an H100 80GB HBM3 (700 W; studies/grid_bf16.py, PERF.md §6) was
// the scattered gathers, not bytes or bf16 arithmetic: reading every corner
// from one fixed row cut the -O step's D = 3 call from 0.299 to 0.222 ms
// of device time and the same call on spread points from 0.537 to 0.226,
// while the rounding hooks set to the identity left the D = 3 call as it
// was (and cut the D = 2 call 11%). The packed rows took the D = 3 call to
// 0.146 ms, 0.168 with the packing pass, and the spread points' to 0.198
// with it. The corner terms are formed two at a time in bf16x2 arithmetic
// (grid_common.cuh bf16_terms), bit for bit with the plain twin; the output
// is bf16 [N, 2L]. The packed copy is 2^D times the bf16 table (28.9 MB for
// the 3-D head grid, 8.9 MB a 2-D grid); the wrapper builds it once per
// table version (a train step's encode packs its freshly cast table).

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

// Corner-packed bf16 rows [n_emb, 2^D] bf16x2 -> bf16 out [N, L] bf16x2
// (A-bf16; C = 2 tiled linear grids).
template <int D>
__global__ void __launch_bounds__(1024) grid_encode_kernel_bf16(
    const float* __restrict__ x, const uint4* __restrict__ packed,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    uint32_t* __restrict__ out, int N, int L, float bound, float two_bound) {
  __shared__ uint32_t tile[32 * (grid::kMaxLevels + 1)];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int row = L + 1;  // tile row stride in output elements
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;

  float2 acc = make_float2(0.0f, 0.0f);  // outside the box: exactly zero
  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D], slope[D];
    grid::cell<D, false>(p, lv.scale, 0.5f, pg, frac, slope);
    // the cell's 2^D corner rows: one or two 16-byte loads from one sector
    const uint4* cell = packed + (size_t)grid::corner_row<D, false>(lv, pg, 0) * ((1 << D) / 4);
    uint32_t e[1 << D];
#pragma unroll
    for (int q = 0; q < (1 << D) / 4; ++q) {
      const uint4 v = __ldg(cell + q);
      e[4 * q] = v.x;
      e[4 * q + 1] = v.y;
      e[4 * q + 2] = v.z;
      e[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c0 = 0; c0 < (1 << D); c0 += 2) {
      float2 a, b;
      grid::bf16_terms(e[c0], e[c0 + 1], grid::corner_weight<D>(frac, c0),
                       grid::corner_weight<D>(frac, c0 + 1), a, b);
      acc = c0 == 0 ? a : make_float2(acc.x + a.x, acc.y + a.y);
      acc = make_float2(acc.x + b.x, acc.y + b.y);
    }
  }
  tile[lane * row + l] = grid::Bf16::store(acc);
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // t-th element (32 * L of them, one per thread)
  const int t = l * 32 + lane;
  const int q = t / L;
  if (n0 + q < N) out[(size_t)n0 * L + t] = tile[q * row + (t - q * L)];
}

// packed[(offset_l + k) * 2^D + c] = emb[offset_l + (k + delta_c) mod T_l]
// for every row k of level l = blockIdx.y, delta_c the corner's sum of
// strides: corner c's row as corner_row forms it (uint32 sums wrap at 2^32,
// which a power-of-two T divides; a dense level never wraps)
template <int D>
__global__ void pack_kernel(const uint32_t* __restrict__ emb, const int* __restrict__ params,
                            uint32_t* __restrict__ packed) {
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
    packed[(size_t)(offset + k) * (1 << D) + c] = __ldg(emb + offset + idx);
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

template <int D>
int launch(const void* x, const void* emb, const void* scales, const void* params, void* out,
           int N, int L, int C, int smoothstep, int hashed, float shift, float bound,
           float two_bound, cudaStream_t s) {
#define GRID_FWD(CH)                                                                     \
  launch<D, CH>(x, emb, scales, params, out, N, L, smoothstep, hashed, shift, bound,     \
                two_bound, s)
  switch (C) {
    case 1: return GRID_FWD(1);
    case 2: return GRID_FWD(2);
    case 4: return GRID_FWD(4);
    case 8: return GRID_FWD(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRID_FWD
}

bool bad_shape(long long N, int D, int L) {
  return (D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 0 || N > 0x7fffffffLL;
}

}  // namespace

// kernel A: a float32 table [n_emb, C], C in {1, 2, 4, 8}, the level rows,
// smoothstep 0 or 1, hashed 1 where a level may be hashed (a hash grid),
// the shift (0.5, or 0 under align_corners); float32 out [N, L * C]
extern "C" int grid_encode_fwd(const void* x, const void* emb, const void* scales,
                               const void* level_params, void* out, long long N, int D, int L,
                               int C, int smoothstep, int hashed, float shift, float bound,
                               float two_bound, void* stream) {
  if (bad_shape(N, D, L)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 3 ? launch<3>(x, emb, scales, level_params, out, (int)N, L, C, smoothstep, hashed,
                            shift, bound, two_bound, s)
                : launch<2>(x, emb, scales, level_params, out, (int)N, L, C, smoothstep, hashed,
                            shift, bound, two_bound, s);
}

// bf16 table [n_emb, 2] -> its corner-packed rows [n_emb, 2^D] (bf16x2 words)
extern "C" int grid_pack_bf16(const void* emb, const void* level_params, void* packed, int D,
                              int L, void* stream) {
  if ((D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels) return (int)cudaErrorInvalidValue;
  const dim3 grid(264, L);  // 2 blocks an SM for each level
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    pack_kernel<3><<<grid, 256, 0, s>>>((const uint32_t*)emb, (const int*)level_params,
                                        (uint32_t*)packed);
  } else {
    pack_kernel<2><<<grid, 256, 0, s>>>((const uint32_t*)emb, (const int*)level_params,
                                        (uint32_t*)packed);
  }
  return (int)cudaGetLastError();
}

// A-bf16: the packed bf16 table [n_emb, 2^D] and bf16 out [N, 2L]
extern "C" int grid_encode_fwd_bf16_packed(const void* x, const void* packed,
                                           const void* scales, const void* level_params,
                                           void* out, long long N, int D, int L, float bound,
                                           float two_bound, void* stream) {
  if (bad_shape(N, D, L)) return (int)cudaErrorInvalidValue;
  const dim3 block(32, L);
  const unsigned blocks = (unsigned)((N + 31) / 32);
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    grid_encode_kernel_bf16<3><<<blocks, block, 0, s>>>(
        (const float*)x, (const uint4*)packed, (const float*)scales, (const int*)level_params,
        (uint32_t*)out, (int)N, L, bound, two_bound);
  } else {
    grid_encode_kernel_bf16<2><<<blocks, block, 0, s>>>(
        (const float*)x, (const uint4*)packed, (const float*)scales, (const int*)level_params,
        (uint32_t*)out, (int)N, L, bound, two_bound);
  }
  return (int)cudaGetLastError();
}
