// Kernel A: multiresolution tiled grid encoder, forward.
//
// Replaces radnerf_tpu/ops/grid_encode.py: grid_encode01 (:168) and its TPU
// form grid_encode01_packed + build_packed_table (:243-404). The TPU form
// packed each cell's 2^D corners into one wide row (per-level rolls, an
// appended zero row, a one-hot MXU fetch for small levels) because a TPU
// gather costs per row. For float32 none of that carries over: a Hopper
// thread reads the 2^D corner rows straight from the [n_emb, 2] fp32 table
// (the bf16 variant below does pack its rows, for another reason).
//
// What bounds it on an H100: bytes. Per (point, level) it reads 2^D rows of
// 8 B and writes 8 B, against ~10 flops per corner. The tables on the
// render path are 7.2 MB (3-D) and 4.4 MB (2-D), so they sit in the 50 MB
// L2 and the corner reads are L2 (or L1) hits; the output [N, 2L] is the
// largest stream. Design (grid_common.cuh): a block is 32 points x L
// levels, each warp 32 consecutive points at one level, so at the coarse
// levels neighbouring samples of a ray read the same L1 lines; C = 2 at
// compile time, so a corner row is one 8-byte load, and the two corners
// that differ in dim 0 (adjacent rows) one 16-byte load when the pair is
// aligned, which cuts the scattered L1 requests a quarter; each warp puts its
// float2s into a shared-memory tile [32][2L + 2] (the +2 keeps a half-warp's
// float2 stores on distinct banks), and the block writes its 32 output rows,
// one contiguous run of out, with coalesced float2 stores. Index math is
// 32-bit and divides by nothing but a level's size, and only past it.
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

#include <type_traits>

#include "grid_common.cuh"

namespace {

// kPacked false: float32 table rows [n_emb] float2 -> float32 out [N, L]
// float2 (kernel A); true: corner-packed bf16 rows [n_emb, 2^D] bf16x2 ->
// bf16 out [N, L] bf16x2 (A-bf16)
template <int D, bool kPacked>
__global__ void __launch_bounds__(1024) grid_encode_kernel(
    const float* __restrict__ x, const void* __restrict__ table,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    void* __restrict__ out_, int N, int L, float bound, float two_bound) {
  using Out = std::conditional_t<kPacked, uint32_t, float2>;
  __shared__ Out tile[32 * (grid::kMaxLevels + 1)];
  Out* __restrict__ out = static_cast<Out*>(out_);
  const int lane = threadIdx.x, l = threadIdx.y;
  const int row_f2 = L + 1;  // tile row stride in output elements
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;

  float2 acc = make_float2(0.0f, 0.0f);  // outside the box: exactly zero
  float p[D];
  if (n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p)) {
    const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
    uint32_t pg[D];
    float frac[D];
    grid::cell<D>(p, lv.scale, pg, frac);
    if constexpr (kPacked) {
      // the cell's 2^D corner rows: one or two 16-byte loads from one sector
      const uint4* cell = static_cast<const uint4*>(table) +
                          (size_t)grid::corner_row<D>(lv, pg, 0) * ((1 << D) / 4);
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
    } else {
      const float2* __restrict__ emb = static_cast<const float2*>(table);
#pragma unroll
      for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
        float2 e0, e1;
        grid::load_pair<float>(emb, grid::corner_row<D>(lv, pg, c0),
                               grid::corner_row<D>(lv, pg, c0 + 1), e0, e1);
        const float w0 = grid::corner_weight<D>(frac, c0);
        const float w1 = grid::corner_weight<D>(frac, c0 + 1);
        const float2 a = make_float2(w0 * e0.x, w0 * e0.y);
        acc = c0 == 0 ? a : make_float2(acc.x + a.x, acc.y + a.y);
        acc = make_float2(acc.x + w1 * e1.x, acc.y + w1 * e1.y);
      }
    }
  }
  if constexpr (kPacked) {
    tile[lane * row_f2 + l] = grid::Table<__nv_bfloat16>::store(acc);
  } else {
    tile[lane * row_f2 + l] = acc;
  }
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // t-th element (32 * L of them, one per thread)
  const int t = l * 32 + lane;
  const int q = t / L;
  if (n0 + q < N) out[(size_t)n0 * L + t] = tile[q * row_f2 + (t - q * L)];
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

template <bool kPacked>
int launch(const void* x, const void* table, const void* scales, const void* level_params,
           void* out, long long N, int D, int L, float bound, float two_bound, void* stream) {
  if ((D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 0 || N > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(32, L);
  const unsigned blocks = (unsigned)((N + 31) / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    grid_encode_kernel<3, kPacked><<<blocks, block, 0, s>>>(
        (const float*)x, table, (const float*)scales, (const int*)level_params, out, (int)N, L,
        bound, two_bound);
  } else {
    grid_encode_kernel<2, kPacked><<<blocks, block, 0, s>>>(
        (const float*)x, table, (const float*)scales, (const int*)level_params, out, (int)N, L,
        bound, two_bound);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grid_encode_fwd(const void* x, const void* emb, const void* scales,
                               const void* level_params, void* out, long long N, int D,
                               int L, float bound, float two_bound, void* stream) {
  return launch<false>(x, emb, scales, level_params, out, N, D, L, bound, two_bound, stream);
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

// the packed bf16 table [n_emb, 2^D] and bf16 out [N, 2L]; the rest as
// grid_encode_fwd
extern "C" int grid_encode_fwd_bf16_packed(const void* x, const void* packed,
                                           const void* scales, const void* level_params,
                                           void* out, long long N, int D, int L, float bound,
                                           float two_bound, void* stream) {
  return launch<true>(x, packed, scales, level_params, out, N, D, L, bound, two_bound, stream);
}
