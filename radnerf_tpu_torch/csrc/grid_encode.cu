// Kernel A: multiresolution tiled grid encoder, forward.
//
// Replaces radnerf_tpu/ops/grid_encode.py: grid_encode01 (:168) and its TPU
// form grid_encode01_packed + build_packed_table (:243-404). The TPU form
// packed each cell's 2^D corners into one wide row (per-level rolls, an
// appended zero row, a one-hot MXU fetch for small levels) because a TPU
// gather costs per row. None of that carries over: a Hopper thread reads the
// 2^D corner rows straight from the [n_emb, 2] fp32 table.
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
// The bf16 variant (grid_encode_fwd_bf16, the -O policy; replaces the same
// functions with build_packed_table(dtype=bfloat16) and the bf16 lerp at
// :395-400) is the same template on a bf16 table [n_emb, 2] with a bf16
// output [N, 2L]: a corner row is 4 bytes, a row pair 8, the output half
// the bytes, and the rounding hooks of grid_common.cuh's Table<bf16> put
// bf16 roundings where JAX's op-by-op lerp has them. Its bytes per (point,
// level) are half the float32 variant's; the design is unchanged (a first,
// simple port).

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(1024) grid_encode_kernel(
    const float* __restrict__ x, const typename grid::Table<T>::Row* __restrict__ emb,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    typename grid::Table<T>::Out* __restrict__ out, int N, int L, float bound,
    float two_bound) {
  using Tab = grid::Table<T>;
  __shared__ typename Tab::Out tile[32 * (grid::kMaxLevels + 1)];
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
#pragma unroll
    for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
      float2 e0, e1;
      grid::load_pair<T>(emb, grid::corner_row<D>(lv, pg, c0),
                         grid::corner_row<D>(lv, pg, c0 + 1), e0, e1);
      const float w0 = Tab::weight(grid::corner_weight<D>(frac, c0));
      const float w1 = Tab::weight(grid::corner_weight<D>(frac, c0 + 1));
      const float2 a = make_float2(Tab::term(w0 * e0.x), Tab::term(w0 * e0.y));
      acc = c0 == 0 ? a : make_float2(acc.x + a.x, acc.y + a.y);
      acc = make_float2(acc.x + Tab::term(w1 * e1.x), acc.y + Tab::term(w1 * e1.y));
    }
  }
  tile[lane * row_f2 + l] = Tab::store(acc);
  __syncthreads();

  // the block's rows [n0, n0 + 32) are one run of out: thread t writes its
  // t-th element (32 * L of them, one per thread)
  const int t = l * 32 + lane;
  const int q = t / L;
  if (n0 + q < N) out[(size_t)n0 * L + t] = tile[q * row_f2 + (t - q * L)];
}

template <typename T>
int launch(const void* x, const void* emb, const void* scales, const void* level_params,
           void* out, long long N, int D, int L, float bound, float two_bound, void* stream) {
  if ((D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 0 || N > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  using Tab = grid::Table<T>;
  const dim3 block(32, L);
  const unsigned blocks = (unsigned)((N + 31) / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    grid_encode_kernel<3, T><<<blocks, block, 0, s>>>(
        (const float*)x, (const typename Tab::Row*)emb, (const float*)scales,
        (const int*)level_params, (typename Tab::Out*)out, (int)N, L, bound, two_bound);
  } else {
    grid_encode_kernel<2, T><<<blocks, block, 0, s>>>(
        (const float*)x, (const typename Tab::Row*)emb, (const float*)scales,
        (const int*)level_params, (typename Tab::Out*)out, (int)N, L, bound, two_bound);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grid_encode_fwd(const void* x, const void* emb, const void* scales,
                               const void* level_params, void* out, long long N, int D,
                               int L, float bound, float two_bound, void* stream) {
  return launch<float>(x, emb, scales, level_params, out, N, D, L, bound, two_bound, stream);
}

// bf16 table [n_emb, 2] and bf16 out [N, 2L]; the rest as grid_encode_fwd
extern "C" int grid_encode_fwd_bf16(const void* x, const void* emb, const void* scales,
                                    const void* level_params, void* out, long long N, int D,
                                    int L, float bound, float two_bound, void* stream) {
  return launch<__nv_bfloat16>(x, emb, scales, level_params, out, N, D, L, bound, two_bound,
                               stream);
}
