// Kernel A': multiresolution tiled grid encoder, backward.
//
// Replaces the gradient of radnerf_tpu/ops/grid_encode.py: grid_encode01
// (:168-216), which JAX takes by autodiff: XLA transposes the corner
// gathers into a scatter-add over the [n_emb, C] table, and the position
// gradient flows only through frac = pos - stop_gradient(floor(pos))
// (:193, :196). Per (point, level):
//
//   grad_table[row(corner)] += w(corner) * grad_out[point, level]
//   grad_pos[d]             += sum_corner (grad_out . table[row]) * dw/dfrac_d
//   grad_x[d]                = sum_level grad_pos[d] * scale_l / (2 * bound)
//
// Points outside [-bound, bound]^D get zero gradient for both, as their
// forward output is exactly zero (every corner weight carries inb = 0).
//
// What bounds it on an H100: the table gradient's atomics, and their
// contention. Each (point, level) adds 2^D rows of C floats; the coarse
// levels are small (4,920 rows at the 3-D level 0, 296 at the 2-D one) and
// every sample hits them, and while the field is untrained the ambient MLP
// sends every sample of a step into the same 2-D cells at every level, so
// the adds serialise on a few L2 addresses. Design (grid_common.cuh): a
// block is P points x L levels and each warp is 32 consecutive points at
// one level. The corners go in pairs that differ in dim 0 (adjacent rows).
// Per pair, lanes whose rows equal the lane before's (the march writes
// samples ray by ray, so contention comes as runs) sum their 2C values with
// a segmented shuffle reduction, and the run's first lane alone adds them
// as vector reductions into global memory (float2 and float4 atomicAdd:
// compute capability 9.x): at C = 1 and 2 the two rows as one float2 or
// float4 when they are an aligned pair, else a float or float2 each; at C
// = 4 and 8 one or two float4s a row. One float reduction a channel was
// 3.9x slower at C = 4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md). C in {1,
// 2, 4, 8} is a template argument (RAD-NeRF's C = 2 among them); any other
// C up to 16 runs grid_encode_bwd_kernel_any, C at run time and the
// channels a loop over units of the widest load that divides a row (float4
// at C = 12 and 16, float2 at even C, a float at odd C), each unit merged
// over the run and added as one reduction a row. Every other grid -- D
// outside {2, 3}, more than 32 levels or 16 channels -- runs
// grid_encode_bwd_kernel_general (grid_common.cuh's general path): 32 points
// x Y warps, each warp walking the levels y, y + Y, ... in rounds of Y
// levels, the cell in shared memory, the corner pairs and channel units as
// the run-time-C kernel's; each level's share of the x gradient goes
// through shared memory and after each round warp 0 adds the round's
// shares to its running sums in level order, so the x gradient is summed
// in the same order as at L <= 32, with no atomics, in bounded shared
// memory. Every
// level adds into global memory: on the step's own points a per-block sum
// of the coarse levels in shared memory is slower (PERF.md). Under smoothstep the x gradient takes
// d frac / d pos = 6 f (1 - f) of each dim's cell fraction f.
//
// The x gradient needs no atomics (store_x_grad).
//
// The bf16 variant (grid_encode_bwd_bf16_keyed, the gradient of the -O
// policy's bf16 encode; tiled grids, C up to 16, smoothstep and
// align_corners) takes a bf16 table and a bf16 grad_out [N, L C] (2C bytes
// a (point, level) instead of 4C); it writes
// float32 gradients, the table's through float32 atomics. Its corner
// weights are rounded to bf16 as in the forward, so each added term
// bf16(w) * g is exact in float32; the x gradient treats that rounding as
// the identity, as autodiff treats a cast. JAX instead rounds each term to
// bf16 and scatter-adds into a bf16 table: the port's sum is the more
// exact one, a deliberate difference (ops/grid_encode.py).
//
// What bounds A'-bf16 on an H100 80GB HBM3 (700 W; studies/grid_bf16.py,
// PERF.md §6): the global reductions it issues. With the float32 kernel's
// row-pair adds, the -O step's D = 3 call issued 80.6M of them into 575,422
// rows and took 1.136 ms of device time, its reductions replayed alone 1.058;
// plain stores in their place were slower (1.328 ms), and holding each
// level in a thread-block cluster's distributed shared memory
// (studies/grid_level_major.cu) was 3.9-38x slower: the card adds into
// shared memory at 45-63M row pairs a ms (four float32 atomics each) in a
// block's own and 11.4M across a cluster of 4, against 53-85M float4
// reductions a ms into device memory. A third of those reductions were the
// second float2 of a corner pair whose rows straddle two 16-byte slots (r0
// odd). So A'-bf16 adds each corner pair whole, one float4 a run of lanes
// whatever r0's parity, into a pair-keyed buffer keys[r0] (16 bytes a row,
// zeroed by the wrapper; r1 = r0 + 1 mod the level's size, as dim 0's
// stride is 1), and a finish pass stores row r's gradient keys[r].xy +
// keys[r - 1].zw: 53.7M reductions and 0.684 ms on that call, 0.317 ms
// against 0.532 on the D = 2 one (the x gradient 0.216 of it). At every C
// a key is 2C floats in units of two channels (one channel at odd C), one
// vector reduction a unit (add_key_unit: float2 at C = 1, one float4 at C
// = 2, two at C = 4, four at C = 8), and grid_encode_bwd_finish_kernel
// forms each row unit by unit; A'-bf16 is templated on C in {1, 2, 4, 8}
// and smoothstep (the shift at run time), and any other C up to 16 runs
// grid_encode_bwd_kernel_bf16_any, C at run time; every other grid
// grid_encode_bwd_kernel_general on the bf16 policy (grid_common.cuh
// Bf16Table), adding into the pair keys as the run-time-C kernel does.

// The atomic order varies from run to run, so the table gradient is not
// bit-exact between runs or with the plain version; it agrees to the
// rounding of a float32 sum taken in another order. The wrapper zeroes
// grad_table (A') or the keys (A'-bf16, whose finish stores every row);
// either gradient may be left out when it is not needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add

// Sums v over each run of lanes of the warp whose rows (r0, r1) equal the
// lane before's (the march writes samples ray by ray, so equal rows come as
// runs); returns true on the run's first lane, whose v then holds the run's
// sum. Every lane of the warp calls it.
template <int V>
__device__ __forceinline__ bool merge_runs(uint32_t r0, uint32_t r1, float (&v)[V],
                                           unsigned lane) {
  const uint32_t prev0 = __shfl_up_sync(kFull, r0, 1);
  const uint32_t prev1 = __shfl_up_sync(kFull, r1, 1);
  const bool head = lane == 0 || prev0 != r0 || prev1 != r1;
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads != kFull) {  // some run is longer than one lane
    const unsigned later = heads & (0xfffffffeu << lane);  // heads of the runs after
    const unsigned end = later ? __ffs(later) - 2 : 31;    // this run's last lane
#pragma unroll
    for (unsigned off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float o = __shfl_down_sync(kFull, v[i], off);
        if (lane + off <= end) v[i] += o;
      }
    }
  }
  return head;
}

// The x gradient's terms of corners c0 and c0 + 1: each corner's dot of
// the upstream gradient with its row times d weight / d frac, added into
// gpos in corner order.
template <int D>
__device__ __forceinline__ void add_pair_x_grad(float (&gpos)[D], const float frac[D], int c0,
                                                float dot0, float dot1) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gpos[d] = gpos[d] + dot0 * grid::corner_weight_grad<D>(frac, c0, d);
    gpos[d] = gpos[d] + dot1 * grid::corner_weight_grad<D>(frac, c0 + 1, d);
  }
}

// A point's x gradient: each level's share (gpos times d frac / d pos and
// d pos / d x = scale / (2 bound)) goes through shared memory xg [L][P][D],
// and the point's level-0 thread sums the shares in level order and stores
// grad_x (exact 0 outside the box), so the wrapper need not zero it. Every
// thread of the block calls it.
template <int D>
__device__ __forceinline__ void store_x_grad(float* __restrict__ xg, const float gpos[D],
                                             const float slope[D], float scale,
                                             float two_bound, bool live, int n, int N, int L,
                                             float* __restrict__ grad_x) {
  const int P = blockDim.x, l = threadIdx.y;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xg[(l * P + threadIdx.x) * D + d] = live ? gpos[d] * slope[d] * scale / two_bound : 0.0f;
  }
  __syncthreads();
  if (l == 0 && n < N) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float s = 0.0f;
      for (int k = 0; k < L; ++k) s = s + xg[(k * P + threadIdx.x) * D + d];
      grad_x[(size_t)n * D + d] = s;
    }
  }
}

// Adds the C values at v into table row r (float32 [n_emb, C]).
template <int C>
__device__ __forceinline__ void add_row(float* __restrict__ table, uint32_t r, const float* v) {
  float* dst = table + (size_t)r * C;
  if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else if constexpr (C >= 4) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
  }
}

// The pair's terms v = (row r0's C values, row r1's) summed over each run of
// lanes with the same rows, added by the run's first lane. Every lane of the
// warp calls it.
template <int C>
__device__ __forceinline__ void add_row_pair(float* __restrict__ table, uint32_t r0,
                                             uint32_t r1, float (&v)[2 * C], unsigned lane) {
  if (!merge_runs<2 * C>(r0, r1, v, lane) || r0 == kNoRow) return;
  if constexpr (C == 1) {
    if (grid::pair_aligned(r0, r1)) {
      atomicAdd(reinterpret_cast<float2*>(table + r0), make_float2(v[0], v[1]));
      return;
    }
  } else if constexpr (C == 2) {
    if (grid::pair_aligned(r0, r1)) {
      atomicAdd(reinterpret_cast<float4*>(table + 2 * (size_t)r0),
                make_float4(v[0], v[1], v[2], v[3]));
      return;
    }
  }
  add_row<C>(table, r0, v);
  add_row<C>(table, r1, v + C);
}

// Kernel A': a float32 table [n_emb, C] and grad_out [N, L * C].
// kSmooth: smoothstep interpolation; kHash: a grid with hashed levels;
// kNeedX: the x gradient too
template <int D, int C, bool kSmooth, bool kHash, bool kNeedX>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ emb,
    const float* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float* __restrict__ grad_table,
    float* __restrict__ grad_x, int N, int L, float shift, float bound, float two_bound) {
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D], slope[D];
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = 0.0f;
  if (live) {
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
    grid::load_row<C>(grad_out + ((size_t)n * L + l) * C, 0, g);
  }
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float v[2 * C];
#pragma unroll
    for (int i = 0; i < 2 * C; ++i) v[i] = 0.0f;
    if (live) {
      r0 = grid::corner_row<D, kHash>(lv, pg, c0);
      r1 = grid::corner_row<D, kHash>(lv, pg, c0 + 1);
      const float w0 = grid::corner_weight<D>(frac, c0);
      const float w1 = grid::corner_weight<D>(frac, c0 + 1);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = w0 * g[c];
        v[C + c] = w1 * g[c];
      }
      if (kNeedX) {
        float e0[C], e1[C];
        grid::load_row_pair<C>(emb, r0, r1, e0, e1);
        float dot0 = g[0] * e0[0], dot1 = g[0] * e1[0];
#pragma unroll
        for (int c = 1; c < C; ++c) {
          dot0 = dot0 + g[c] * e0[c];
          dot1 = dot1 + g[c] * e1[c];
        }
        add_pair_x_grad<D>(gpos, frac, c0, dot0, dot1);
      }
    }
    if (grad_table != nullptr) add_row_pair<C>(grad_table, r0, r1, v, lane);
  }

  if (kNeedX) store_x_grad<D>(xg, gpos, slope, lv.scale, two_bound, live, n, N, L, grad_x);
}

// Adds W float32 values at v into dst (aligned to 4W bytes) as one
// reduction.
template <int W>
__device__ __forceinline__ void add_unit(float* __restrict__ dst, const float* v) {
  if constexpr (W == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

// Kernel A' for any C up to kMaxChannels outside {1, 2, 4, 8}: C at run
// time, the channels a loop over units of W = unit_floats(C) floats; per
// corner pair and unit, the run's first lane adds each row's W values as
// one reduction (float4 at C = 12 or 16, float2 at C = 6, 10, 14, a float
// at odd C).
template <int D, int W, bool kSmooth, bool kHash, bool kNeedX>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel_any(
    const float* __restrict__ x, const float* __restrict__ emb,
    const float* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float* __restrict__ grad_table,
    float* __restrict__ grad_x, int N, int L, int C, float shift, float bound,
    float two_bound) {
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D], slope[D];
  if (live) grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
  const float* g_row = grad_out + ((size_t)n * L + l) * C;
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float w0 = 0.0f, w1 = 0.0f, dot0 = 0.0f, dot1 = 0.0f;
    if (live) {
      r0 = grid::corner_row<D, kHash>(lv, pg, c0);
      r1 = grid::corner_row<D, kHash>(lv, pg, c0 + 1);
      w0 = grid::corner_weight<D>(frac, c0);
      w1 = grid::corner_weight<D>(frac, c0 + 1);
    }
    for (int u = 0; u < C; u += W) {  // warp-uniform: every lane merges
      float g[W], v[2 * W];
#pragma unroll
      for (int i = 0; i < W; ++i) g[i] = 0.0f;
      if (live) grid::load_unit<W>(g_row + u, g);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        v[i] = w0 * g[i];
        v[W + i] = w1 * g[i];
      }
      if (kNeedX && live) {
        float e0[W], e1[W];
        grid::load_unit<W>(emb + (size_t)r0 * C + u, e0);
        grid::load_unit<W>(emb + (size_t)r1 * C + u, e1);
#pragma unroll
        for (int i = 0; i < W; ++i) {  // channels in order, as the twin sums them
          dot0 = u + i == 0 ? g[i] * e0[i] : dot0 + g[i] * e0[i];
          dot1 = u + i == 0 ? g[i] * e1[i] : dot1 + g[i] * e1[i];
        }
      }
      if (grad_table != nullptr && merge_runs<2 * W>(r0, r1, v, lane) && r0 != kNoRow) {
        add_unit<W>(grad_table + (size_t)r0 * C + u, v);
        add_unit<W>(grad_table + (size_t)r1 * C + u, v + W);
      }
    }
    if (kNeedX && live) {
      add_pair_x_grad<D>(gpos, frac, c0, dot0, dot1);
    }
  }

  if (kNeedX) store_x_grad<D>(xg, gpos, slope, lv.scale, two_bound, live, n, N, L, grad_x);
}

// The pair-keyed form (A'-bf16). A key holds the terms of a corner pair's
// rows r0 and r1 = r0 + 1 (mod the level's size) in units of W channels (W
// = 2 where C is even, 1 where it is odd): unit j is r0's W values of
// channels W j .. W j + W - 1, then r1's, so a key is 2C floats and a unit
// one float4 (W = 2) or float2 (W = 1) reduction: C = 1 one float2, C = 2
// one float4 (one a pair, whatever r0's parity), C = 4 two, C = 8 four.
// One float reduction a channel measured 3.9x slower than float4s in A' at
// C = 4 (PERF.md). The finish kernel then forms row r's gradient from key
// r's first halves and key r - 1's second halves.
template <int W>
__device__ __forceinline__ void add_key_unit(float* __restrict__ key, const float* v) {
  if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float4*>(key), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(key), make_float2(v[0], v[1]));
  }
}

// Kernel A'-bf16: a bf16 table [n_emb, C] and grad_out [N, L * C] (C in
// {1, 2, 4, 8}); the table gradient into the pair keys [n_emb, 2C] float32.
// kSmooth: smoothstep interpolation; the shift is 0.5, or 0 under
// align_corners.
template <int D, int C, bool kSmooth, bool kNeedX>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel_bf16(
    const float* __restrict__ x, const uint32_t* __restrict__ emb,
    const unsigned short* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float* __restrict__ keys,
    float* __restrict__ grad_x, int N, int L, float shift, float bound, float two_bound) {
  constexpr int W = C % 2 == 0 ? 2 : 1;  // channels a key unit
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D], slope[D];
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = 0.0f;
  if (live) {
    grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
    grid::load_bf16<C>(grad_out + ((size_t)n * L + l) * C, g);
  }
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float v[2 * C];  // in key order
#pragma unroll
    for (int i = 0; i < 2 * C; ++i) v[i] = 0.0f;
    if (live) {
      r0 = grid::corner_row<D, false>(lv, pg, c0);
      r1 = grid::corner_row<D, false>(lv, pg, c0 + 1);
      const float w0 = grid::round_bf16(grid::corner_weight<D>(frac, c0));
      const float w1 = grid::round_bf16(grid::corner_weight<D>(frac, c0 + 1));
#pragma unroll
      for (int j = 0; j < C / W; ++j) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          v[2 * W * j + i] = w0 * g[W * j + i];
          v[2 * W * j + W + i] = w1 * g[W * j + i];
        }
      }
      if (kNeedX) {
        float e0[C], e1[C];
        if constexpr (C == 2) {
          float2 a, b;
          grid::load_pair_bf16(emb, r0, r1, a, b);
          e0[0] = a.x, e0[1] = a.y, e1[0] = b.x, e1[1] = b.y;
        } else {
          const unsigned short* rows = reinterpret_cast<const unsigned short*>(emb);
          grid::load_bf16<C>(rows + (size_t)r0 * C, e0);
          grid::load_bf16<C>(rows + (size_t)r1 * C, e1);
        }
        float dot0 = g[0] * e0[0], dot1 = g[0] * e1[0];
#pragma unroll
        for (int c = 1; c < C; ++c) {
          dot0 = dot0 + g[c] * e0[c];
          dot1 = dot1 + g[c] * e1[c];
        }
        add_pair_x_grad<D>(gpos, frac, c0, dot0, dot1);
      }
    }
    if (keys != nullptr && merge_runs<2 * C>(r0, r0, v, lane) && r0 != kNoRow) {
#pragma unroll
      for (int j = 0; j < C / W; ++j) {
        add_key_unit<W>(keys + (size_t)r0 * (2 * C) + 2 * W * j, v + 2 * W * j);
      }
    }
  }

  if (kNeedX) store_x_grad<D>(xg, gpos, slope, lv.scale, two_bound, live, n, N, L, grad_x);
}

// Kernel A'-bf16 for any other C up to kMaxChannels: C at run time, the
// channels a loop over key units of W (2 where C is even, 1 where odd),
// each merged over the run and added as one reduction.
template <int D, int W, bool kSmooth, bool kNeedX>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel_bf16_any(
    const float* __restrict__ x, const unsigned short* __restrict__ emb,
    const unsigned short* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float* __restrict__ keys,
    float* __restrict__ grad_x, int N, int L, int C, float shift, float bound,
    float two_bound) {
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D], slope[D];
  if (live) grid::cell<D, kSmooth>(p, lv.scale, shift, pg, frac, slope);
  const unsigned short* g_row = grad_out + ((size_t)n * L + l) * C;
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float w0 = 0.0f, w1 = 0.0f, dot0 = 0.0f, dot1 = 0.0f;
    if (live) {
      r0 = grid::corner_row<D, false>(lv, pg, c0);
      r1 = grid::corner_row<D, false>(lv, pg, c0 + 1);
      w0 = grid::round_bf16(grid::corner_weight<D>(frac, c0));
      w1 = grid::round_bf16(grid::corner_weight<D>(frac, c0 + 1));
    }
    for (int u = 0; u < C; u += W) {  // warp-uniform: every lane merges
      float g[W], v[2 * W];
#pragma unroll
      for (int i = 0; i < W; ++i) g[i] = 0.0f;
      if (live) grid::load_bf16<W>(g_row + u, g);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        v[i] = w0 * g[i];
        v[W + i] = w1 * g[i];
      }
      if (kNeedX && live) {
        float e0[W], e1[W];
        grid::load_bf16<W>(emb + (size_t)r0 * C + u, e0);
        grid::load_bf16<W>(emb + (size_t)r1 * C + u, e1);
#pragma unroll
        for (int i = 0; i < W; ++i) {  // channels in order, as the twin sums them
          dot0 = u + i == 0 ? g[i] * e0[i] : dot0 + g[i] * e0[i];
          dot1 = u + i == 0 ? g[i] * e1[i] : dot1 + g[i] * e1[i];
        }
      }
      if (keys != nullptr && merge_runs<2 * W>(r0, r0, v, lane) && r0 != kNoRow) {
        add_key_unit<W>(keys + (size_t)r0 * (2 * C) + 2 * u, v);
      }
    }
    if (kNeedX && live) {
      add_pair_x_grad<D>(gpos, frac, c0, dot0, dot1);
    }
  }

  if (kNeedX) store_x_grad<D>(xg, gpos, slope, lv.scale, two_bound, live, n, N, L, grad_x);
}

// A point's x gradient on the general path, after each round of Y levels
// (every thread of the block calls it): each level's share (gpos times
// d frac / d pos and scale / (2 bound), 0 outside the box) is in its
// warp's gpos [Y][4][D][32] (the share at word 3 D 32 of the warp's
// cell), and warp 0 adds the round's shares, in level order, to its
// running sums [D][32] (from 0 at round 0: store_x_grad's order).
__device__ __forceinline__ void sum_round(const float* __restrict__ shares,
                                          float* __restrict__ sums, int D, int round, int Y,
                                          int L, bool keep) {
  __syncthreads();
  if (threadIdx.y == 0 && keep) {
    for (int d = 0; d < D; ++d) {
      float s = round == 0 ? 0.0f : sums[32 * d];
      for (int k = 0; k < Y && round * Y + k < L; ++k) s = s + shares[(4 * k * D + d) * 32];
      sums[32 * d] = s;
    }
  }
  __syncthreads();
}

// Kernels A' and A'-bf16 on the general path (any D, L and C;
// grid_common.cuh), on the table policy P: float32 table and grad_out, the
// table gradient added into grad_table [n_emb, C] per row pair; or bf16
// ones (tiled grids), the weights rounded to bf16, the table gradient added
// into the pair keys [n_emb, 2C] as grid_encode_bwd_kernel_bf16_any adds
// it. W channels a unit (float32: unit_floats(C); bf16: 2 where C is even,
// else 1); shared memory [Y][4][D][32] words (each warp's cell: corners,
// fractions, slopes, the level's x-gradient share) and the x gradient's
// running sums [D][32].
template <typename P, int W, bool kSmooth, bool kHash, bool kNeedX>
__global__ void __launch_bounds__(256) grid_encode_bwd_kernel_general(
    const float* __restrict__ x, const typename P::T* __restrict__ emb,
    const typename P::T* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float* __restrict__ grad_table,
    float* __restrict__ grad_x, int N, int D, int L, int C, float shift, float bound,
    float two_bound) {
  using T = typename P::T;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x, y = threadIdx.y, Y = blockDim.y;
  float* const base = reinterpret_cast<float*>(smem);
  uint32_t* const pg = reinterpret_cast<uint32_t*>(base) + 4 * y * D * 32 + lane;
  float* const frac = base + (4 * y + 1) * D * 32 + lane;
  float* const slope = frac + D * 32;
  float* const gpos = slope + D * 32;
  float* const sums = base + 4 * Y * D * 32 + lane;
  const int n = blockIdx.x * 32 + lane;
  const float* xn = x + (size_t)n * D;
  const bool live = n < N && grid::in_box(xn, D, bound, two_bound);

  const int rounds = (L + Y - 1) / Y;
  for (int r = 0; r < rounds; ++r) {
    const int l = r * Y + y;
    if (l < L) {  // warp-uniform: every lane merges
      const grid::LevelAny lv = grid::load_level_any(scales, level_params, l, D);
      if (live) grid::cell_any<kSmooth>(xn, D, bound, two_bound, lv.scale, shift, pg, frac, slope);
      if (kNeedX) {
        for (int d = 0; d < D; ++d) gpos[32 * d] = 0.0f;
      }
      const T* g_row = grad_out + ((size_t)n * L + l) * C;
      for (uint32_t c0 = 0; c0 < (1u << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
        uint32_t r0 = kNoRow, r1 = kNoRow;
        float w0 = 0.0f, w1 = 0.0f, dot0 = 0.0f, dot1 = 0.0f;
        if (live) {
          r0 = grid::corner_row_any<kHash>(lv, pg, D, c0);
          r1 = grid::corner_row_any<kHash>(lv, pg, D, c0 + 1);
          w0 = P::round(grid::corner_weight_any(frac, D, c0));
          w1 = P::round(grid::corner_weight_any(frac, D, c0 + 1));
        }
        for (int u = 0; u < C; u += W) {
          float g[W], v[2 * W];
#pragma unroll
          for (int i = 0; i < W; ++i) g[i] = 0.0f;
          if (live) P::template load<W>(g_row + u, g);
#pragma unroll
          for (int i = 0; i < W; ++i) {
            v[i] = w0 * g[i];
            v[W + i] = w1 * g[i];
          }
          if (kNeedX && live) {
            float e0[W], e1[W];
            P::template load<W>(emb + (size_t)r0 * C + u, e0);
            P::template load<W>(emb + (size_t)r1 * C + u, e1);
#pragma unroll
            for (int i = 0; i < W; ++i) {  // channels in order, as the twin sums them
              dot0 = u + i == 0 ? g[i] * e0[i] : dot0 + g[i] * e0[i];
              dot1 = u + i == 0 ? g[i] * e1[i] : dot1 + g[i] * e1[i];
            }
          }
          if constexpr (P::kPacked) {  // the pair keyed r0: r0's unit, then r1's
            if (grad_table != nullptr && merge_runs<2 * W>(r0, r0, v, lane) && r0 != kNoRow) {
              add_key_unit<W>(grad_table + (size_t)r0 * (2 * C) + 2 * u, v);
            }
          } else if (grad_table != nullptr && merge_runs<2 * W>(r0, r1, v, lane) &&
                     r0 != kNoRow) {
            add_unit<W>(grad_table + (size_t)r0 * C + u, v);
            add_unit<W>(grad_table + (size_t)r1 * C + u, v + W);
          }
        }
        if (kNeedX && live) {  // add_pair_x_grad's order
          for (int d = 0; d < D; ++d) {
            gpos[32 * d] = gpos[32 * d] + dot0 * grid::corner_weight_grad_any(frac, D, c0, d);
            gpos[32 * d] = gpos[32 * d] + dot1 * grid::corner_weight_grad_any(frac, D, c0 + 1, d);
          }
        }
      }
      if (kNeedX) {
        for (int d = 0; d < D; ++d) {
          gpos[32 * d] = live ? gpos[32 * d] * slope[32 * d] * lv.scale / two_bound : 0.0f;
        }
      }
    }
    if (kNeedX) sum_round(base + 3 * D * 32 + lane, sums, D, r, Y, L, n < N);
  }
  if (kNeedX && y == 0 && n < N) {
    for (int d = 0; d < D; ++d) grad_x[(size_t)n * D + d] = sums[32 * d];
  }
}

// grad_table[offset + r] for every row r of level l = blockIdx.y: row r's
// unit j (W channels) is key r's unit j first half (corner 2q's row of the
// pair keyed r) plus key r - 1's unit j second half (corner 2q + 1's of the
// pair keyed r - 1, mod the level's size; a dense level's last key is never
// written, so its row 0 adds a zero); a thread forms one (row, unit).
template <int W>
__global__ void grid_encode_bwd_finish_kernel(const float* __restrict__ keys,
                                              const int* __restrict__ params, int param_stride,
                                              int C, float* __restrict__ grad_table) {
  const int* p = params + blockIdx.y * param_stride;
  const uint32_t offset = (uint32_t)p[0], size = (uint32_t)p[1];
  const uint32_t units = (uint32_t)(C / W);
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < size * units;
       i += gridDim.x * blockDim.x) {
    const uint32_t r = i / units, j = i - r * units;
    const float* a = keys + (size_t)(offset + r) * (2 * C) + 2 * W * j;
    const float* b = keys + (size_t)(offset + (r == 0 ? size - 1 : r - 1)) * (2 * C) + 2 * W * j;
    float* dst = grad_table + (size_t)(offset + r) * C + W * j;
    if constexpr (W == 2) {
      const float4 ka = *reinterpret_cast<const float4*>(a);
      const float4 kb = *reinterpret_cast<const float4*>(b);
      *reinterpret_cast<float2*>(dst) = make_float2(ka.x + kb.z, ka.y + kb.w);
    } else {
      const float2 ka = *reinterpret_cast<const float2*>(a);
      const float2 kb = *reinterpret_cast<const float2*>(b);
      dst[0] = ka.x + kb.y;
    }
  }
}

// a block of P points x L levels, at most 1024 threads
int points_a_block(int L) { return L <= 16 ? 64 : 32; }

template <int D, int C, bool kSmooth, bool kHash>
int launch(const void* x, const void* emb, const void* grad_out, const void* scales,
           const void* params, void* grad_table, void* grad_x, int N, int L, float shift,
           float bound, float two_bound, cudaStream_t s) {
  const int P = points_a_block(L);
  const dim3 blocks((N + P - 1) / P), block(P, L);
  if (grad_x != nullptr) {
    grid_encode_bwd_kernel<D, C, kSmooth, kHash, true><<<blocks, block, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)grad_out, (const float*)scales,
        (const int*)params, (float*)grad_table, (float*)grad_x, N, L, shift, bound, two_bound);
  } else {
    grid_encode_bwd_kernel<D, C, kSmooth, kHash, false><<<blocks, block, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)grad_out, (const float*)scales,
        (const int*)params, (float*)grad_table, (float*)grad_x, N, L, shift, bound, two_bound);
  }
  return (int)cudaGetLastError();
}

template <int D, int C>
int launch(const void* x, const void* emb, const void* grad_out, const void* scales,
           const void* params, void* grad_table, void* grad_x, int N, int L, int smoothstep,
           int hashed, float shift, float bound, float two_bound, cudaStream_t s) {
#define GRID_BWD(SMOOTH, HASH)                                                               \
  launch<D, C, SMOOTH, HASH>(x, emb, grad_out, scales, params, grad_table, grad_x, N, L, shift, \
                             bound, two_bound, s)
  if (smoothstep) return hashed ? GRID_BWD(true, true) : GRID_BWD(true, false);
  return hashed ? GRID_BWD(false, true) : GRID_BWD(false, false);
#undef GRID_BWD
}

template <int D, int W, bool kSmooth, bool kHash>
int launch_any(const void* x, const void* emb, const void* grad_out, const void* scales,
               const void* params, void* grad_table, void* grad_x, int N, int L, int C,
               float shift, float bound, float two_bound, cudaStream_t s) {
  const int P = points_a_block(L);
  const dim3 blocks((N + P - 1) / P), block(P, L);
#define GRID_BWD_ANY(NEED_X)                                                                \
  grid_encode_bwd_kernel_any<D, W, kSmooth, kHash, NEED_X><<<blocks, block, 0, s>>>(        \
      (const float*)x, (const float*)emb, (const float*)grad_out, (const float*)scales,     \
      (const int*)params, (float*)grad_table, (float*)grad_x, N, L, C, shift, bound,        \
      two_bound)
  if (grad_x != nullptr) GRID_BWD_ANY(true); else GRID_BWD_ANY(false);
#undef GRID_BWD_ANY
  return (int)cudaGetLastError();
}

template <int D, int W>
int launch_any(const void* x, const void* emb, const void* grad_out, const void* scales,
               const void* params, void* grad_table, void* grad_x, int N, int L, int C,
               int smoothstep, int hashed, float shift, float bound, float two_bound,
               cudaStream_t s) {
#define GRID_BWD(SMOOTH, HASH)                                                              \
  launch_any<D, W, SMOOTH, HASH>(x, emb, grad_out, scales, params, grad_table, grad_x, N, L, \
                                 C, shift, bound, two_bound, s)
  if (smoothstep) return hashed ? GRID_BWD(true, true) : GRID_BWD(true, false);
  return hashed ? GRID_BWD(false, true) : GRID_BWD(false, false);
#undef GRID_BWD
}

template <int D>
int backward(const void* x, const void* emb, const void* grad_out, const void* scales,
             const void* params, void* grad_table, void* grad_x, int N, int L, int C,
             int smoothstep, int hashed, float shift, float bound, float two_bound,
             cudaStream_t s) {
#define GRID_BWD(CH)                                                                        \
  launch<D, CH>(x, emb, grad_out, scales, params, grad_table, grad_x, N, L, smoothstep,    \
                hashed, shift, bound, two_bound, s)
#define GRID_BWD_ANY(W)                                                                     \
  launch_any<D, W>(x, emb, grad_out, scales, params, grad_table, grad_x, N, L, C,          \
                   smoothstep, hashed, shift, bound, two_bound, s)
  switch (C) {
    case 1: return GRID_BWD(1);
    case 2: return GRID_BWD(2);
    case 4: return GRID_BWD(4);
    case 8: return GRID_BWD(8);
    default:
      switch (grid::unit_floats(C)) {
        case 4: return GRID_BWD_ANY(4);
        case 2: return GRID_BWD_ANY(2);
        default: return GRID_BWD_ANY(1);
      }
  }
#undef GRID_BWD
#undef GRID_BWD_ANY
}

template <int D, bool kSmooth, bool kNeedX>
void launch_bf16(const void* x, const void* emb, const void* grad_out, const void* scales,
                 const void* params, void* keys, void* grad_x, int N, int L, int C, float shift,
                 float bound, float two_bound, cudaStream_t s) {
  const int P = points_a_block(L);
  const dim3 blocks((N + P - 1) / P), block(P, L);
#define GRID_BWD_BF16(CH)                                                                    \
  grid_encode_bwd_kernel_bf16<D, CH, kSmooth, kNeedX><<<blocks, block, 0, s>>>(              \
      (const float*)x, (const uint32_t*)emb, (const unsigned short*)grad_out,                \
      (const float*)scales, (const int*)params, (float*)keys, (float*)grad_x, N, L, shift,   \
      bound, two_bound)
#define GRID_BWD_BF16_ANY(W)                                                                 \
  grid_encode_bwd_kernel_bf16_any<D, W, kSmooth, kNeedX><<<blocks, block, 0, s>>>(           \
      (const float*)x, (const unsigned short*)emb, (const unsigned short*)grad_out,          \
      (const float*)scales, (const int*)params, (float*)keys, (float*)grad_x, N, L, C,       \
      shift, bound, two_bound)
  switch (C) {
    case 1: GRID_BWD_BF16(1); break;
    case 2: GRID_BWD_BF16(2); break;
    case 4: GRID_BWD_BF16(4); break;
    case 8: GRID_BWD_BF16(8); break;
    default:
      if (C % 2 == 0) GRID_BWD_BF16_ANY(2); else GRID_BWD_BF16_ANY(1);
  }
#undef GRID_BWD_BF16
#undef GRID_BWD_BF16_ANY
}

template <int D>
void launch_bf16(const void* x, const void* emb, const void* grad_out, const void* scales,
                 const void* params, void* keys, void* grad_x, int N, int L, int C,
                 int smoothstep, float shift, float bound, float two_bound, cudaStream_t s) {
#define GRID_BWD_BF16(SMOOTH, NEED_X)                                                        \
  launch_bf16<D, SMOOTH, NEED_X>(x, emb, grad_out, scales, params, keys, grad_x, N, L, C,    \
                                 shift, bound, two_bound, s)
  if (smoothstep) {
    if (grad_x != nullptr) GRID_BWD_BF16(true, true); else GRID_BWD_BF16(true, false);
  } else {
    if (grad_x != nullptr) GRID_BWD_BF16(false, true); else GRID_BWD_BF16(false, false);
  }
#undef GRID_BWD_BF16
}

// a general-path backward (T: the table's and grad_out's element; out:
// grad_table or the keys): shared memory [Y][4][D][32] + [D][32] words
template <typename T>
int launch_general(void (*kernel)(const float*, const T*, const T*, const float*, const int*,
                                  float*, float*, int, int, int, int, float, float, float),
                   const void* x, const void* emb, const void* grad_out, const void* scales,
                   const void* params, void* out, void* grad_x, int N, int D, int L, int C,
                   float shift, float bound, float two_bound, cudaStream_t s) {
  const size_t per_warp = sizeof(float) * 4 * 32 * (size_t)D;
  const size_t fixed = sizeof(float) * 32 * (size_t)D;
  const int Y = grid::general_warps(L, per_warp, fixed);
  const size_t smem = fixed + Y * per_warp;
  const int err = grid::allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<(N + 31) / 32, dim3(32, Y), smem, s>>>(
      (const float*)x, (const T*)emb, (const T*)grad_out, (const float*)scales,
      (const int*)params, (float*)out, (float*)grad_x, N, D, L, C, shift, bound, two_bound);
  return (int)cudaGetLastError();
}

int backward_general(const void* x, const void* emb, const void* grad_out, const void* scales,
                     const void* params, void* grad_table, void* grad_x, int N, int D, int L,
                     int C, int smoothstep, int hashed, float shift, float bound,
                     float two_bound, cudaStream_t s) {
#define GRID_BWD(W, SMOOTH, HASH, NEED_X)                                                       \
  launch_general<float>(grid_encode_bwd_kernel_general<grid::F32Table, W, SMOOTH, HASH, NEED_X>, \
                        x, emb, grad_out, scales, params, grad_table, grad_x, N, D, L, C, shift, \
                        bound, two_bound, s)
#define GRID_BWD_X(W, SMOOTH, HASH)                                                             \
  (grad_x != nullptr ? GRID_BWD(W, SMOOTH, HASH, true) : GRID_BWD(W, SMOOTH, HASH, false))
#define GRID_BWD_W(W)                                                                           \
  if (smoothstep) return hashed ? GRID_BWD_X(W, true, true) : GRID_BWD_X(W, true, false);      \
  return hashed ? GRID_BWD_X(W, false, true) : GRID_BWD_X(W, false, false)
  switch (grid::unit_floats(C)) {
    case 4: GRID_BWD_W(4);
    case 2: GRID_BWD_W(2);
    default: GRID_BWD_W(1);
  }
#undef GRID_BWD_W
#undef GRID_BWD_X
#undef GRID_BWD
}

int backward_general_bf16(const void* x, const void* emb, const void* grad_out,
                          const void* scales, const void* params, void* keys, void* grad_x,
                          int N, int D, int L, int C, int smoothstep, float shift, float bound,
                          float two_bound, cudaStream_t s) {
#define GRID_BWD_BF16(W, SMOOTH, NEED_X)                                                        \
  launch_general<unsigned short>(                                                               \
      grid_encode_bwd_kernel_general<grid::Bf16Table, W, SMOOTH, false, NEED_X>, x, emb,        \
      grad_out, scales, params, keys, grad_x, N, D, L, C, shift, bound, two_bound, s)
#define GRID_BWD_BF16_X(W, SMOOTH)                                                              \
  (grad_x != nullptr ? GRID_BWD_BF16(W, SMOOTH, true) : GRID_BWD_BF16(W, SMOOTH, false))
#define GRID_BWD_BF16_W(W)                                                                      \
  return smoothstep ? GRID_BWD_BF16_X(W, true) : GRID_BWD_BF16_X(W, false)
  if (C % 2 == 0) GRID_BWD_BF16_W(2);
  GRID_BWD_BF16_W(1);
#undef GRID_BWD_BF16_W
#undef GRID_BWD_BF16_X
#undef GRID_BWD_BF16
}

bool bad_shape(long long N, int D, int L, int C) {
  return grid::bad_shape(D, L, C) || N < 1 || N > 0x7fffffffLL;
}

}  // namespace

// kernel A': a float32 table [n_emb, C] and grad_out [N, L * C], the level
// rows, smoothstep 0 or 1, hashed 1 where a level may be hashed (a hash
// grid), the shift (0.5, or 0 under align_corners); grad_table (zeroed by
// the caller) or grad_x may be null
extern "C" int grid_encode_bwd(const void* x, const void* emb, const void* grad_out,
                               const void* scales, const void* level_params, void* grad_table,
                               void* grad_x, long long N, int D, int L, int C, int smoothstep,
                               int hashed, float shift, float bound, float two_bound,
                               void* stream) {
  if (bad_shape(N, D, L, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (grid::general_shape(D, L, C)) {
    return backward_general(x, emb, grad_out, scales, level_params, grad_table, grad_x, (int)N,
                            D, L, C, smoothstep, hashed, shift, bound, two_bound, s);
  }
  return D == 3 ? backward<3>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                              (int)N, L, C, smoothstep, hashed, shift, bound, two_bound, s)
                : backward<2>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                              (int)N, L, C, smoothstep, hashed, shift, bound, two_bound, s);
}

// A'-bf16: bf16 table [n_emb, C] and bf16 grad_out [N, L * C], smoothstep
// 0 or 1, the shift (0.5, or 0 under align_corners); float32
// gradients. The table gradient goes through keys [n_emb, 2C] float32,
// zeroed by the caller; grad_table (and keys) may be null when that
// gradient is not needed.
extern "C" int grid_encode_bwd_bf16_keyed(const void* x, const void* emb, const void* grad_out,
                                          const void* scales, const void* level_params,
                                          void* keys, void* grad_table, void* grad_x,
                                          long long N, int D, int L, int C, int smoothstep,
                                          float shift, float bound, float two_bound,
                                          void* stream) {
  if ((keys == nullptr) != (grad_table == nullptr) || bad_shape(N, D, L, C)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (grid::general_shape(D, L, C)) {
    const int err = backward_general_bf16(x, emb, grad_out, scales, level_params, keys, grad_x,
                                          (int)N, D, L, C, smoothstep, shift, bound, two_bound,
                                          s);
    if (err != 0) return err;
  } else if (D == 3) {
    launch_bf16<3>(x, emb, grad_out, scales, level_params, keys, grad_x, (int)N, L, C,
                   smoothstep, shift, bound, two_bound, s);
  } else {
    launch_bf16<2>(x, emb, grad_out, scales, level_params, keys, grad_x, (int)N, L, C,
                   smoothstep, shift, bound, two_bound, s);
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || grad_table == nullptr) return err;
  const dim3 grid(264, L);
  if (C % 2 == 0) {
    grid_encode_bwd_finish_kernel<2><<<grid, 256, 0, s>>>(
        (const float*)keys, (const int*)level_params, 2 + D, C, (float*)grad_table);
  } else {
    grid_encode_bwd_finish_kernel<1><<<grid, 256, 0, s>>>(
        (const float*)keys, (const int*)level_params, 2 + D, C, (float*)grad_table);
  }
  return (int)cudaGetLastError();
}
