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
// 3.9x slower at C = 4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Every
// level adds into global memory: on the step's own points a per-block sum
// of the coarse levels in shared memory is slower (PERF.md). Under smoothstep the x gradient takes
// d frac / d pos = 6 f (1 - f) of each dim's cell fraction f.
//
// The x gradient needs no atomics: each level's share goes through shared
// memory, and the point's level-0 thread sums them in level order and
// stores grad_x (exact 0 outside the box), so the wrapper need not zero it.
//
// The bf16 variant (grid_encode_bwd_bf16_keyed, the gradient of the -O
// policy's bf16 encode; C = 2 tiled linear grids) takes a bf16 table and a
// bf16 grad_out [N, 2L] (4 bytes a (point, level) instead of 8); it writes
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
// stride is 1), and grid_encode_bwd_finish_kernel stores row r's gradient
// keys[r].xy + keys[r - 1].zw: 53.7M reductions and 0.684 ms on that call,
// 0.317 ms against 0.532 on the D = 2 one (the x gradient 0.216 of it).

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
#pragma unroll
        for (int d = 0; d < D; ++d) {
          gpos[d] = gpos[d] + dot0 * grid::corner_weight_grad<D>(frac, c0, d);
          gpos[d] = gpos[d] + dot1 * grid::corner_weight_grad<D>(frac, c0 + 1, d);
        }
      }
    }
    if (grad_table != nullptr) add_row_pair<C>(grad_table, r0, r1, v, lane);
  }

  if (kNeedX) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xg[(l * P + threadIdx.x) * D + d] =
          live ? gpos[d] * slope[d] * lv.scale / two_bound : 0.0f;
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
}

// The pair-keyed form (A'-bf16): v, the terms of rows r0 and r1 = r0 + 1
// (mod the level's size), goes whole into keys[r0], one float4 atomic a run
// of lanes with the same r0 whatever r0's parity; the finish kernel then
// forms row r's gradient from keys[r].xy and keys[r - 1].zw.
__device__ __forceinline__ void add_keyed(float4* __restrict__ keys, uint32_t r0,
                                          float (&v)[4], unsigned lane) {
  if (!merge_runs<4>(r0, r0, v, lane) || r0 == kNoRow) return;
  atomicAdd(keys + r0, make_float4(v[0], v[1], v[2], v[3]));
}

// Kernel A'-bf16: a bf16 table [n_emb] bf16x2 and grad_out [N, L] bf16x2;
// the table gradient into the pair keys [n_emb] float4.
template <int D, bool kNeedX>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel_bf16(
    const float* __restrict__ x, const uint32_t* __restrict__ emb,
    const uint32_t* __restrict__ grad_out, const float* __restrict__ scales,
    const int* __restrict__ level_params, float4* __restrict__ keys,
    float* __restrict__ grad_x, int N, int L, float bound, float two_bound) {
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D], slope[D];
  float2 g = make_float2(0.0f, 0.0f);
  if (live) {
    grid::cell<D, false>(p, lv.scale, 0.5f, pg, frac, slope);
    g = grid::Bf16::load(grad_out + (size_t)n * L + l);
  }
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      r0 = grid::corner_row<D, false>(lv, pg, c0);
      r1 = grid::corner_row<D, false>(lv, pg, c0 + 1);
      const float w0 = grid::round_bf16(grid::corner_weight<D>(frac, c0));
      const float w1 = grid::round_bf16(grid::corner_weight<D>(frac, c0 + 1));
      v[0] = w0 * g.x;
      v[1] = w0 * g.y;
      v[2] = w1 * g.x;
      v[3] = w1 * g.y;
      if (kNeedX) {
        float2 e0, e1;
        grid::load_pair_bf16(emb, r0, r1, e0, e1);
        const float dot0 = g.x * e0.x + g.y * e0.y;
        const float dot1 = g.x * e1.x + g.y * e1.y;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          gpos[d] = gpos[d] + dot0 * grid::corner_weight_grad<D>(frac, c0, d);
          gpos[d] = gpos[d] + dot1 * grid::corner_weight_grad<D>(frac, c0 + 1, d);
        }
      }
    }
    if (keys != nullptr) add_keyed(keys, r0, v, lane);
  }

  if (kNeedX) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xg[(l * P + threadIdx.x) * D + d] = live ? gpos[d] * lv.scale / two_bound : 0.0f;
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
}

// grad_table[offset + r] = keys[offset + r].xy + keys[offset + (r - 1) mod
// size].zw for every row r of level l = blockIdx.y: row r is corner 2q's row
// of the pair keyed r and corner 2q + 1's of the pair keyed r - 1 (a dense
// level's last key is never written, so its row 0 adds a zero)
__global__ void grid_encode_bwd_finish_kernel(const float4* __restrict__ keys,
                                              const int* __restrict__ params, int param_stride,
                                              float2* __restrict__ grad_table) {
  const int* p = params + blockIdx.y * param_stride;
  const uint32_t offset = (uint32_t)p[0], size = (uint32_t)p[1];
  for (uint32_t r = blockIdx.x * blockDim.x + threadIdx.x; r < size;
       r += gridDim.x * blockDim.x) {
    const float4 a = keys[offset + r];
    const float4 b = keys[offset + (r == 0 ? size - 1 : r - 1)];
    grad_table[offset + r] = make_float2(a.x + b.z, a.y + b.w);
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

template <int D>
int backward(const void* x, const void* emb, const void* grad_out, const void* scales,
             const void* params, void* grad_table, void* grad_x, int N, int L, int C,
             int smoothstep, int hashed, float shift, float bound, float two_bound,
             cudaStream_t s) {
#define GRID_BWD(CH)                                                                        \
  launch<D, CH>(x, emb, grad_out, scales, params, grad_table, grad_x, N, L, smoothstep,    \
                hashed, shift, bound, two_bound, s)
  switch (C) {
    case 1: return GRID_BWD(1);
    case 2: return GRID_BWD(2);
    case 4: return GRID_BWD(4);
    case 8: return GRID_BWD(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRID_BWD
}

template <int D, bool kNeedX>
void launch_bf16(const void* x, const void* emb, const void* grad_out, const void* scales,
                 const void* params, void* keys, void* grad_x, int N, int L, float bound,
                 float two_bound, cudaStream_t s) {
  const int P = points_a_block(L);
  grid_encode_bwd_kernel_bf16<D, kNeedX><<<(N + P - 1) / P, dim3(P, L), 0, s>>>(
      (const float*)x, (const uint32_t*)emb, (const uint32_t*)grad_out, (const float*)scales,
      (const int*)params, (float4*)keys, (float*)grad_x, N, L, bound, two_bound);
}

bool bad_shape(long long N, int D, int L) {
  return (D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 1 || N > 0x7fffffffLL;
}

}  // namespace

// kernel A': a float32 table [n_emb, C] and grad_out [N, L * C], C in {1,
// 2, 4, 8}, the level rows, smoothstep 0 or 1, hashed 1 where a level may
// be hashed (a hash grid), the shift (0.5, or 0 under align_corners);
// grad_table (zeroed by the caller) or grad_x may be null
extern "C" int grid_encode_bwd(const void* x, const void* emb, const void* grad_out,
                               const void* scales, const void* level_params, void* grad_table,
                               void* grad_x, long long N, int D, int L, int C, int smoothstep,
                               int hashed, float shift, float bound, float two_bound,
                               void* stream) {
  if (bad_shape(N, D, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 3 ? backward<3>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                              (int)N, L, C, smoothstep, hashed, shift, bound, two_bound, s)
                : backward<2>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                              (int)N, L, C, smoothstep, hashed, shift, bound, two_bound, s);
}

// A'-bf16: bf16 table [n_emb, 2] and bf16 grad_out [N, 2L]; float32
// gradients. The table gradient goes through keys [n_emb] float4, zeroed by
// the caller; grad_table (and keys) may be null when that gradient is not
// needed.
extern "C" int grid_encode_bwd_bf16_keyed(const void* x, const void* emb, const void* grad_out,
                                          const void* scales, const void* level_params,
                                          void* keys, void* grad_table, void* grad_x,
                                          long long N, int D, int L, float bound,
                                          float two_bound, void* stream) {
  if ((keys == nullptr) != (grad_table == nullptr) || bad_shape(N, D, L)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
#define GRID_BWD_BF16(DIM, NEED_X)                                                          \
  launch_bf16<DIM, NEED_X>(x, emb, grad_out, scales, level_params, keys, grad_x, n, L,     \
                           bound, two_bound, s)
  if (D == 3) {
    if (grad_x != nullptr) GRID_BWD_BF16(3, true); else GRID_BWD_BF16(3, false);
  } else {
    if (grad_x != nullptr) GRID_BWD_BF16(2, true); else GRID_BWD_BF16(2, false);
  }
#undef GRID_BWD_BF16
  int err = (int)cudaGetLastError();
  if (err != 0 || grad_table == nullptr) return err;
  grid_encode_bwd_finish_kernel<<<dim3(264, L), 256, 0, s>>>(
      (const float4*)keys, (const int*)level_params, 2 + D, (float2*)grad_table);
  return (int)cudaGetLastError();
}
