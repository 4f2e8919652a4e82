// Kernel A': multiresolution tiled grid encoder, backward.
//
// Replaces the gradient of radnerf_tpu/ops/grid_encode.py: grid_encode01
// (:168-216), which JAX takes by autodiff: XLA transposes the corner
// gathers into a scatter-add over the [n_emb, 2] table, and the position
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
// contention. Each (point, level) adds 2^D rows of 2 floats; the coarse
// levels are small (4,920 rows at the 3-D level 0, 296 at the 2-D one) and
// every sample hits them, and while the field is untrained the ambient MLP
// sends every sample of a step into the same 2-D cells at every level, so
// the adds serialise on a few L2 addresses. Design (grid_common.cuh): a
// block is P points x L levels and each warp is 32 consecutive points at
// one level. The corners go in pairs that differ in dim 0 (adjacent rows).
// Per pair, lanes whose rows equal the lane before's (the march writes
// samples ray by ray, so contention comes as runs) sum their values with a
// segmented shuffle reduction, and the run's first lane alone adds them: as
// one float4 atomic when the two rows are an aligned 16-byte pair, else as
// two float2 atomics (vector atomics in global memory: compute capability
// 9.x). Every level adds into global memory: on the step's own points a
// per-block sum of the coarse levels in shared memory is slower (PERF.md).
// The x gradient needs no atomics: each level's share goes through shared
// memory, and the point's level-0 thread sums them in level order and
// stores grad_x (exact 0 outside the box), so the wrapper need not zero it.
//
// The bf16 variant (grid_encode_bwd_bf16_keyed, the gradient of the -O
// policy's bf16 encode) is the same template on a bf16 table and a bf16
// grad_out [N, 2L] (4 bytes a (point, level) instead of 8); it writes
// float32 gradients, the table's through float32 atomics. Its corner
// weights are rounded to bf16 as in the forward, so each added term
// bf16(w) * g is exact in float32; the x gradient treats that rounding as
// the identity, as autodiff treats a cast. JAX instead rounds each term to
// bf16 and scatter-adds into a bf16 table: the port's sum is the more
// exact one, a deliberate difference (ops/grid_encode.py).
//
// What bounds A'-bf16 on an H100 80GB HBM3 (700 W; studies/grid_bf16.py,
// PERF.md §6): the global reductions it issues. With the row-pair adds
// above, the -O step's D = 3 call issued 80.6M of them into 575,422 rows
// and took 1.136 ms of device time, its reductions replayed alone 1.058;
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

#include <type_traits>

#include "grid_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add

// Sums v over each run of lanes of the warp whose rows (r0, r1) equal the
// lane before's (the march writes samples ray by ray, so equal rows come as
// runs); returns true on the run's first lane, whose v then holds the run's
// sum. Every lane of the warp calls it.
__device__ __forceinline__ bool merge_runs(uint32_t r0, uint32_t r1, float4& v, unsigned lane) {
  const uint32_t prev0 = __shfl_up_sync(kFull, r0, 1);
  const uint32_t prev1 = __shfl_up_sync(kFull, r1, 1);
  const bool head = lane == 0 || prev0 != r0 || prev1 != r1;
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads != kFull) {  // some run is longer than one lane
    const unsigned later = heads & (0xfffffffeu << lane);  // heads of the runs after
    const unsigned end = later ? __ffs(later) - 2 : 31;    // this run's last lane
#pragma unroll
    for (unsigned off = 1; off < 32; off <<= 1) {
      const float ox = __shfl_down_sync(kFull, v.x, off);
      const float oy = __shfl_down_sync(kFull, v.y, off);
      const float oz = __shfl_down_sync(kFull, v.z, off);
      const float ow = __shfl_down_sync(kFull, v.w, off);
      if (lane + off <= end) {
        v.x += ox;
        v.y += oy;
        v.z += oz;
        v.w += ow;
      }
    }
  }
  return head;
}

// Adds v.xy into row r0 and v.zw into row r1 of the table gradient (the
// rows of corners 2q and 2q + 1), summed first over each run of lanes with
// the same rows; the run's first lane issues the adds, as one float4 atomic
// when the rows are an aligned pair, else two float2 atomics. Every lane of
// the warp calls it.
__device__ __forceinline__ void add_pair(float2* __restrict__ table, uint32_t r0, uint32_t r1,
                                         float4 v, unsigned lane) {
  if (!merge_runs(r0, r1, v, lane) || r0 == kNoRow) return;
  if (grid::pair_aligned(r0, r1)) {
    atomicAdd(reinterpret_cast<float4*>(table + r0), v);
  } else {
    atomicAdd(table + r0, make_float2(v.x, v.y));
    atomicAdd(table + r1, make_float2(v.z, v.w));
  }
}

// The pair-keyed form (A'-bf16): v, the terms of rows r0 and r1 = r0 + 1
// (mod the level's size), goes whole into keys[r0], one float4 atomic a run
// of lanes with the same r0 whatever r0's parity; finish_pairs_kernel then
// forms row r's gradient from keys[r].xy and keys[r - 1].zw.
__device__ __forceinline__ void add_keyed(float4* __restrict__ keys, uint32_t r0, float4 v,
                                          unsigned lane) {
  if (!merge_runs(r0, r0, v, lane) || r0 == kNoRow) return;
  atomicAdd(keys + r0, v);
}

template <int D, bool kNeedX, typename T>
__global__ void __launch_bounds__(1024) grid_encode_bwd_kernel(
    const float* __restrict__ x, const typename grid::Table<T>::Row* __restrict__ emb,
    const typename grid::Table<T>::Out* __restrict__ grad_out,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    void* __restrict__ grad_table, float* __restrict__ grad_x, int N, int L, float bound,
    float two_bound) {
  using Tab = grid::Table<T>;
  // A'-bf16 adds into the pair keys [n_emb] float4, A into the rows [n_emb] float2
  constexpr bool kKeyed = std::is_same<T, __nv_bfloat16>::value;
  __shared__ float xg[kNeedX ? 1024 * D : 1];  // [L][P][D], P * L <= 1024
  const int P = blockDim.x, l = threadIdx.y;
  const unsigned lane = threadIdx.x & 31u;
  const int n = blockIdx.x * P + threadIdx.x;

  const grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float p[D];
  const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
  uint32_t pg[D];
  float frac[D];
  float2 g = make_float2(0.0f, 0.0f);
  if (live) {
    grid::cell<D>(p, lv.scale, pg, frac);
    g = Tab::load_out(grad_out + (size_t)n * L + l);
  }
  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < (1 << D); c0 += 2) {  // corners c0, c0 + 1: one row pair
    uint32_t r0 = kNoRow, r1 = kNoRow;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) {
      r0 = grid::corner_row<D>(lv, pg, c0);
      r1 = grid::corner_row<D>(lv, pg, c0 + 1);
      const float w0 = Tab::weight(grid::corner_weight<D>(frac, c0));
      const float w1 = Tab::weight(grid::corner_weight<D>(frac, c0 + 1));
      v = make_float4(w0 * g.x, w0 * g.y, w1 * g.x, w1 * g.y);
      if (kNeedX) {
        float2 e0, e1;
        grid::load_pair<T>(emb, r0, r1, e0, e1);
        const float dot0 = g.x * e0.x + g.y * e0.y;
        const float dot1 = g.x * e1.x + g.y * e1.y;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          gpos[d] = gpos[d] + dot0 * grid::corner_weight_grad<D>(frac, c0, d);
          gpos[d] = gpos[d] + dot1 * grid::corner_weight_grad<D>(frac, c0 + 1, d);
        }
      }
    }
    if (grad_table != nullptr) {
      if constexpr (kKeyed) {
        add_keyed(static_cast<float4*>(grad_table), r0, v, lane);
      } else {
        add_pair(static_cast<float2*>(grad_table), r0, r1, v, lane);
      }
    }
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

template <int D, bool kNeedX, typename T>
int launch(const void* x, const void* emb, const void* grad_out, const void* scales,
           const void* level_params, void* grad_table, void* grad_x, int N, int L,
           float bound, float two_bound, cudaStream_t s) {
  using Tab = grid::Table<T>;
  const int P = L <= 16 ? 64 : 32;  // a block of at most 1024 threads
  grid_encode_bwd_kernel<D, kNeedX, T><<<(N + P - 1) / P, dim3(P, L), 0, s>>>(
      (const float*)x, (const typename Tab::Row*)emb, (const typename Tab::Out*)grad_out,
      (const float*)scales, (const int*)level_params, grad_table, (float*)grad_x, N, L, bound,
      two_bound);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* emb, const void* grad_out, const void* scales,
             const void* level_params, void* grad_table, void* grad_x, long long N, int D,
             int L, float bound, float two_bound, void* stream) {
  if ((D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 1 || N > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
  if (D == 3) {
    return grad_x != nullptr
               ? launch<3, true, T>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                                    n, L, bound, two_bound, s)
               : launch<3, false, T>(x, emb, grad_out, scales, level_params, grad_table,
                                     grad_x, n, L, bound, two_bound, s);
  }
  return grad_x != nullptr
             ? launch<2, true, T>(x, emb, grad_out, scales, level_params, grad_table, grad_x, n,
                                  L, bound, two_bound, s)
             : launch<2, false, T>(x, emb, grad_out, scales, level_params, grad_table, grad_x,
                                   n, L, bound, two_bound, s);
}

}  // namespace

extern "C" int grid_encode_bwd(const void* x, const void* emb, const void* grad_out,
                               const void* scales, const void* level_params, void* grad_table,
                               void* grad_x, long long N, int D, int L, float bound,
                               float two_bound, void* stream) {
  return backward<float>(x, emb, grad_out, scales, level_params, grad_table, grad_x, N, D, L,
                         bound, two_bound, stream);
}

// bf16 table [n_emb, 2] and bf16 grad_out [N, 2L]; float32 gradients. The
// table gradient goes through keys [n_emb] float4, zeroed by the caller;
// grad_table (or keys) may be null when that gradient is not needed.
extern "C" int grid_encode_bwd_bf16_keyed(const void* x, const void* emb, const void* grad_out,
                                          const void* scales, const void* level_params,
                                          void* keys, void* grad_table, void* grad_x,
                                          long long N, int D, int L, float bound,
                                          float two_bound, void* stream) {
  if ((keys == nullptr) != (grad_table == nullptr)) return (int)cudaErrorInvalidValue;
  const int err = backward<__nv_bfloat16>(x, emb, grad_out, scales, level_params, keys, grad_x,
                                          N, D, L, bound, two_bound, stream);
  if (err != 0 || grad_table == nullptr) return err;
  grid_encode_bwd_finish_kernel<<<dim3(264, L), 256, 0, (cudaStream_t)stream>>>(
      (const float4*)keys, (const int*)level_params, 2 + D, (float2*)grad_table);
  return (int)cudaGetLastError();
}
