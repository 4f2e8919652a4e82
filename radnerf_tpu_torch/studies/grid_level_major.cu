// The level-major design for kernel A'-bf16's table gradient, timed by
// studies/grid_bf16.py against the point-major kernel on the port's path
// (csrc/grid_encode_backward.cu); not on the path: it measured 3.9-38x
// slower (PERF.md §6).
//
// A cluster of `cluster` blocks owns one level and walks its share of the
// points (a grid-stride walk over chunks of kThreads points; the level's
// clusters and the cluster's blocks take the chunks in turn). The level's
// float32 gradient lives in the cluster's shared memory: a level of at most
// kClusterPairs / cluster row pairs whole in each block, a larger one dealt
// out pair by pair (pair p in block p % cluster, at p / cluster) and reached
// through distributed shared memory; a pair past the cluster's
// kClusterPairs goes to device memory directly. Each warp merges its runs
// of equal rows first, as the point-major kernel does. After the walk each
// block adds every nonzero pair it holds into grad_table once, as one
// float4 atomic (the level's other clusters add into the same rows).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -fmad=false -shared -Xcompiler -fPIC -I ../csrc -o grid_level_major.so
//        grid_level_major.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add
constexpr int kThreads = 1024;
constexpr unsigned kClusterPairs = 32768;  // 65,536 rows: 512 KB of float32

namespace cg = cooperative_groups;

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

// Where a level-major block adds row pair p of its level.
struct Held {
  float4* acc;  // this block's pairs
  unsigned log_cs, cap;
  bool whole;
  // the pair's first float in the cluster's shared memory, or nullptr for
  // a pair past the cluster's capacity
  __device__ __forceinline__ float* at(cg::cluster_group& cluster, uint32_t p) const {
    if (whole) return reinterpret_cast<float*>(acc + p);
    const uint32_t slot = p >> log_cs;
    if (slot >= cap) return nullptr;
    return reinterpret_cast<float*>(cluster.map_shared_rank(acc + slot, p & ((1u << log_cs) - 1)));
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) grid_encode_bwd_lm_kernel(
    const float* __restrict__ x, const typename grid::Table<T>::Out* __restrict__ grad_out,
    const float* __restrict__ scales, const int* __restrict__ level_params,
    float2* __restrict__ grad_table, int N, int L, float bound, float two_bound,
    int clusters_per_level) {
  using Tab = grid::Table<T>;
  extern __shared__ float4 acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks(), rank = cluster.block_rank();
  const unsigned log_cs = __ffs(cs) - 1;
  const int cid = blockIdx.x >> log_cs;
  const int l = cid % L, k = cid / L;
  grid::Level<D> lv = grid::load_level<D>(scales, level_params, l);
  float2* const level_grad = grad_table + lv.offset;
  lv.offset = 0;  // rows within the level
  const uint32_t pairs = lv.size >> 1;  // a level's size is a multiple of 8
  Held held{acc, log_cs, kClusterPairs >> log_cs, false};
  held.whole = pairs <= held.cap;
  const uint32_t n_held =
      held.whole ? pairs : min(held.cap, (pairs + cs - 1) >> log_cs);
  for (uint32_t i = threadIdx.x; i < n_held; i += blockDim.x) {
    acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  cluster.sync();

  const unsigned lane = threadIdx.x & 31u;
  const long long stride = (long long)clusters_per_level * cs * blockDim.x;
  for (long long n0 = ((long long)k * cs + rank) * blockDim.x; n0 < N; n0 += stride) {
    const long long n = n0 + threadIdx.x;
    float p[D];
    const bool live = n < N && grid::unit_position<D>(x + (size_t)n * D, bound, two_bound, p);
    uint32_t pg[D];
    float frac[D];
    float2 g = make_float2(0.0f, 0.0f);
    if (live) {
      grid::cell<D>(p, lv.scale, pg, frac);
      g = Tab::load_out(grad_out + (size_t)n * L + l);
    }
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
      }
      if (!merge_runs(r0, r1, v, lane) || r0 == kNoRow) continue;
      if (grid::pair_aligned(r0, r1)) {
        float* s = held.at(cluster, r0 >> 1);
        if (s == nullptr) {
          atomicAdd(reinterpret_cast<float4*>(level_grad + r0), v);
        } else {
          atomicAdd(s, v.x);
          atomicAdd(s + 1, v.y);
          atomicAdd(s + 2, v.z);
          atomicAdd(s + 3, v.w);
        }
      } else {
        const uint32_t rows[2] = {r0, r1};
        const float2 vals[2] = {make_float2(v.x, v.y), make_float2(v.z, v.w)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* s = held.at(cluster, rows[j] >> 1);
          if (s == nullptr) {
            atomicAdd(level_grad + rows[j], vals[j]);
          } else {
            s += 2 * (rows[j] & 1u);
            atomicAdd(s, vals[j].x);
            atomicAdd(s + 1, vals[j].y);
          }
        }
      }
    }
  }
  cluster.sync();  // every add into this block's pairs has landed

  for (uint32_t i = threadIdx.x; i < n_held; i += blockDim.x) {
    const float4 v = acc[i];
    const uint32_t p = held.whole ? i : (i << log_cs) + rank;
    if (p < pairs && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)) {
      atomicAdd(reinterpret_cast<float4*>(level_grad + 2 * p), v);
    }
  }
}

// cluster blocks a cluster, as many clusters on each level as the card
// holds at once over the L levels, fewer when the points run out
template <int D, typename T>
int launch(const void* x, const void* grad_out, const void* scales, const void* level_params,
           void* grad_table, int N, int L, float bound, float two_bound, int cluster,
           cudaStream_t s) {
  using Tab = grid::Table<T>;
  auto* kern = grid_encode_bwd_lm_kernel<D, T>;
  const int smem = (int)((kClusterPairs / cluster) * sizeof(float4));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int max_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&max_clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = ((long long)N + kThreads - 1) / kThreads;
  const long long most = (chunks + cluster - 1) / cluster;
  int cpl = max_clusters / L > 1 ? max_clusters / L : 1;
  if (cpl > most) cpl = (int)most;
  cfg.gridDim = dim3((unsigned)(L * cpl * cluster));
  e = cudaLaunchKernelEx(&cfg, kern, (const float*)x, (const typename Tab::Out*)grad_out,
                         (const float*)scales, (const int*)level_params, (float2*)grad_table,
                         N, L, bound, two_bound, cpl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The table gradient alone (grad_table zeroed by the caller): grad_out bf16
// [N, 2L] when bf16 is nonzero, else float32; cluster in 1, 2, 4, 8.
extern "C" int grid_encode_bwd_level_major(const void* x, const void* grad_out,
                                           const void* scales, const void* level_params,
                                           void* grad_table, long long N, int D, int L,
                                           float bound, float two_bound, int bf16, int cluster,
                                           void* stream) {
  if ((D != 2 && D != 3) || L < 1 || L > grid::kMaxLevels || N < 1 || N > 0x7fffffffLL ||
      (cluster & (cluster - 1)) || cluster < 1 || cluster > 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
  if (bf16) {
    return D == 3 ? launch<3, __nv_bfloat16>(x, grad_out, scales, level_params, grad_table, n,
                                              L, bound, two_bound, cluster, s)
                  : launch<2, __nv_bfloat16>(x, grad_out, scales, level_params, grad_table, n,
                                              L, bound, two_bound, cluster, s);
  }
  return D == 3 ? launch<3, float>(x, grad_out, scales, level_params, grad_table, n, L, bound,
                                   two_bound, cluster, s)
                : launch<2, float>(x, grad_out, scales, level_params, grad_table, n, L, bound,
                                   two_bound, cluster, s);
}
