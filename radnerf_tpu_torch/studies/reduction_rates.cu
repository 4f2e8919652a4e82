// Microbenchmarks of the reductions kernel A'-bf16 can issue, for its
// attribution study (studies/grid_bf16.py): the card's rate of float4
// reductions into device memory (red.global.add.v4.f32, what the
// point-major A' issues per merged row pair) on a given list of row pairs,
// and of a row pair's four float32 atomic adds into a thread-block
// cluster's distributed shared memory (what the level-major A'-bf16 issues).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o reduction_rates.so reduction_rates.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// one float4 reduction per listed pair: table[pairs[i]] += 1
__global__ void red_global_f4(const uint32_t* __restrict__ pairs, float4* __restrict__ table,
                              long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    atomicAdd(table + pairs[i], make_float4(1.0f, 1.0f, 1.0f, 1.0f));
  }
}

// A cluster holds `cluster_pairs` row pairs of float32, dealt pair by pair
// over its blocks as the level-major A'-bf16 deals them; the clusters take
// the listed pairs (modulo cluster_pairs) in turns, four float32 atomic adds
// each. `out` gets each block's first pair, so the adds stay live.
__global__ void red_cluster_f32(const uint32_t* __restrict__ pairs, long long n,
                                unsigned cluster_pairs, float4* __restrict__ out) {
  extern __shared__ float4 acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks(), rank = cluster.block_rank();
  const unsigned log_cs = __ffs(cs) - 1;
  const unsigned held = cluster_pairs >> log_cs;
  for (unsigned i = threadIdx.x; i < held; i += blockDim.x) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster.sync();
  const long long clusters = gridDim.x >> log_cs;
  const long long step = clusters * cs * blockDim.x;
  for (long long i = ((long long)(blockIdx.x >> log_cs) * cs + rank) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const uint32_t p = pairs[i] & (cluster_pairs - 1);
    float* s = reinterpret_cast<float*>(cluster.map_shared_rank(acc + (p >> log_cs),
                                                                p & (cs - 1)));
    atomicAdd(s, 1.0f);
    atomicAdd(s + 1, 1.0f);
    atomicAdd(s + 2, 1.0f);
    atomicAdd(s + 3, 1.0f);
  }
  cluster.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc[0];
}

}  // namespace

extern "C" int run_red_global_f4(const void* pairs, void* table, long long n, void* stream) {
  red_global_f4<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((const uint32_t*)pairs,
                                                           (float4*)table, n);
  return (int)cudaGetLastError();
}

// cs blocks a cluster, as many clusters as the card holds at once; out gets
// one float4 a block. Returns the CUDA error; *n_clusters the clusters
// launched.
extern "C" int run_red_cluster(const void* pairs, long long n, int cs, int cluster_pairs,
                               void* out, int* n_clusters, void* stream) {
  const int smem = (int)((cluster_pairs / cs) * sizeof(float4));
  cudaError_t e =
      cudaFuncSetAttribute(red_cluster_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, red_cluster_f32, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (clusters > 132) clusters = 132;
  *n_clusters = clusters;
  cfg.gridDim = dim3(clusters * cs);
  e = cudaLaunchKernelEx(&cfg, red_cluster_f32, (const uint32_t*)pairs, n,
                         (unsigned)cluster_pairs, (float4*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
