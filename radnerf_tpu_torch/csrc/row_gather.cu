// Kernel D: row gather, out[j] = table[idx[j]].
//
// Replaces scripts/bench_gather.py: pallas_row_loop (:66-93), the repo's one
// Pallas kernel (a gather study: the whole [T, W] table in VMEM, the indices
// scalar-prefetched into SMEM, an unrolled loop of one dynamic row load and
// store per index), and radnerf_tpu/ops/rowgather.py: take_rows (:20), the
// XLA row fetch it was studied for. On the TPU a gather costs per row, so
// the Pallas kernel pipelined row loads through VMEM. On Hopper nothing has
// to be staged: each thread loads its own index and copies its piece of the
// row from device memory (or L2: the study's tables are 128 KB and 2 MB)
// straight to the output.
//
// What bounds it on an H100: bytes. Per output row it reads one index and
// one table row and writes one row (the study: 4 + 32 + 32 B at W = 16
// bf16). Design: the row is copied in the widest vector (16, 8, 4, 2 or 1
// bytes) that divides the row and both base addresses, one thread per
// (row, vector), so the threads of a warp write consecutive vectors of the
// output; a row of 32 B is two 16-byte vectors. Rows whose index lies
// outside [0, T) are written as zeros: the bounds guard keeps memory safe
// without a sync to report the fault, so here the kernel differs from its
// plain version, table[idx], which raises on them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename I>
__global__ void row_gather_kernel(const V* __restrict__ table,
                                  const I* __restrict__ idx, V* __restrict__ out,
                                  long long P, long long T, int vecs_per_row) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * vecs_per_row) return;
  const long long j = i / vecs_per_row;
  const int v = (int)(i - j * vecs_per_row);
  const long long row = (long long)idx[j];
  if (row < 0 || row >= T) {
    out[i] = V{};
    return;
  }
  out[i] = table[row * vecs_per_row + v];
}

template <typename I>
int launch(const void* table, const void* idx, void* out, long long P,
           long long T, long long row_bytes, cudaStream_t s) {
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  const int threads = 256;
  auto blocks = [&](long long vecs) {
    return (unsigned)((P * vecs + threads - 1) / threads);
  };
  const I* ix = (const I*)idx;
  if (align % 16 == 0) {
    const int n = (int)(row_bytes / 16);
    row_gather_kernel<uint4, I><<<blocks(n), threads, 0, s>>>(
        (const uint4*)table, ix, (uint4*)out, P, T, n);
  } else if (align % 8 == 0) {
    const int n = (int)(row_bytes / 8);
    row_gather_kernel<uint2, I><<<blocks(n), threads, 0, s>>>(
        (const uint2*)table, ix, (uint2*)out, P, T, n);
  } else if (align % 4 == 0) {
    const int n = (int)(row_bytes / 4);
    row_gather_kernel<uint32_t, I><<<blocks(n), threads, 0, s>>>(
        (const uint32_t*)table, ix, (uint32_t*)out, P, T, n);
  } else if (align % 2 == 0) {
    const int n = (int)(row_bytes / 2);
    row_gather_kernel<uint16_t, I><<<blocks(n), threads, 0, s>>>(
        (const uint16_t*)table, ix, (uint16_t*)out, P, T, n);
  } else {
    const int n = (int)row_bytes;
    row_gather_kernel<uint8_t, I><<<blocks(n), threads, 0, s>>>(
        (const uint8_t*)table, ix, (uint8_t*)out, P, T, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// idx_bytes: 4 for int32 indices, 8 for int64
extern "C" int row_gather(const void* table, const void* idx, void* out,
                          long long P, long long T, long long row_bytes,
                          int idx_bytes, void* stream) {
  if (row_bytes <= 0 || (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 4) return launch<int32_t>(table, idx, out, P, T, row_bytes, s);
  return launch<int64_t>(table, idx, out, P, T, row_bytes, s);
}
