// Kernel A: multiresolution tiled grid encoder, forward.
//
// Replaces radnerf_tpu/ops/grid_encode.py: grid_encode01 (:168) and its TPU
// form grid_encode01_packed + build_packed_table (:243-404). The TPU form
// packed each cell's 2^D corners into one wide row (per-level rolls, an
// appended zero row, a one-hot MXU fetch for small levels) because a TPU
// gather costs per row. None of that carries over: a Hopper thread reads the
// 2^D corner rows straight from the [n_emb, C] fp32 table.
//
// What bounds it on an H100: bytes. Per (point, level) it reads 2^D rows of
// C floats and writes C floats, against ~10 flops per corner. The tables on
// the render path are 7.2 MB (3-D) and 4.4 MB (2-D), so they sit in the
// 50 MB L2 and the corner reads are L2 hits; the output [N, L*C] is the
// largest stream. Design: one thread per (point, level), consecutive
// threads on consecutive levels of one point, so the C-float output writes
// of a warp are contiguous and the point's coordinates are a broadcast read.
//
// Arithmetic mirrors the plain twin (ops/grid_encode.py grid_encode_plain)
// in the same order; the library is built with -fmad=false so
// x01*scale + 0.5 is rounded twice, as the twin rounds it, and every point
// lands in the same cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;

template <int D>
__global__ void grid_encode_kernel(const float* __restrict__ x,
                                   const float* __restrict__ emb,
                                   const float* __restrict__ scales,
                                   const int* __restrict__ level_params,
                                   float* __restrict__ out, long long N, int L,
                                   int C, float bound, float two_bound) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  long long n = i / L;
  int l = (int)(i - n * L);
  float* o = out + n * (long long)(L * C) + (long long)l * C;

  float p[D];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float v = (x[n * D + d] + bound) / two_bound;
    oob |= (v < 0.0f) || (v > 1.0f);
    p[d] = v;
  }
  if (oob) {  // outside [0,1]^D encodes to exactly zero
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }

  const float scale = scales[l];
  const int* lp = level_params + l * (2 + D);
  const uint32_t offset = (uint32_t)lp[0];
  const uint32_t size = (uint32_t)lp[1];
  uint32_t stride[D];
  uint32_t pg[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    stride[d] = (uint32_t)lp[2 + d];
    float pos = p[d] * scale + 0.5f;
    float fl = floorf(pos);
    frac[d] = pos - fl;
    pg[d] = (uint32_t)fl;
  }

  float acc[kMaxC];
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    float w = 1.0f;
    uint32_t idx = 0;  // uint32 wraparound, as the reference index
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t bit = (corner >> d) & 1u;
      w = w * (bit ? frac[d] : 1.0f - frac[d]);
      idx += (pg[d] + bit) * stride[d];
    }
    const float* row = emb + (long long)(idx % size + offset) * C;
    for (int c = 0; c < C; ++c) {
      const float contrib = w * row[c];
      acc[c] = corner == 0 ? contrib : acc[c] + contrib;
    }
  }
  for (int c = 0; c < C; ++c) o[c] = acc[c];
}

}  // namespace

extern "C" int grid_encode_fwd(const void* x, const void* emb,
                               const void* scales, const void* level_params,
                               void* out, long long N, int D, int L, int C,
                               float bound, float two_bound, void* stream) {
  if (C > kMaxC || (D != 2 && D != 3)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = N * L;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    grid_encode_kernel<3><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)scales,
        (const int*)level_params, (float*)out, N, L, C, bound, two_bound);
  } else {
    grid_encode_kernel<2><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)scales,
        (const int*)level_params, (float*)out, N, L, C, bound, two_bound);
  }
  return (int)cudaGetLastError();
}
