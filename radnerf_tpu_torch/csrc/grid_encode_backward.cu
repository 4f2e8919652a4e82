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
//   grad_x[d]               += grad_pos[d] * scale_l / (2 * bound)
//
// Points outside [-bound, bound]^D get zero gradient for both, as their
// forward output is exactly zero (every corner weight carries inb = 0).
//
// What bounds it on an H100: the atomics. Each (point, level) adds 2^D*C
// floats into the table gradient; the coarse levels are small (17^3 =
// 4,913 rows at the 3-D level 0, 17^2 at the 2-D one) and every sample hits
// them, so many threads add into the same rows at once. The bytes are the
// points, grad_out and the touched rows of the table (fp32, 7.2 MB / 4.4 MB,
// L2-resident). Design: one thread per (point, level) recomputes the cell
// and weights exactly as kernel A does and issues scalar float atomicAdds
// (red.global.add.f32, no return value used); the position gradient stays
// in registers across the corners and goes out as D atomics per level.
// The atomic order varies from run to run, so the table gradient is not
// bit-exact between runs or with the plain version; it agrees to the
// rounding of a float32 sum taken in another order.
//
// The wrapper zeroes grad_table (and grad_x) before the launch; either may
// be null when its gradient is not needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;

template <int D>
__global__ void grid_encode_bwd_kernel(const float* __restrict__ x,
                                       const float* __restrict__ emb,
                                       const float* __restrict__ grad_out,
                                       const float* __restrict__ scales,
                                       const int* __restrict__ level_params,
                                       float* __restrict__ grad_table,
                                       float* __restrict__ grad_x, long long N,
                                       int L, int C, float bound,
                                       float two_bound) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  long long n = i / L;
  int l = (int)(i - n * L);

  float p[D];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float v = (x[n * D + d] + bound) / two_bound;
    oob |= (v < 0.0f) || (v > 1.0f);
    p[d] = v;
  }
  if (oob) return;

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

  float g[kMaxC];
  const float* go = grad_out + n * (long long)(L * C) + (long long)l * C;
  for (int c = 0; c < C; ++c) g[c] = go[c];

  float gpos[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gpos[d] = 0.0f;

#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    float w = 1.0f;
    uint32_t idx = 0;  // uint32 wraparound, as the forward index
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t bit = (corner >> d) & 1u;
      w = w * (bit ? frac[d] : 1.0f - frac[d]);
      idx += (pg[d] + bit) * stride[d];
    }
    const long long row = (long long)(idx % size + offset) * C;
    if (grad_table != nullptr) {
      for (int c = 0; c < C; ++c) atomicAdd(grad_table + row + c, w * g[c]);
    }
    if (grad_x != nullptr) {
      float dot = 0.0f;
      for (int c = 0; c < C; ++c) dot = dot + g[c] * emb[row + c];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        // dw/dfrac_d: the product of the other dims' factors, signed by
        // the corner's bit in dim d
        float dw = ((corner >> d) & 1u) ? 1.0f : -1.0f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          if (e == d) continue;
          dw = dw * (((corner >> e) & 1u) ? frac[e] : 1.0f - frac[e]);
        }
        gpos[d] = gpos[d] + dot * dw;
      }
    }
  }
  if (grad_x != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      atomicAdd(grad_x + n * D + d, gpos[d] * scale / two_bound);
    }
  }
}

}  // namespace

extern "C" int grid_encode_bwd(const void* x, const void* emb,
                               const void* grad_out, const void* scales,
                               const void* level_params, void* grad_table,
                               void* grad_x, long long N, int D, int L, int C,
                               float bound, float two_bound, void* stream) {
  if (C > kMaxC || (D != 2 && D != 3)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = N * L;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) {
    grid_encode_bwd_kernel<3><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)grad_out,
        (const float*)scales, (const int*)level_params, (float*)grad_table,
        (float*)grad_x, N, L, C, bound, two_bound);
  } else {
    grid_encode_bwd_kernel<2><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)emb, (const float*)grad_out,
        (const float*)scales, (const int*)level_params, (float*)grad_table,
        (float*)grad_x, N, L, C, bound, two_bound);
  }
  return (int)cudaGetLastError();
}
