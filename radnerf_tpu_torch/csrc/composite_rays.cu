// Kernel C: front-to-back alpha compositing of a [N, S] sample lattice.
//
// Replaces radnerf_tpu/ops/marching.py: composite_rays (:731-786). The TPU
// form is a masked cumprod over the whole lattice (every step of every ray
// is computed, then masked off past T_thresh) because a TPU has no per-ray
// early exit. On Hopper it is the reference's own structure: one thread per
// ray runs its steps and stops once the transmittance after a step falls
// below T_thresh (the crossing step is included; transmittance never rises,
// so every later step would be masked).
//
// What bounds it on an H100: bytes. Per processed step it reads sigma, dt,
// t, rgb and ambient (28 B) for ~15 flops and one expf; per ray it reads
// its valid row and writes 24 B. The frame's rows are sparse (about one
// valid slot a hit ray, none on most rays), the training step's dense.
// Design:
//
// - The valid row is read first, whole: 16-byte loads when S is a multiple
//   of 16 (one load at S = 16; a warp reads 512 contiguous bytes), bytes
//   otherwise. A ray with no valid slot writes zeros and reads nothing
//   else. At S = 16 the 16-byte read took 0.0142 ms against the byte
//   loop's 0.0150 on the frame's sparse rows and 0.0113 against 0.0118 on
//   the step's dense ones (NVIDIA H100 80GB HBM3, 700 W, in turns on the
//   same tensors; PERF.md).
// - Past that, only the 4-slot chunks that hold a valid slot are loaded,
//   and as vectors when S is a multiple of 4 (the wrapper hands over arrays
//   that start 16-byte aligned, so every row is): a float4 each of sigma,
//   dt, t and ambient and three of rgb, all in flight together; a chunk
//   costs about what one valid slot's scalar loads cost, and a dense row
//   takes S / 4 rounds of loads instead of S.
// - image [N, 3] goes out through a shared-memory tile, as one contiguous
//   run of 16-byte stores a block.
// - The arithmetic per ray stays sequential, op for op with the plain twin
//   (ops/marching.py composite_rays_plain): the step is composite::step in
//   composite_common.cuh, which kernel C' replays.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

constexpr int kThreads = 128;  // rays a block

template <bool kVec, bool kRow16>
__global__ void __launch_bounds__(kThreads) composite_rays_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ ambient,
    float* __restrict__ image, float* __restrict__ depth,
    float* __restrict__ weights_sum, float* __restrict__ ambient_sum, int N, int S,
    float T_thresh) {
  __shared__ __align__(16) float img[3 * kThreads];
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
  composite::Sums a;
  float amb = 0.0f;
  if (n < N) {
    const size_t row = (size_t)n * S;
    bool stop = false;
    for (int c0 = 0; c0 < S && !stop; c0 += 16) {
      uint32_t bits = composite::valid_bits<kRow16>(valid + row + c0, min(16, S - c0));
      while (bits != 0 && !stop) {
        const int c = (__ffs(bits) - 1) & ~3;  // the next chunk with a valid slot
        const uint32_t cb = (bits >> c) & 15u;
        bits &= ~(15u << c);
        const size_t i = row + c0 + c;
        float sg[4], dt[4], tt[4], am[4], rgb[12];
        if (kVec) {
          const float4 s4 = *reinterpret_cast<const float4*>(sigmas + i);
          const float4 d4 = *reinterpret_cast<const float4*>(dts + i);
          const float4 t4 = *reinterpret_cast<const float4*>(ts + i);
          const float4 a4 = *reinterpret_cast<const float4*>(ambient + i);
          const float4* c4 = reinterpret_cast<const float4*>(rgbs + 3 * i);
          const float4 c40 = c4[0], c41 = c4[1], c42 = c4[2];
          sg[0] = s4.x, sg[1] = s4.y, sg[2] = s4.z, sg[3] = s4.w;
          dt[0] = d4.x, dt[1] = d4.y, dt[2] = d4.z, dt[3] = d4.w;
          tt[0] = t4.x, tt[1] = t4.y, tt[2] = t4.z, tt[3] = t4.w;
          am[0] = a4.x, am[1] = a4.y, am[2] = a4.z, am[3] = a4.w;
          rgb[0] = c40.x, rgb[1] = c40.y, rgb[2] = c40.z, rgb[3] = c40.w;
          rgb[4] = c41.x, rgb[5] = c41.y, rgb[6] = c41.z, rgb[7] = c41.w;
          rgb[8] = c42.x, rgb[9] = c42.y, rgb[10] = c42.z, rgb[11] = c42.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (cb >> j & 1u) {
              sg[j] = sigmas[i + j], dt[j] = dts[i + j], tt[j] = ts[i + j];
              am[j] = ambient[i + j];
              rgb[3 * j] = rgbs[3 * (i + j)], rgb[3 * j + 1] = rgbs[3 * (i + j) + 1];
              rgb[3 * j + 2] = rgbs[3 * (i + j) + 2];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(cb >> j & 1u)) continue;
          if (!composite::processes(c0 + c + j, a, T_thresh)) {
            stop = true;
            break;
          }
          composite::step(a, sg[j], dt[j], tt[j], rgb[3 * j], rgb[3 * j + 1], rgb[3 * j + 2]);
          amb = amb + am[j];
        }
      }
    }
    depth[n] = a.depth;
    weights_sum[n] = a.ws;
    ambient_sum[n] = amb;
  }
  img[3 * threadIdx.x] = a.r;
  img[3 * threadIdx.x + 1] = a.g;
  img[3 * threadIdx.x + 2] = a.b;
  __syncthreads();
  // the block's rows of image are one run of 3 * rays floats from a 16-byte
  // boundary (n0 is a multiple of 128)
  const int n_out = 3 * min(kThreads, N - n0);
  float* const out = image + 3 * (size_t)n0;
  for (int i = threadIdx.x; i < n_out / 4; i += kThreads) {
    reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(img)[i];
  }
  const int tail = (n_out / 4) * 4 + threadIdx.x;
  if (tail < n_out) out[tail] = img[tail];
}

template <bool kVec, bool kRow16>
void launch(const void* sigmas, const void* rgbs, const void* dts, const void* ts,
            const void* valid, const void* ambient, void* image, void* depth,
            void* weights_sum, void* ambient_sum, int N, int S, float T_thresh,
            cudaStream_t stream) {
  composite_rays_kernel<kVec, kRow16><<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)dts, (const float*)ts,
      (const uint8_t*)valid, (const float*)ambient, (float*)image, (float*)depth,
      (float*)weights_sum, (float*)ambient_sum, N, S, T_thresh);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int composite_rays_fwd(const void* sigmas, const void* rgbs,
                                  const void* dts, const void* ts,
                                  const void* valid, const void* ambient,
                                  void* image, void* depth, void* weights_sum,
                                  void* ambient_sum, long long N, int S,
                                  float T_thresh, void* stream) {
  // every array starts 16-byte aligned (the wrapper copies a view that does
  // not), so rows are aligned for vectors wherever S allows them
  const void* arrays[] = {sigmas, rgbs, dts, ts, valid, ambient, image};
  for (const void* p : arrays) {
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  }
  if (N < 0 || N > 0x7fffffffLL - kThreads || S < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  auto fn = launch<false, false>;
  if (S % 16 == 0) {
    fn = launch<true, true>;
  } else if (S % 4 == 0) {
    fn = launch<true, false>;
  }
  fn(sigmas, rgbs, dts, ts, valid, ambient, image, depth, weights_sum, ambient_sum, (int)N, S,
     T_thresh, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
