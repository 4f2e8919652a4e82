// Kernel C': front-to-back alpha compositing, backward.
//
// Replaces the gradient of radnerf_tpu/ops/marching.py: composite_rays
// (:757-786), which JAX takes by autodiff of its masked cumprod. With
// c_k = g_ws + g_depth * (t_k + dt_k) + g_image . rgb_k the loss is
// sum_k w_k c_k over the processed steps, and for a processed valid step s
//
//   d sigma_s   = dt_s * (c_s * T_after_s - sum_{k > s} w_k c_k)
//   d rgb_s     = g_image * w_s
//   d ambient_s = g_ambient_sum
//
// with T_after_s the transmittance after step s. The suffix sums
// sum_{k > s} come from the saved forward outputs minus the prefix sums
// recomputed here (reference raymarching.cu:711-809), so one pass suffices.
// The processed mask carries no gradient; invalid steps, and steps past the
// early stop, get exactly zero.
//
// What bounds it on an H100: bytes. Per processed step it reads sigma, dt,
// t, valid and rgb (25 B) and writes 20 B of gradients for ~40 flops and
// one expf; every step of the [N, S] lattice is written (zeros past the
// stop). Design:
//
// - One thread per ray walks its steps in slot order with composite::step,
//   the step kernel C runs, so the prefix sums at the last processed step
//   equal C's saved outputs exactly, the suffixes end at 0, and the early
//   stop falls where C's falls. The walk is never split across lanes: 16
//   lanes a ray, passing the chain through shuffles in slot order (commit
//   7f35e85), took 0.0372 ms at the step's shapes against 0.0261 for this
//   design with 64 rays a block (NVIDIA H100 80GB HBM3, 700 W, in turns;
//   PERF.md).
// - Data reaches and leaves the walk through shared memory. A block of
//   kRays rays takes its rows in chunks of kW = 16 slots: it copies the
//   chunk's sigma, dt, t and rgb into tiles with 16-byte loads (at S = 16
//   one contiguous range of each array a block), each thread walks its row
//   of the tiles and writes its gradients over the inputs it has read (d
//   sigma over sigma, d ambient over dt, d rgb over rgb), and the block
//   copies the gradient tiles out with 16-byte stores. The valid row comes
//   straight from global memory, as kernel C reads it (one 16-byte load a
//   chunk when S is a multiple of 16); image and grad_image [N, 3] through
//   the tiles' space with 16-byte loads.
// - The tiles are swizzled: the 16-byte chunks of each 128-byte line are
//   permuted by the line's index, so the 8 lanes of a quarter-warp that
//   touch the same chunk of 8 consecutive rows (64 bytes apart) reach 8
//   different bank groups.
// - Any S: the last chunk may be short, and unless S is a multiple of 4
//   the copies go one float at a time (rows off 16-byte lines). A ray that
//   has stopped writes zeros into its tile rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

// rays a block, one walking thread each: at the step's shapes 32 took
// 0.0252 ms against 0.0261 with 64 and 0.0264 with 128 (NVIDIA H100 80GB
// HBM3, 700 W, in turns on the same tensors; PERF.md)
constexpr int kRays = 32;
constexpr int kW = 16;             // slots a tile row
constexpr int kTile = kRays * kW;  // floats in the sigma, dt and t tiles (rgb: 3 kTile)
static_assert(kTile % 32 == 0, "a tile is whole 128-byte lines");

// word w of a tile -> its word in shared memory: the 16-byte chunk
// (w / 4) % 8 of the 128-byte line w / 32 goes to chunk
// ((w / 4) % 8) ^ (line % 8) of the same line
__device__ __forceinline__ int swz(int w) { return w ^ (((w >> 5) & 7) << 2); }

__device__ __forceinline__ float4 ld4(const float* tile, int w) {
  return *reinterpret_cast<const float4*>(tile + swz(w));
}
__device__ __forceinline__ void st4(float* tile, int w, float4 v) {
  *reinterpret_cast<float4*>(tile + swz(w)) = v;
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void stg4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// A block's tiles: sigma (then d sigma), dt (then d ambient), t, and rgb
// (then d rgb), kW slots a row.
struct Tiles {
  float* sig;
  float* dt;
  float* t;
  float* rgb;
};

// dst[0, n) = src[0, n) by the block: 16-byte loads (src 16-byte aligned),
// then the tail of under 4
__device__ __forceinline__ void copy_run(float* dst, const float* __restrict__ src, int n) {
  for (int v = threadIdx.x; v < n / 4; v += kRays) {
    reinterpret_cast<float4*>(dst)[v] = ldg4(src + 4 * v);
  }
  const int i = n / 4 * 4 + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

// Slots [c0, c0 + n) of the block's rows into the tiles; i0 = n0 * S + c0
// (the block's first ray's slot c0). kVec: S a multiple of 4 and every
// array 16-byte aligned, so each row's chunk is n / 4 16-byte pieces.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const Tiles& tl, const float* __restrict__ sigmas,
                                           const float* __restrict__ dts,
                                           const float* __restrict__ ts,
                                           const float* __restrict__ rgbs, size_t i0, int S,
                                           int rays, int n) {
  if (kVec) {
#pragma unroll 4
    for (int v = threadIdx.x; v < rays * (kW / 4); v += kRays) {
      const int r = v / (kW / 4), j = 4 * (v % (kW / 4));
      if (j >= n) continue;
      const size_t i = i0 + (size_t)r * S + j;
      const float4 s4 = ldg4(sigmas + i), d4 = ldg4(dts + i), t4 = ldg4(ts + i);
      st4(tl.sig, r * kW + j, s4);
      st4(tl.dt, r * kW + j, d4);
      st4(tl.t, r * kW + j, t4);
    }
#pragma unroll 4
    for (int u = threadIdx.x; u < rays * (3 * kW / 4); u += kRays) {
      const int r = u / (3 * kW / 4), p = 4 * (u % (3 * kW / 4));
      if (p >= 3 * n) continue;
      st4(tl.rgb, 3 * r * kW + p, ldg4(rgbs + 3 * (i0 + (size_t)r * S) + p));
    }
  } else {
#pragma unroll 4
    for (int f = threadIdx.x; f < rays * kW; f += kRays) {
      const int r = f / kW, j = f % kW;
      if (j >= n) continue;
      const size_t i = i0 + (size_t)r * S + j;
      tl.sig[swz(r * kW + j)] = sigmas[i];
      tl.dt[swz(r * kW + j)] = dts[i];
      tl.t[swz(r * kW + j)] = ts[i];
    }
#pragma unroll 4
    for (int f = threadIdx.x; f < rays * 3 * kW; f += kRays) {
      const int r = f / (3 * kW), p = f % (3 * kW);
      if (p >= 3 * n) continue;
      tl.rgb[swz(3 * r * kW + p)] = rgbs[3 * (i0 + (size_t)r * S) + p];
    }
  }
}

// The gradient tiles' slots [c0, c0 + n) out to global memory (as load_chunk)
template <bool kVec>
__device__ __forceinline__ void store_chunk(const Tiles& tl, float* __restrict__ grad_sigmas,
                                            float* __restrict__ grad_ambient,
                                            float* __restrict__ grad_rgbs, size_t i0, int S,
                                            int rays, int n) {
  if (kVec) {
#pragma unroll 4
    for (int v = threadIdx.x; v < rays * (kW / 4); v += kRays) {
      const int r = v / (kW / 4), j = 4 * (v % (kW / 4));
      if (j >= n) continue;
      const size_t i = i0 + (size_t)r * S + j;
      stg4(grad_sigmas + i, ld4(tl.sig, r * kW + j));
      stg4(grad_ambient + i, ld4(tl.dt, r * kW + j));
    }
#pragma unroll 4
    for (int u = threadIdx.x; u < rays * (3 * kW / 4); u += kRays) {
      const int r = u / (3 * kW / 4), p = 4 * (u % (3 * kW / 4));
      if (p >= 3 * n) continue;
      stg4(grad_rgbs + 3 * (i0 + (size_t)r * S) + p, ld4(tl.rgb, 3 * r * kW + p));
    }
  } else {
#pragma unroll 4
    for (int f = threadIdx.x; f < rays * kW; f += kRays) {
      const int r = f / kW, j = f % kW;
      if (j >= n) continue;
      const size_t i = i0 + (size_t)r * S + j;
      grad_sigmas[i] = tl.sig[swz(r * kW + j)];
      grad_ambient[i] = tl.dt[swz(r * kW + j)];
    }
#pragma unroll 4
    for (int f = threadIdx.x; f < rays * 3 * kW; f += kRays) {
      const int r = f / (3 * kW), p = f % (3 * kW);
      if (p >= 3 * n) continue;
      grad_rgbs[3 * (i0 + (size_t)r * S) + p] = tl.rgb[swz(3 * r * kW + p)];
    }
  }
}

template <bool kVec, bool kRow16>
__global__ void __launch_bounds__(kRays) composite_rays_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ image,
    const float* __restrict__ depth, const float* __restrict__ weights_sum,
    const float* __restrict__ grad_image, const float* __restrict__ grad_depth,
    const float* __restrict__ grad_ws, const float* __restrict__ grad_amb,
    float* __restrict__ grad_sigmas, float* __restrict__ grad_rgbs,
    float* __restrict__ grad_ambient, int N, int S, float T_thresh) {
  __shared__ __align__(16) float smem[6 * kTile];
  const Tiles tl{smem, smem + kTile, smem + 2 * kTile, smem + 3 * kTile};
  const int n0 = blockIdx.x * kRays;
  const int rays = min(kRays, N - n0);
  const int r = threadIdx.x;
  const bool ray = r < rays;
  const size_t row0 = (size_t)n0 * S;

  // the block's rows of image and grad_image (3 n0 floats in: a 16-byte
  // boundary, n0 being a multiple of 4)
  copy_run(smem, image + 3 * (size_t)n0, 3 * rays);
  copy_run(smem + 3 * kRays, grad_image + 3 * (size_t)n0, 3 * rays);
  __syncthreads();
  float r_fin = 0.0f, g_fin = 0.0f, b_fin = 0.0f, d_fin = 0.0f, ws_fin = 0.0f;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f, gw = 0.0f, ga = 0.0f;
  if (ray) {
    r_fin = smem[3 * r], g_fin = smem[3 * r + 1], b_fin = smem[3 * r + 2];
    gr = smem[3 * (kRays + r)], gg = smem[3 * (kRays + r) + 1], gb = smem[3 * (kRays + r) + 2];
    const int n = n0 + r;
    d_fin = depth[n], ws_fin = weights_sum[n];
    gd = grad_depth[n], gw = grad_ws[n], ga = grad_amb[n];
  }
  __syncthreads();  // the tiles take that space

  composite::Sums a;
  bool live = ray;  // the ray has not stopped
  for (int c0 = 0; c0 < S; c0 += kW) {
    const int nc = min(kW, S - c0);
    load_chunk<kVec>(tl, sigmas, dts, ts, rgbs, row0 + c0, S, rays, nc);
    __syncthreads();
    if (ray) {
      const uint32_t bits =
          live ? composite::valid_bits<kRow16>(valid + row0 + (size_t)r * S + c0, nc) : 0u;
      for (int j0 = 0; j0 < nc; j0 += 4) {
        const int w0 = r * kW + j0;
        const float4 s4 = ld4(tl.sig, w0), d4 = ld4(tl.dt, w0), t4 = ld4(tl.t, w0);
        const float4 q0 = ld4(tl.rgb, 3 * w0), q1 = ld4(tl.rgb, 3 * w0 + 4),
                     q2 = ld4(tl.rgb, 3 * w0 + 8);
        const float sg[4] = {s4.x, s4.y, s4.z, s4.w}, dt[4] = {d4.x, d4.y, d4.z, d4.w};
        const float tt[4] = {t4.x, t4.y, t4.z, t4.w};
        const float rgb[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                               q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
        float o_sig[4], o_amb[4], o_rgb[12];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o_sig[j] = 0.0f, o_amb[j] = 0.0f;
          o_rgb[3 * j] = 0.0f, o_rgb[3 * j + 1] = 0.0f, o_rgb[3 * j + 2] = 0.0f;
          if (j0 + j >= nc) continue;
          live = live && composite::processes(c0 + j0 + j, a, T_thresh);
          if (!live || !((bits >> (j0 + j)) & 1u)) continue;
          const float cr = rgb[3 * j], cg = rgb[3 * j + 1], cb = rgb[3 * j + 2];
          const float td = tt[j] + dt[j];
          const float w = composite::step(a, sg[j], dt[j], tt[j], cr, cg, cb);
          const float T = a.T;  // after the step
          const float own = gw * T + gd * (td * T) + gr * (cr * T) + gg * (cg * T) +
                            gb * (cb * T);
          const float later = gw * (ws_fin - a.ws) + gd * (d_fin - a.depth) +
                              gr * (r_fin - a.r) + gg * (g_fin - a.g) + gb * (b_fin - a.b);
          o_sig[j] = dt[j] * (own - later);
          o_rgb[3 * j] = gr * w, o_rgb[3 * j + 1] = gg * w, o_rgb[3 * j + 2] = gb * w;
          o_amb[j] = ga;
        }
        st4(tl.sig, w0, make_float4(o_sig[0], o_sig[1], o_sig[2], o_sig[3]));
        st4(tl.dt, w0, make_float4(o_amb[0], o_amb[1], o_amb[2], o_amb[3]));
        st4(tl.rgb, 3 * w0, make_float4(o_rgb[0], o_rgb[1], o_rgb[2], o_rgb[3]));
        st4(tl.rgb, 3 * w0 + 4, make_float4(o_rgb[4], o_rgb[5], o_rgb[6], o_rgb[7]));
        st4(tl.rgb, 3 * w0 + 8, make_float4(o_rgb[8], o_rgb[9], o_rgb[10], o_rgb[11]));
      }
    }
    __syncthreads();
    store_chunk<kVec>(tl, grad_sigmas, grad_ambient, grad_rgbs, row0 + c0, S, rays, nc);
    __syncthreads();  // the copy out has read the tiles before the next loads
  }
}

template <bool kVec, bool kRow16>
void launch(const void* sigmas, const void* rgbs, const void* dts, const void* ts,
            const void* valid, const void* image, const void* depth, const void* weights_sum,
            const void* grad_image, const void* grad_depth, const void* grad_ws,
            const void* grad_amb, void* grad_sigmas, void* grad_rgbs, void* grad_ambient,
            int N, int S, float T_thresh, cudaStream_t stream) {
  composite_rays_bwd_kernel<kVec, kRow16><<<(N + kRays - 1) / kRays, kRays, 0, stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)dts, (const float*)ts,
      (const uint8_t*)valid, (const float*)image, (const float*)depth,
      (const float*)weights_sum, (const float*)grad_image, (const float*)grad_depth,
      (const float*)grad_ws, (const float*)grad_amb, (float*)grad_sigmas, (float*)grad_rgbs,
      (float*)grad_ambient, N, S, T_thresh);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int composite_rays_bwd(
    const void* sigmas, const void* rgbs, const void* dts, const void* ts,
    const void* valid, const void* image, const void* depth,
    const void* weights_sum, const void* grad_image, const void* grad_depth,
    const void* grad_ws, const void* grad_amb, void* grad_sigmas,
    void* grad_rgbs, void* grad_ambient, long long N, int S, float T_thresh,
    void* stream) {
  // every array starts 16-byte aligned (the wrapper copies one that does
  // not), so rows are aligned for vectors wherever S allows them
  const void* arrays[] = {sigmas, rgbs, dts, ts, valid, image, depth, weights_sum,
                          grad_image, grad_depth, grad_ws, grad_amb, grad_sigmas,
                          grad_rgbs, grad_ambient};
  for (const void* p : arrays) {
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  }
  // (the chunk loop's c0 + kW stays an int)
  if (N < 0 || N > 0x7fffffffLL - kRays || S < 1 || S > 0x7fffffff - kW) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return 0;
  auto fn = launch<false, false>;
  if (S % 16 == 0) {
    fn = launch<true, true>;
  } else if (S % 4 == 0) {
    fn = launch<true, false>;
  }
  fn(sigmas, rgbs, dts, ts, valid, image, depth, weights_sum, grad_image, grad_depth, grad_ws,
     grad_amb, grad_sigmas, grad_rgbs, grad_ambient, (int)N, S, T_thresh,
     (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
