// Kernel B: occupancy-grid ray marcher over the sigma-byte field (inference).
//
// Replaces radnerf_tpu/ops/marching.py: march_rays (:374-520, the affine
// branch with sigma_byte_lookup :267-298 and the transmittance cull) and the
// marched window of models/renderer.py march_window (:470-487), whose
// [t_lo, t_hi] it takes as input. The TPU form evaluated the whole [N, K]
// orbit lattice densely (one wide-row gather per orbit point, then a cumsum
// and a one-hot contraction to pick the first S occupied points) because a
// TPU has no per-ray control flow. On Hopper this is the reference's own
// structure: one thread per ray walks its orbit and stops at the window end.
//
// What bounds it on an H100: bytes. Per ray it reads 32 B of geometry and
// writes S slots of t, dt, valid and xyz (21 B each, 336 B at S = 16); the
// sigma-byte field is 2 MB at H = 128 and stays in L2, so the per-step
// byte lookups are L2 hits. Design: the walk breaks at t >= min(far, t_hi)
// (t is non-decreasing along the orbit, so no later step can pass), reads
// one byte per step, and keeps the running cull sum in a register.
//
// Arithmetic mirrors the plain twin (ops/marching.py march_rays_plain) op
// for op: t = t0 + (k0 + k) * dt and o + t * d are rounded per operation
// (-fmad=false), so every point lands in the twin's cell. The cull tests
// (incl - est) <= -ln(cull_T) with incl the float32 running sum, which is
// the JAX path's cumsum(est) - est.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// share of the lower-bound optical depth sigma_lo * dt the cull counts
// (CULL_SAFETY in ops/marching.py)
constexpr float kCullSafety = 0.5f;

__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

__device__ __forceinline__ uint32_t morton3d(uint32_t x, uint32_t y, uint32_t z) {
  return expand_bits(x) | (expand_bits(y) << 1) | (expand_bits(z) << 2);
}

// clip(v, lo, hi) with NaN passing through, as jnp.clip / torch.clamp do
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// minimum that propagates NaN, as jnp.minimum / torch.minimum do
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}

__device__ __forceinline__ uint32_t cell_coord(float p, float mip_bound, float H) {
  const float c = clampf(floorf(0.5f * (p / mip_bound + 1.0f) * H), 0.0f, H - 1.0f);
  return (uint32_t)c;
}

__global__ void march_rays_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ nears, const float* __restrict__ fars,
    const float* __restrict__ t_lo, const float* __restrict__ t_hi,
    const uint8_t* __restrict__ sigma_bytes, float* __restrict__ t_out,
    float* __restrict__ dt_out, bool* __restrict__ valid_out,
    float* __restrict__ xyz_out, int* __restrict__ count_out, long long N, int K,
    int S, int H, float bound, float mip_bound, float dt, int use_cull,
    float log_cull) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float ox = rays_o[3 * n], oy = rays_o[3 * n + 1], oz = rays_o[3 * n + 2];
  const float dx = rays_d[3 * n], dy = rays_d[3 * n + 1], dz = rays_d[3 * n + 2];
  const float t0 = nears[n];
  float k0 = floorf((t_lo[n] - t0) / dt);
  k0 = k0 < 0.0f ? 0.0f : k0;  // NaN stays NaN, as in the twin
  const float t_end = min_nan(fars[n], t_hi[n]);
  const float Hf = (float)H;

  float* t_row = t_out + n * S;
  float* dt_row = dt_out + n * S;
  bool* v_row = valid_out + n * S;
  float* xyz_row = xyz_out + n * S * 3;
  float incl = 0.0f;
  int slot = 0, count = 0;
  for (int k = 0; k < K; ++k) {
    const float t = t0 + (k0 + (float)k) * dt;
    if (!(t < t_end)) break;  // t is non-decreasing in k
    const float px = clampf(ox + t * dx, -bound, bound);
    const float py = clampf(oy + t * dy, -bound, bound);
    const float pz = clampf(oz + t * dz, -bound, bound);
    const uint32_t cell = morton3d(cell_coord(px, mip_bound, Hf),
                                   cell_coord(py, mip_bound, Hf),
                                   cell_coord(pz, mip_bound, Hf));
    const uint32_t byte = sigma_bytes[cell];
    if (!(byte & 128u)) continue;
    if (use_cull) {
      const uint32_t q = byte & 127u;
      const float sig = q > 0 ? exp2f(((float)q - 40.0f) * 0.25f) : 0.0f;
      const float est = sig * dt * kCullSafety;
      incl = incl + est;
      if (!((incl - est) <= log_cull)) continue;
    }
    ++count;
    if (slot < S) {
      t_row[slot] = t;
      dt_row[slot] = dt;
      v_row[slot] = true;
      xyz_row[3 * slot] = px;
      xyz_row[3 * slot + 1] = py;
      xyz_row[3 * slot + 2] = pz;
      ++slot;
    }
  }
  for (; slot < S; ++slot) {
    t_row[slot] = 0.0f;
    dt_row[slot] = 0.0f;
    v_row[slot] = false;
    xyz_row[3 * slot] = 0.0f;
    xyz_row[3 * slot + 1] = 0.0f;
    xyz_row[3 * slot + 2] = 0.0f;
  }
  count_out[n] = count;
}

}  // namespace

extern "C" int march_rays_fwd(const void* rays_o, const void* rays_d,
                              const void* nears, const void* fars,
                              const void* t_lo, const void* t_hi,
                              const void* sigma_bytes, void* t, void* dt,
                              void* valid, void* xyz, void* count, long long N,
                              int K, int S, int H, float bound, float mip_bound,
                              float dt_step, int use_cull, float log_cull,
                              void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  march_rays_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)nears,
      (const float*)fars, (const float*)t_lo, (const float*)t_hi,
      (const uint8_t*)sigma_bytes, (float*)t, (float*)dt, (bool*)valid,
      (float*)xyz, (int*)count, N, K, S, H, bound, mip_bound, dt_step, use_cull,
      log_cull);
  return (int)cudaGetLastError();
}
