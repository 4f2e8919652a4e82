// Kernel B: occupancy-grid ray marcher over the sigma-byte field.
//
// Replaces radnerf_tpu/ops/marching.py: march_rays (:374-520, the affine
// branch with sigma_byte_lookup :267-298 and the transmittance cull) and the
// marched window of models/renderer.py march_window (:470-487), whose
// [t_lo, t_hi] it takes as input. The TPU form evaluated the whole [N, K]
// orbit lattice densely (one wide-row gather per orbit point, then a cumsum
// and a one-hot contraction to pick the first S occupied points) because a
// TPU has no per-ray control flow. On Hopper each ray walks its orbit and
// stops at the window end.
//
// What bounds it on an H100: bytes. Per ray it reads 32-36 B of geometry
// and writes S slots of t, dt, valid and xyz (21 B each, 336 B at S = 16:
// 88 MB for a 512x512 frame, 94% of it zeros); the sigma-byte field is 2 MB
// at H = 128 and stays in L2. Design:
//
// - A cooperative walk. A group of G consecutive lanes takes one ray and G
//   consecutive orbit steps at once, so G byte lookups are in flight
//   together (G = 8: four rays a warp); the group walks on while its last
//   step is inside the window (t is non-decreasing along the orbit) and
//   never past K. A warp loops while any of its 32 / G groups walks, so
//   every shuffle and ballot is warp-wide.
// - The occupied steps come from a ballot; a kept step's slot is the
//   group's count so far plus the kept lanes below it, and the count goes
//   on past S to the window end (it is the max_count telemetry).
// - The cull sum stays a sequential float32 sum in orbit order: every lane
//   of a group adds the group's G estimates one at a time, in lane order,
//   from shuffles (an unoccupied step adds an exact 0.0, as the twin's
//   cumsum does), so no tree scan rounds it differently.
// - Stores staged in shared memory. A block takes R = 256 / G consecutive
//   rays (fewer where S is large), zero-fills their t, dt, valid, xyz and
//   count rows in shared memory, walks, then writes each output's
//   contiguous range [R * S] (xyz [R * S * 3]) with 16-byte stores, scalar
//   ones at the range's edges: every sector is written whole, once.
// - Index math in 32 bits inside a block, from a 64-bit base per block.
//
// Arithmetic mirrors the plain twin (ops/marching.py march_rays_plain) op
// for op: t = t0 + (k0 + k) * dt and o + t * d are rounded per operation
// (-fmad=false), so every point lands in the twin's cell. The cull tests
// (incl - est) <= -ln(cull_T) with incl the float32 running sum, which is
// the JAX path's cumsum(est) - est.
//
// Training perturbs each ray's orbit origin (marching.py:427-429):
// t0 = near + dt * noise with noise in [0, 1) (on the affine orbit the
// clamped step _clamp_dt(near) is exactly dt), and the window's k0 is taken
// from the perturbed t0 (:441). A null noises pointer means no perturbation;
// the inference frame passes null.
//
// G is a compile-time constant, 8. On an H100 at the frame's shapes G = 8
// took 0.060 ms, 16 0.089 and 32 0.157: the walks are short (at most 28
// steps in the frame's window), so a smaller group wastes fewer lanes past
// the window end, shares a warp's per-ray setup among more rays and runs a
// shorter cull chain. The launch bound
// holds a thread to 32 registers so an SM keeps 8 blocks (2,048 threads)
// in flight: 0.060 ms against 0.076 at the 58 registers the compiler took
// unbounded (PERF.md).

// The general orbit and the mip cascade (kOrbit and kCascade below,
// template arguments, so the affine orbit at cascade 1 carries none of
// their code; one entry point takes every orbit and cascade) take the rest
// of JAX's march: the general orbit t_{k+1} = t_k + clamp(t_k * dt_gamma,
// dt_min, dt_max) (marching.py:108 _orbit, the non-affine branch
// :445-453) and the mip cascade (:126 _mip_level). The recurrence is sequential, so a group
// cannot take G consecutive steps at once as on the affine orbit: every
// lane of the group walks the G steps of the chunk in turn from the chunk's
// first t, each step's multiply, clamp and add rounded in float32 as the
// plain version rounds them, and keeps its own step's t and dt; then the
// group does its G lookups together, as on the affine orbit. A warp issues
// the walk's instructions once whether one lane of a group or all of them
// run it, so the group's other lanes walk for free; one lane walking and
// shuffling each step's t and dt out to its lane issues the same walk and
// 2G shuffles more, and was 1.11-1.16x slower on the variants run's calls
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md). The walk starts at t0 =
// near + clamp(near * dt_gamma, dt_min, dt_max) * noise (:427-429) and
// counts K steps from there; the window's t_hi only ends it (JAX's general
// branch does not skip to t_lo, and neither does this kernel: it looks up
// every step from t0). At cascade > 1 a point's level is clip(max(e(max|p|),
// e(dt * H * 0.5)), 0, C - 1), e the frexpf exponent from the float's
// bits, and its cell level * H^3 + morton(floor(0.5 * (p / min(2^level,
// bound) + 1) * H)) (:276-285).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;  // lanes a ray: 8, 16 or 32 (a power of two, at most a warp)
static_assert(kGroup == 8 || kGroup == 16 || kGroup == 32, "kGroup is 8, 16 or 32");
constexpr int kThreads = 256;               // R = kThreads / G rays a block at most
constexpr int kMinBlocks = 8;               // blocks an SM holds: 32 registers a thread
constexpr int kDefaultSmem = 48 * 1024;     // above this a launch needs the opt-in
constexpr int kMaxSmem = 227 * 1024;        // what a block may opt in to on Hopper
constexpr unsigned kFull = 0xffffffffu;

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

// p / mip_bound is p itself where mip_bound is 1 (the shipped bound), and
// skipping the IEEE division there is measurable: B took 0.0601 ms against
// 0.0642 at the frame's shapes and 0.0503 against 0.0557 at the step's
// (NVIDIA H100 80GB HBM3, 700 W, in turns on the same tensors; PERF.md)
__device__ __forceinline__ uint32_t cell_coord(float p, float mip_bound, float H) {
  const float u = mip_bound == 1.0f ? p : p / mip_bound;
  const float c = clampf(floorf(0.5f * (u + 1.0f) * H), 0.0f, H - 1.0f);
  return (uint32_t)c;
}

// frexpf's exponent of v > 0 from its bits (biased exponent - 126), 0 for
// v <= 0, as JAX's _mip_level takes it
__device__ __forceinline__ int frexp_exponent(float v) {
  return v > 0.0f ? ((__float_as_int(v) >> 23) & 0xFF) - 126 : 0;
}

// The cascade level of a point p with step dt, and the bound of its level's
// box: min(2^level, bound)
__device__ __forceinline__ int mip_level(float px, float py, float pz, float dt, float H,
                                         int cascade) {
  const float mx = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
  const int e = max(frexp_exponent(mx), frexp_exponent(dt * H * 0.5f));
  return min(max(e, 0), cascade - 1);
}

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A block's output rows in shared memory: t and dt regions of f1 floats,
// the xyz region of f3 floats, the valid region of vb bytes, R counts.
// Each region starts 16-byte aligned and leaves room to put its element 0
// at the offset that gives it its global address's alignment mod 16.
struct TileLayout {
  int f1, f3, vb, bytes;
};

__host__ __device__ __forceinline__ TileLayout tile_layout(int R, int S) {
  TileLayout L;
  L.f1 = round_up(R * S + 3, 4);
  L.f3 = round_up(3 * R * S + 3, 4);
  L.vb = round_up(R * S + 15, 16);
  L.bytes = 4 * (2 * L.f1 + L.f3) + L.vb + round_up(4 * R, 16);
  return L;
}

// where element 0 of the global range starting at dst sits in a region
template <typename T>
__device__ __forceinline__ T* aligned_like(T* region, const T* dst) {
  return region + ((uintptr_t)dst & 15) / sizeof(T);
}

// dst[0, n) = src[0, n) by the whole block: scalar stores up to dst's first
// 16-byte boundary, 16-byte stores, scalar stores for the tail. src has
// dst's alignment mod 16 (aligned_like).
template <typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(T));
  head = head < n ? head : n;
  for (int i = tid; i < head; i += nt) dst[i] = src[i];
  const int n_vec = (n - head) / V;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (int i = tid; i < n_vec; i += nt) dv[i] = sv[i];
  for (int i = head + n_vec * V + tid; i < n; i += nt) dst[i] = src[i];
}

// kOrbit: the general orbit (false: the affine one, t0 + (k0 + k) * dt);
// kCascade: cascade > 1 (false: one level of mip_bound)
template <bool kOrbit, bool kCascade>
__global__ void __launch_bounds__(kThreads, kMinBlocks) march_rays_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ nears, const float* __restrict__ fars,
    const float* __restrict__ t_lo, const float* __restrict__ t_hi,
    const float* __restrict__ noises, const uint8_t* __restrict__ sigma_bytes,
    float* __restrict__ t_out, float* __restrict__ dt_out, uint8_t* __restrict__ valid_out,
    float* __restrict__ xyz_out, int* __restrict__ count_out, int N, int K, int S, int R,
    int H, float bound, float mip_bound, float dt, int use_cull, float log_cull,
    int cascade, float dt_gamma, float dt_max) {
  extern __shared__ uint4 smem[];
  const TileLayout L = tile_layout(R, S);
  const int n0 = blockIdx.x * R;
  const int rays = min(R, N - n0);
  const size_t g0 = (size_t)n0 * S;  // the block's first slot
  float* const t_dst = t_out + g0;
  float* const dt_dst = dt_out + g0;
  float* const xyz_dst = xyz_out + 3 * g0;
  uint8_t* const v_dst = valid_out + g0;
  float* const t_tile = aligned_like((float*)smem, t_dst);
  float* const dt_tile = aligned_like((float*)smem + L.f1, dt_dst);
  float* const xyz_tile = aligned_like((float*)smem + 2 * L.f1, xyz_dst);
  uint8_t* const v_tile = aligned_like((uint8_t*)smem + 4 * (2 * L.f1 + L.f3), v_dst);
  int* const count_tile = (int*)((uint8_t*)smem + 4 * (2 * L.f1 + L.f3) + L.vb);

  for (int i = threadIdx.x; i < L.bytes / 16; i += blockDim.x) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int r = threadIdx.x / kGroup, gl = threadIdx.x % kGroup;
  const int lane = threadIdx.x & 31;
  const unsigned group_bits = (kFull >> (32 - kGroup)) << (lane & ~(kGroup - 1));
  const unsigned lanes_below = (1u << lane) - 1u;
  const int n = n0 + r;
  bool live = r < rays;  // the group's ray still walks
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t0 = 0.0f, k0 = 0.0f, t_end = 0.0f;
  if (live) {
    ox = rays_o[3 * n], oy = rays_o[3 * n + 1], oz = rays_o[3 * n + 2];
    dx = rays_d[3 * n], dy = rays_d[3 * n + 1], dz = rays_d[3 * n + 2];
    if constexpr (kOrbit) {
      // dt is dt_min; the walk starts at t0 (k0 stays 0)
      const float near = nears[n];
      t0 = noises != nullptr ? near + clampf(near * dt_gamma, dt, dt_max) * noises[n] : near;
    } else {
      t0 = noises != nullptr ? nears[n] + dt * noises[n] : nears[n];
      k0 = floorf((t_lo[n] - t0) / dt);
      k0 = k0 < 0.0f ? 0.0f : k0;  // NaN stays NaN, as in the twin
    }
    t_end = min_nan(fars[n], t_hi[n]);
  }
  float tc = t0;  // the general orbit: t at the chunk's first step
  const float Hf = (float)H;
  float incl = 0.0f;  // the cull's running sum, in orbit order
  int count = 0;      // kept steps so far
  for (int kc = 0; __any_sync(kFull, live); kc += kGroup) {
    const int k = kc + gl;
    bool walk = false, occ = false;
    float t = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
    float step = dt;  // this lane's step size
    uint32_t byte = 0;
    if constexpr (kOrbit) {
      // every lane of the group walks the chunk's G steps in turn
      float tw = tc;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float dj = clampf(tw * dt_gamma, dt, dt_max);
        if (j == gl) t = tw, step = dj;
        tw = tw + dj;
      }
      tc = tw;
    }
    if (live && k < K) {
      if constexpr (!kOrbit) t = t0 + (k0 + (float)k) * dt;
      walk = t < t_end;
      if (walk) {
        px = clampf(ox + t * dx, -bound, bound);
        py = clampf(oy + t * dy, -bound, bound);
        pz = clampf(oz + t * dz, -bound, bound);
        if constexpr (kCascade) {
          const int level = mip_level(px, py, pz, step, Hf, cascade);
          const float mb = fminf((float)(1 << level), bound);
          byte = sigma_bytes[(uint32_t)level * (uint32_t)(H * H * H) +
                             morton3d(cell_coord(px, mb, Hf), cell_coord(py, mb, Hf),
                                      cell_coord(pz, mb, Hf))];
        } else {
          byte = sigma_bytes[morton3d(cell_coord(px, mip_bound, Hf),
                                      cell_coord(py, mip_bound, Hf),
                                      cell_coord(pz, mip_bound, Hf))];
        }
        occ = (byte & 128u) != 0;
      }
    }
    bool kept = occ;
    if (use_cull && __any_sync(kFull, occ)) {
      float est = 0.0f;
      if (occ) {
        const uint32_t q = byte & 127u;
        const float sig = q > 0 ? exp2f(((float)q - 40.0f) * 0.25f) : 0.0f;
        est = sig * step * kCullSafety;
      }
      float mine = 0.0f;  // incl after this lane's step
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        incl = incl + __shfl_sync(kFull, est, j, kGroup);
        mine = j == gl ? incl : mine;
      }
      kept = occ && (mine - est) <= log_cull;
    }
    const unsigned kept_bits = __ballot_sync(kFull, kept) & group_bits;
    if (kept) {
      const int slot = count + __popc(kept_bits & lanes_below);
      if (slot < S) {
        const int i = r * S + slot;
        t_tile[i] = t;
        dt_tile[i] = step;
        v_tile[i] = 1;
        xyz_tile[3 * i] = px;
        xyz_tile[3 * i + 1] = py;
        xyz_tile[3 * i + 2] = pz;
      }
    }
    count += __popc(kept_bits);
    // on while the group's last step was inside the window and K goes on
    // (the ballot before the &&: every lane of the warp takes part in it)
    const unsigned walk_bits = __ballot_sync(kFull, walk) & group_bits;
    live = live && walk_bits == group_bits && kc + kGroup < K;
  }
  if (gl == 0 && r < rays) count_tile[r] = count;
  __syncthreads();

  copy_out(t_dst, t_tile, rays * S);
  copy_out(dt_dst, dt_tile, rays * S);
  copy_out(xyz_dst, xyz_tile, 3 * rays * S);
  copy_out(v_dst, v_tile, rays * S);
  for (int i = threadIdx.x; i < rays; i += blockDim.x) count_out[n0 + i] = count_tile[i];
}

template <bool kOrbit, bool kCascade>
int launch(const void* rays_o, const void* rays_d, const void* nears, const void* fars,
           const void* t_lo, const void* t_hi, const void* noises, const void* sigma_bytes,
           void* t, void* dt, void* valid, void* xyz, void* count, long long N, int K, int S,
           int H, float bound, float mip_bound, float dt_step, int use_cull, float log_cull,
           int cascade, float dt_gamma, float dt_max, void* stream) {
  if (N < 0 || N > 0x7fffffffLL - kThreads || S < 1 || K < 0) {
    return (int)cudaErrorInvalidValue;
  }
  // R rays a block: 256 / G, halved while the tile does not fit the default
  // 48 KB but never below one full warp; a larger tile opts in to up to
  // 227 KB (S = 2,048 takes 172 KB at four rays a block)
  int R = kThreads / kGroup;
  while (R > 32 / kGroup && tile_layout(R, S).bytes > kDefaultSmem) R /= 2;
  const int smem = tile_layout(R, S).bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_rays_kernel<kOrbit, kCascade>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  if (blocks == 0) return 0;
  march_rays_kernel<kOrbit, kCascade><<<blocks, R * kGroup, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)nears,
      (const float*)fars, (const float*)t_lo, (const float*)t_hi,
      (const float*)noises, (const uint8_t*)sigma_bytes, (float*)t, (float*)dt,
      (uint8_t*)valid, (float*)xyz, (int*)count, (int)N, K, S, R, H, bound, mip_bound,
      dt_step, use_cull, log_cull, cascade, dt_gamma, dt_max);
  return (int)cudaGetLastError();
}

}  // namespace

// the general orbit (affine 0) or the affine one (affine 1: dt = dt_min), at
// any cascade; sigma_bytes [cascade * H^3]
extern "C" int march_rays_fwd(const void* rays_o, const void* rays_d, const void* nears,
                              const void* fars, const void* t_lo, const void* t_hi,
                              const void* noises, const void* sigma_bytes, void* t, void* dt,
                              void* valid, void* xyz, void* count, long long N, int K, int S,
                              int H, int cascade, float bound, float dt_gamma, float dt_min,
                              float dt_max, int affine, int use_cull, float log_cull,
                              void* stream) {
  if (cascade < 1 || cascade > 8 || (long long)cascade * H * H * H > 0xffffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const float mip_bound = bound < 1.0f ? bound : 1.0f;  // cascade 1: min(1, bound)
#define MARCH_ARGS                                                                          \
  rays_o, rays_d, nears, fars, t_lo, t_hi, noises, sigma_bytes, t, dt, valid, xyz, count,  \
      N, K, S, H, bound, mip_bound, dt_min, use_cull, log_cull, cascade, dt_gamma, dt_max,  \
      stream
  if (affine) {
    return cascade > 1 ? launch<false, true>(MARCH_ARGS) : launch<false, false>(MARCH_ARGS);
  }
  return cascade > 1 ? launch<true, true>(MARCH_ARGS) : launch<true, false>(MARCH_ARGS);
#undef MARCH_ARGS
}
