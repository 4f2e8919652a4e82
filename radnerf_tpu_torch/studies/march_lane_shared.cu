// A design of kernels B-grouped and B-bitfield's float-grid cull measured
// by the attribution study (radnerf_tpu_torch/studies/march.py) and not on
// the path: as march_lane_registers.cu, with each thread's 4 fine estimates
// in shared memory, the fine pass skipped where no lane of the warp
// marches, both culls looping over the lanes that add more than 0, and
// B-bitfield's grid value loaded beside the bit. Bit for bit with the
// twins; slower than the path's kernels (NVIDIA H100 80GB HBM3, 700 W:
// B-grouped 0.88x / 0.89x the parent's time on the sparse / portrait frame
// against the path's 0.82x / 0.85x; B-bitfield with the cull 1.02x / 0.92x
// on the bench rays / at S = 128 against 0.95x / 0.73x; PERF.md).
//
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

// B-bitfield (kBits below, a third template argument of the same kernel
// and entry point): JAX's march without sigma_rows (marching.py:466-470),
// occupancy from bit index & 7 of byte index >> 3 of the packed bitfield
// (:147 occupancy_lookup), no cull on the occupancy. With a float grid it
// culls the selected samples (:490-509) inside the walk: the selected
// samples are the first S occupied steps in orbit order, so a lane that
// stages slot < S looks up max(grid[cell], 0) * 0.25 at the cell of its
// own step (the cell its bit came from) and the group adds it, times dt,
// to the ray's float32 running sum in slot order from shuffles, as B's
// cull adds; the slot is staged only if the sum before it is within
// -ln(cull_T). No slot is staged and then erased, and nothing is read back
// from the tile. The walk goes on counting occupied steps for count, the
// occupied count before selection and cull (:519). The lookups go on after
// the first culled slot: fl(fl(s + a) - a) can fall below s, so a large
// estimate can bring a later slot back under the limit, as it does in the
// twin; only a sum that is no longer finite culls every later slot.
//
// B-grouped (march_rays_grouped_kernel, its own entry point): the two-level
// march (marching.py:523 march_rays_grouped) on the affine orbit at
// cascade 1. A group of 8 lanes takes a ray, as in B; the lanes look up 8
// consecutive coarse groups (4 orbit steps each) at their centres
// t0 + (k0 + 4 j + 1.5) dt in the supercell bytes at grid H / 4, keep the
// occupied ones whose start t0 + (k0 + 4 j) dt is inside the window, and
// run the coarse cull as B runs its cull (sigma_c * f32(4 dt) * 0.5,
// shuffled in group order). Each lane then fine-marches its own group if
// the group is among the ray's first group_slots kept ones: its 4 steps'
// sigma-byte lookups are independent, so a lane has 4 in flight, and a ray
// that keeps its whole window in 8 groups (the portrait frame's 7) takes
// one pass. The fine cull's float32 sum stays in orbit order: lane by lane
// from shuffles, each lane's 4 estimates in turn (never a tree scan);
// slots come from the kept counts of the lanes below, summed in binary by
// three ballots. The kernel keeps B's occupancy (32 registers, 8 blocks an
// SM) and stages its rows in shared memory as B does. The
// coarse field is 32 KB at H = 128 and stays in L1/L2; no global
// compaction buffer: the TPU's marker scatter, group-id bitmask and slab
// return (:616-700) have no counterpart. groups_out is the kept-group count
// before the group_slots truncation (the n_groups_needed / n_group_max
// telemetry, :612-614).

#include <cfloat>
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

// the flat sigma-byte cell of clipped point p with step dt: at cascade 1
// its Morton cell in the box of mip_bound, else level * H^3 + the Morton
// cell in its level's box (the plain version's _cells)
template <bool kCascade>
__device__ __forceinline__ uint32_t point_cell(float px, float py, float pz, float dt, int H,
                                               float Hf, float mip_bound, float bound,
                                               int cascade) {
  if constexpr (kCascade) {
    const int level = mip_level(px, py, pz, dt, Hf, cascade);
    const float mb = fminf((float)(1 << level), bound);
    return (uint32_t)level * (uint32_t)(H * H * H) +
           morton3d(cell_coord(px, mb, Hf), cell_coord(py, mb, Hf), cell_coord(pz, mb, Hf));
  } else {
    return morton3d(cell_coord(px, mip_bound, Hf), cell_coord(py, mip_bound, Hf),
                    cell_coord(pz, mip_bound, Hf));
  }
}

// the cull's lower-bound sigma of a 7-bit code (dequant_sigma)
__device__ __forceinline__ float dequant(uint32_t q) {
  return q > 0 ? exp2f(((float)q - 40.0f) * 0.25f) : 0.0f;
}

// component i (a constant after unrolling) of a float4
__device__ __forceinline__ float& component(float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// bit l set where lane l of any group of the warp has its bit set in bits
// (a warp ballot)
__device__ __forceinline__ unsigned group_lanes(unsigned bits) {
#pragma unroll
  for (int s = 16; s >= kGroup; s >>= 1) bits |= bits >> s;
  return bits & (kFull >> (32 - kGroup));
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

// A block's staged output rows: R rays of S slots in shared memory, laid
// out by tile_layout with each region aligned as its global range
struct Tiles {
  float* t;
  float* dt;
  float* xyz;
  uint8_t* v;
  int* count;
  float *t_dst, *dt_dst, *xyz_dst;
  uint8_t* v_dst;
};

// the block's tiles over rays n0 .. n0 + R - 1, zero-filled
__device__ __forceinline__ Tiles block_tiles(uint4* smem, const TileLayout& L, int n0, int S,
                                             float* t_out, float* dt_out, uint8_t* valid_out,
                                             float* xyz_out) {
  const size_t g0 = (size_t)n0 * S;  // the block's first slot
  Tiles T;
  T.t_dst = t_out + g0;
  T.dt_dst = dt_out + g0;
  T.xyz_dst = xyz_out + 3 * g0;
  T.v_dst = valid_out + g0;
  T.t = aligned_like((float*)smem, T.t_dst);
  T.dt = aligned_like((float*)smem + L.f1, T.dt_dst);
  T.xyz = aligned_like((float*)smem + 2 * L.f1, T.xyz_dst);
  T.v = aligned_like((uint8_t*)smem + 4 * (2 * L.f1 + L.f3), T.v_dst);
  T.count = (int*)((uint8_t*)smem + 4 * (2 * L.f1 + L.f3) + L.vb);
  for (int i = threadIdx.x; i < L.bytes / 16; i += blockDim.x) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  return T;
}

__device__ __forceinline__ void stage_slot(const Tiles& T, int i, float t, float dt, float px,
                                           float py, float pz) {
  T.t[i] = t;
  T.dt[i] = dt;
  T.v[i] = 1;
  T.xyz[3 * i] = px;
  T.xyz[3 * i + 1] = py;
  T.xyz[3 * i + 2] = pz;
}

// after the walk: the block's rows and counts out (the block synchronises
// first)
__device__ __forceinline__ void write_tiles(const Tiles& T, int rays, int S, int n0,
                                            int* __restrict__ count_out) {
  __syncthreads();
  copy_out(T.t_dst, T.t, rays * S);
  copy_out(T.dt_dst, T.dt, rays * S);
  copy_out(T.xyz_dst, T.xyz, 3 * rays * S);
  copy_out(T.v_dst, T.v, rays * S);
  for (int i = threadIdx.x; i < rays; i += blockDim.x) count_out[n0 + i] = T.count[i];
}

// rays per block: 256 / G, halved while the tile (and thread_bytes a
// thread after it) does not fit the default 48 KB but never below one full
// warp; a larger tile opts in to up to 227 KB
// (S = 2,048 takes 172 KB at four rays a block). Returns R, or 0 if the
// tile does not fit; sets the opt-in on fn where the tile needs it.
template <typename Fn>
int block_rays(Fn fn, int S, int* smem, cudaError_t* err, int thread_bytes = 0) {
  int R = kThreads / kGroup;
  while (R > 32 / kGroup && tile_layout(R, S).bytes + R * kGroup * thread_bytes > kDefaultSmem)
    R /= 2;
  *smem = tile_layout(R, S).bytes + R * kGroup * thread_bytes;
  *err = cudaSuccess;
  if (*smem > kMaxSmem) return 0;
  if (*smem > kDefaultSmem) {
    *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (*err != cudaSuccess) return 0;
  }
  return R;
}

// kOrbit: the general orbit (false: the affine one, t0 + (k0 + k) * dt);
// kCascade: cascade > 1 (false: one level of mip_bound); kBits: occupancy
// from the bitfield, the float-grid cull on the selected slots (false: the
// sigma bytes with the cull on the occupied steps)
template <bool kOrbit, bool kCascade, bool kBits>
__global__ void __launch_bounds__(kThreads, kMinBlocks) march_rays_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ nears, const float* __restrict__ fars,
    const float* __restrict__ t_lo, const float* __restrict__ t_hi,
    const float* __restrict__ noises, const uint8_t* __restrict__ field,
    const float* __restrict__ sigma_grid, float* __restrict__ t_out,
    float* __restrict__ dt_out, uint8_t* __restrict__ valid_out, float* __restrict__ xyz_out,
    int* __restrict__ count_out, int N, int K, int S, int R, int H, float bound,
    float mip_bound, float dt, int use_cull, float log_cull, int cascade, float dt_gamma,
    float dt_max) {
  extern __shared__ uint4 smem[];
  const TileLayout L = tile_layout(R, S);
  const int n0 = blockIdx.x * R;
  const int rays = min(R, N - n0);
  const Tiles T = block_tiles(smem, L, n0, S, t_out, dt_out, valid_out, xyz_out);

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
  float incl = 0.0f;      // the cull's running sum, in orbit order
  float grid_sum = 0.0f;  // B-bitfield: the float-grid cull's, in slot order
  int count = 0;          // kept steps so far
  for (int kc = 0; __any_sync(kFull, live); kc += kGroup) {
    const int k = kc + gl;
    bool walk = false, occ = false;
    float t = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
    float step = dt;  // this lane's step size
    uint32_t byte = 0;
    float grid = 0.0f;  // B-bitfield: the float grid at the step's cell
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
        const uint32_t cell =
            point_cell<kCascade>(px, py, pz, step, H, Hf, mip_bound, bound, cascade);
        if constexpr (kBits) {
          occ = ((field[cell >> 3] >> (cell & 7u)) & 1u) != 0;
          // the cull's grid value, loaded beside the bit while the ray may
          // still select a slot (the load is not left to wait on the bit)
          if (use_cull && count < S && grid_sum <= FLT_MAX) grid = sigma_grid[cell];
        } else {
          byte = field[cell];
          occ = (byte & 128u) != 0;
        }
      }
    }
    bool kept = occ;
    if (!kBits && use_cull && __any_sync(kFull, occ)) {
      const float est = occ ? dequant(byte & 127u) * step * kCullSafety : 0.0f;
      float mine = 0.0f;  // incl after this lane's step
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        incl = incl + __shfl_sync(kFull, est, j, kGroup);
        mine = j == gl ? incl : mine;
      }
      kept = occ && (mine - est) <= log_cull;
    }
    const unsigned kept_bits = __ballot_sync(kFull, kept) & group_bits;
    if constexpr (kBits) {
      if (use_cull) {
        // the float-grid cull on the slots this chunk selects, in slot order
        // (a sum that is no longer finite culls them all)
        const bool selected =
            kept && count + __popc(kept_bits & lanes_below) < S && grid_sum <= FLT_MAX;
        // NaN kept, as the twin's clamp
        const float own = selected ? (grid < 0.0f ? 0.0f : grid) * 0.25f * step : 0.0f;
        float mine = 0.0f;  // the sum after this lane's slot
        // lanes that select in no group of the warp add an exact 0: skipped
        for (unsigned src = group_lanes(__ballot_sync(kFull, selected)); src; src &= src - 1) {
          const int l = __ffs(src) - 1;
          grid_sum = grid_sum + __shfl_sync(kFull, own, l, kGroup);
          mine = l == gl ? grid_sum : mine;
        }
        kept = selected && (mine - own) <= log_cull;
      }
    }
    if (kept) {
      const int slot = count + __popc(kept_bits & lanes_below);
      if (slot < S) stage_slot(T, r * S + slot, t, step, px, py, pz);
    }
    count += __popc(kept_bits);
    // on while the group's last step was inside the window and K goes on
    // (the ballot before the &&: every lane of the warp takes part in it)
    const unsigned walk_bits = __ballot_sync(kFull, walk) & group_bits;
    live = live && walk_bits == group_bits && kc + kGroup < K;
  }
  if (gl == 0 && r < rays) T.count[r] = count;
  write_tiles(T, rays, S, n0, count_out);
}

constexpr int kMarch = 4;                        // fine steps a coarse group (MARCH_GROUP)
constexpr int kGroupedMinBlocks = kMinBlocks;    // B's occupancy: 32 registers a thread

__global__ void __launch_bounds__(kThreads, kGroupedMinBlocks) march_rays_grouped_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ nears, const float* __restrict__ fars,
    const float* __restrict__ t_lo, const float* __restrict__ t_hi,
    const float* __restrict__ noises, const uint8_t* __restrict__ sigma_bytes,
    const uint8_t* __restrict__ coarse, float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, float* __restrict__ xyz_out, int* __restrict__ count_out,
    int* __restrict__ groups_out, int N, int K, int S, int R, int H, int group_slots,
    float bound, float mip_bound, float dt, float dt_group, int use_cull, float log_cull) {
  extern __shared__ uint4 smem[];
  const TileLayout L = tile_layout(R, S);
  const int n0 = blockIdx.x * R;
  const int rays = min(R, N - n0);
  const Tiles T = block_tiles(smem, L, n0, S, t_out, dt_out, valid_out, xyz_out);
  // each thread's 4 fine estimates, after the tile (kept out of registers)
  float4* est = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(smem) + L.bytes);

  const int r = threadIdx.x / kGroup, gl = threadIdx.x % kGroup;
  const int lane = threadIdx.x & 31;
  const unsigned group_bits = (kFull >> (32 - kGroup)) << (lane & ~(kGroup - 1));
  const unsigned lanes_below = (1u << lane) - 1u;
  const int Kg = (K + kMarch - 1) / kMarch;
  const int n = n0 + r;
  bool live = r < rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t0 = 0.0f, k0 = 0.0f, t_end = 0.0f;
  if (live) {
    ox = rays_o[3 * n], oy = rays_o[3 * n + 1], oz = rays_o[3 * n + 2];
    dx = rays_d[3 * n], dy = rays_d[3 * n + 1], dz = rays_d[3 * n + 2];
    t0 = noises != nullptr ? nears[n] + dt * noises[n] : nears[n];
    k0 = floorf((t_lo[n] - t0) / dt);
    k0 = k0 < 0.0f ? 0.0f : k0;  // NaN stays NaN, as in the twin
    t_end = min_nan(fars[n], t_hi[n]);
  }
  const float Hf = (float)H, Hc = (float)(H / kMarch);
  float incl_c = 0.0f, incl_f = 0.0f;  // the coarse and fine culls' running sums
  int count = 0;  // kept fine steps so far
  int kept = 0;   // kept groups so far
  for (int jc = 0; __any_sync(kFull, live); jc += kGroup) {
    // the coarse pass: this lane's group j, from step k0 + 4 j
    const int j = jc + gl;
    const float kb = k0 + (float)(j * kMarch);
    bool walk = false, m = false;
    uint32_t byte = 0;
    if (live && j < Kg) {
      walk = t0 + kb * dt < t_end;  // the group starts inside the window
      if (walk) {
        const float tc = t0 + (kb + 1.5f) * dt;
        const float px = clampf(ox + tc * dx, -bound, bound);
        const float py = clampf(oy + tc * dy, -bound, bound);
        const float pz = clampf(oz + tc * dz, -bound, bound);
        byte = coarse[morton3d(cell_coord(px, mip_bound, Hc), cell_coord(py, mip_bound, Hc),
                               cell_coord(pz, mip_bound, Hc))];
        m = (byte & 128u) != 0;
      }
    }
    if (use_cull && __any_sync(kFull, m)) {
      const float est = m ? dequant(byte & 127u) * dt_group * kCullSafety : 0.0f;
      float mine = 0.0f;
      // lanes whose group is kept in no ray of the warp add an exact 0: skipped
      for (unsigned src = group_lanes(__ballot_sync(kFull, m)); src; src &= src - 1) {
        const int l = __ffs(src) - 1;
        incl_c = incl_c + __shfl_sync(kFull, est, l, kGroup);
        mine = l == gl ? incl_c : mine;
      }
      m = m && (mine - est) <= log_cull;
    }
    const unsigned m_bits = __ballot_sync(kFull, m) & group_bits;
    // the fine pass: the lane marches its own group's 4 steps if the group
    // is among the ray's first group_slots kept ones (k = (k0 + 4 j) + i,
    // as JAX's fine pass forms it; the last group stops at K)
    const bool marched = m && kept + __popc(m_bits & lanes_below) < group_slots;
    if (__any_sync(kFull, marched)) {
      uint32_t occ = 0;  // bit i: step i occupied
      float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // its cull estimate, 0 where not
#pragma unroll
      for (int i = 0; i < kMarch; ++i) {
        const float t = t0 + (kb + (float)i) * dt;
        if (marched && j * kMarch + i < K && t < t_end) {
          const uint32_t fb =
              sigma_bytes[morton3d(cell_coord(clampf(ox + t * dx, -bound, bound), mip_bound, Hf),
                                   cell_coord(clampf(oy + t * dy, -bound, bound), mip_bound, Hf),
                                   cell_coord(clampf(oz + t * dz, -bound, bound), mip_bound, Hf))];
          if (fb & 128u) {
            occ |= 1u << i;
            component(e, i) = dequant(fb & 127u) * dt * kCullSafety;
          }
        }
      }
      uint32_t keep = occ;
      if (use_cull) {
        // the fine cull's sum in orbit order: lane by lane, each lane's 4
        // estimates in turn, read from the shared estimates (lanes whose
        // group has no occupied step in any ray of the warp add an exact 0:
        // skipped); each lane tests its own steps as their turn comes
        est[threadIdx.x] = e;
        __syncwarp();
        const float4* group_est = est + (threadIdx.x & ~(kGroup - 1));
        for (unsigned src = group_lanes(__ballot_sync(kFull, occ != 0)); src; src &= src - 1) {
          const int l = __ffs(src) - 1;
          const float4 f = group_est[l];
#pragma unroll
          for (int i = 0; i < kMarch; ++i) {
            incl_f = incl_f + component(f, i);
            if (l == gl && !((incl_f - component(f, i)) <= log_cull)) keep &= ~(1u << i);
          }
        }
        __syncwarp();
      }
      // slots: the kept steps of the group's lanes below, summed in binary
      // from three ballots
      const int n_keep = __popc(keep);
      const unsigned c1 = __ballot_sync(kFull, n_keep & 1) & group_bits;
      const unsigned c2 = __ballot_sync(kFull, n_keep & 2) & group_bits;
      const unsigned c4 = __ballot_sync(kFull, n_keep & 4) & group_bits;
      int slot = count + __popc(c1 & lanes_below) + 2 * __popc(c2 & lanes_below) +
                 4 * __popc(c4 & lanes_below);
#pragma unroll
      for (int i = 0; i < kMarch; ++i) {
        if ((keep >> i) & 1u) {
          if (slot < S) {
            const float t = t0 + (kb + (float)i) * dt;
            stage_slot(T, r * S + slot, t, dt, clampf(ox + t * dx, -bound, bound),
                       clampf(oy + t * dy, -bound, bound), clampf(oz + t * dz, -bound, bound));
          }
          ++slot;
        }
      }
      count += __popc(c1) + 2 * __popc(c2) + 4 * __popc(c4);
    }
    kept += __popc(m_bits);
    // on while the chunk's last group started inside the window and Kg goes on
    const unsigned walk_bits = __ballot_sync(kFull, walk) & group_bits;
    live = live && walk_bits == group_bits && jc + kGroup < Kg;
  }
  if (gl == 0 && r < rays) {
    T.count[r] = count;
    groups_out[n] = kept;
  }
  write_tiles(T, rays, S, n0, count_out);
}

template <bool kOrbit, bool kCascade, bool kBits>
int launch(const void* rays_o, const void* rays_d, const void* nears, const void* fars,
           const void* t_lo, const void* t_hi, const void* noises, const void* field,
           const void* sigma_grid, void* t, void* dt, void* valid, void* xyz, void* count,
           long long N, int K, int S, int H, float bound, float mip_bound, float dt_step,
           int use_cull, float log_cull, int cascade, float dt_gamma, float dt_max,
           void* stream) {
  if (N < 0 || N > 0x7fffffffLL - kThreads || S < 1 || K < 0) {
    return (int)cudaErrorInvalidValue;
  }
  int smem;
  cudaError_t err;
  const int R = block_rays(march_rays_kernel<kOrbit, kCascade, kBits>, S, &smem, &err);
  if (R == 0) return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  if (blocks == 0) return 0;
  march_rays_kernel<kOrbit, kCascade, kBits><<<blocks, R * kGroup, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)nears,
      (const float*)fars, (const float*)t_lo, (const float*)t_hi,
      (const float*)noises, (const uint8_t*)field, (const float*)sigma_grid, (float*)t,
      (float*)dt, (uint8_t*)valid, (float*)xyz, (int*)count, (int)N, K, S, R, H, bound,
      mip_bound, dt_step, use_cull, log_cull, cascade, dt_gamma, dt_max);
  return (int)cudaGetLastError();
}

template <bool kBits>
int launch_orbit(bool affine, int cascade, const void* rays_o, const void* rays_d,
                 const void* nears, const void* fars, const void* t_lo, const void* t_hi,
                 const void* noises, const void* field, const void* sigma_grid, void* t,
                 void* dt, void* valid, void* xyz, void* count, long long N, int K, int S,
                 int H, float bound, float mip_bound, float dt_min, int use_cull,
                 float log_cull, float dt_gamma, float dt_max, void* stream) {
#define MARCH_ARGS                                                                         \
  rays_o, rays_d, nears, fars, t_lo, t_hi, noises, field, sigma_grid, t, dt, valid, xyz,  \
      count, N, K, S, H, bound, mip_bound, dt_min, use_cull, log_cull, cascade, dt_gamma,  \
      dt_max, stream
  if (affine) {
    return cascade > 1 ? launch<false, true, kBits>(MARCH_ARGS)
                       : launch<false, false, kBits>(MARCH_ARGS);
  }
  return cascade > 1 ? launch<true, true, kBits>(MARCH_ARGS)
                     : launch<true, false, kBits>(MARCH_ARGS);
#undef MARCH_ARGS
}

}  // namespace

// the general orbit (affine 0) or the affine one (affine 1: dt = dt_min), at
// any cascade; exactly one of sigma_bytes [cascade * H^3] (kernel B, its
// cull in the walk) and bitfield [cascade * H^3 / 8] (B-bitfield, with
// use_cull the float-grid cull on sigma_grid [cascade * H^3])
extern "C" int march_rays_fwd(const void* rays_o, const void* rays_d, const void* nears,
                              const void* fars, const void* t_lo, const void* t_hi,
                              const void* noises, const void* sigma_bytes,
                              const void* bitfield, const void* sigma_grid, void* t, void* dt,
                              void* valid, void* xyz, void* count, long long N, int K, int S,
                              int H, int cascade, float bound, float dt_gamma, float dt_min,
                              float dt_max, int affine, int use_cull, float log_cull,
                              void* stream) {
  if (cascade < 1 || cascade > 8 || (long long)cascade * H * H * H > 0xffffffffLL ||
      (sigma_bytes == nullptr) == (bitfield == nullptr) ||
      (bitfield != nullptr && use_cull && sigma_grid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float mip_bound = bound < 1.0f ? bound : 1.0f;  // cascade 1: min(1, bound)
  if (bitfield != nullptr) {
    return launch_orbit<true>(affine, cascade, rays_o, rays_d, nears, fars, t_lo, t_hi, noises,
                              bitfield, sigma_grid, t, dt, valid, xyz, count, N, K, S, H,
                              bound, mip_bound, dt_min, use_cull, log_cull, dt_gamma, dt_max,
                              stream);
  }
  return launch_orbit<false>(affine, cascade, rays_o, rays_d, nears, fars, t_lo, t_hi, noises,
                             sigma_bytes, nullptr, t, dt, valid, xyz, count, N, K, S, H, bound,
                             mip_bound, dt_min, use_cull, log_cull, dt_gamma, dt_max, stream);
}

// the two-level march on the affine orbit at cascade 1: sigma_bytes [H^3],
// coarse [(H/4)^3]; the first group_slots kept groups of a ray are
// fine-marched; dt_group is f32(4 * dt_min)
extern "C" int march_rays_grouped_fwd(const void* rays_o, const void* rays_d,
                                      const void* nears, const void* fars, const void* t_lo,
                                      const void* t_hi, const void* noises,
                                      const void* sigma_bytes, const void* coarse, void* t,
                                      void* dt, void* valid, void* xyz, void* count,
                                      void* groups, long long N, int K, int S, int H,
                                      int group_slots, float bound, float dt_min,
                                      float dt_group, int use_cull, float log_cull,
                                      void* stream) {
  if (N < 0 || N > 0x7fffffffLL - kThreads || S < 1 || K < 0 || group_slots < 0 ||
      H % kMarch != 0 || (long long)H * H * H > 0xffffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int smem;
  cudaError_t err;
  const int R = block_rays(march_rays_grouped_kernel, S, &smem, &err, sizeof(float4));
  if (R == 0) return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  if (blocks == 0) return 0;
  const float mip_bound = bound < 1.0f ? bound : 1.0f;
  march_rays_grouped_kernel<<<blocks, R * kGroup, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)nears, (const float*)fars,
      (const float*)t_lo, (const float*)t_hi, (const float*)noises,
      (const uint8_t*)sigma_bytes, (const uint8_t*)coarse, (float*)t, (float*)dt,
      (uint8_t*)valid, (float*)xyz, (int*)count, (int*)groups, (int)N, K, S, R, H,
      group_slots, bound, mip_bound, dt_min, dt_group, use_cull, log_cull);
  return (int)cudaGetLastError();
}
