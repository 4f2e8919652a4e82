// A design of kernel E measured by the attribution study
// (radnerf_tpu_torch/studies/raster.py) and not on the path: the triangles
// binned into 16x16 tiles, each tile resolved by one warp with its depth
// buffer in shared memory, tri_id written directly. Bit for bit with
// rasterize_plain; slower than the path's z-buffer at the photometric
// step's mesh density (PERF.md, PR 12): each triangle is loaded three times
// (count, fill, resolve), and a tile's list is a chain of dependent loads.
//
// Inputs: xy [B, V, 2] f32, z [B, V] f32, tris [T, 3] i32 as kernel E's.
// Output: tri_id [B, H, W] i32, as kernel E's.
//
// Five kernels, launched by one call (every name starts raster_):
// 0. raster_clear zeroes the tile and wide counts;
// 1. raster_bin<false>, one thread a (frame, triangle): a triangle whose
//    pixel range touches at most 2x2 tiles of kTile x kTile pixels adds one
//    to each of those tiles' counts (one atomic for a run of a warp's lanes
//    with one tile: a warp's triangles are neighbours in the mesh's order);
// 2. raster_scan, one block a frame: the exclusive scan of the frame's tile
//    counts into list offsets, frame b's lists in [4 T b, 4 T (b + 1)) (a
//    triangle enters at most 4 lists, so they always fit; no size is read
//    back to the host);
// 3. raster_bin<true>, one thread a (frame, triangle): writes each triangle
//    into its tiles' lists, or into its frame's wide list (capacity T) when
//    its range spans more than 2 tiles along an axis;
// 4. raster_resolve, one warp a (frame, tile): the tile's keys in shared
//    memory; a lane takes each list triangle in turn and tests its centres
//    inside the tile, then the warp walks the frame's wide list, each lane
//    testing its own pixels; the tile's tri_id is written once.
// The centres, their tests and the sign test are kernel E's
// (csrc/rasterize.cu).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;           // tile side in pixels
constexpr int kPix = kTile * kTile;
constexpr int kWarps = 8;           // raster_resolve's block: a warp a tile
constexpr int kBinThreads = 256;    // raster_bin's block
constexpr int kScanThreads = 1024;  // raster_scan's block
static_assert(kPix % 32 == 0, "a lane owns whole pixels of its tile");

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  // the unsigned order of the result is the float order of f
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A (frame, triangle) as the tests read it.
struct Tri {
  float p0x, p0y, e1x, e1y, e2x, e2y, den, z0, z1, z2;
  int i0, i1, j0, j1;  // its centres' rows and columns
};

// Triangle t of frame b (its depths too where z is given); false where it
// covers no centre: degenerate (or NaN), or its range off the image. The
// range: the centres within one pixel of the bounding box, clipped to the
// image, its bounds formed in float so that any coordinate clips before
// the cast.
__device__ __forceinline__ bool load_tri(const float* __restrict__ xy,
                                         const float* __restrict__ z,
                                         const int* __restrict__ tris, int b,
                                         long long V, int t, int H, int W,
                                         Tri& r) {
  const long long a0 = tris[3 * t], a1 = tris[3 * t + 1], a2 = tris[3 * t + 2];
  const float* pxy = xy + (long long)b * V * 2;
  const float p0x = pxy[2 * a0], p0y = pxy[2 * a0 + 1];
  const float p1x = pxy[2 * a1], p1y = pxy[2 * a1 + 1];
  const float p2x = pxy[2 * a2], p2y = pxy[2 * a2 + 1];
  if (z != nullptr) {
    const float* pz = z + (long long)b * V;
    r.z0 = pz[a0];
    r.z1 = pz[a1];
    r.z2 = pz[a2];
  }
  r.p0x = p0x;
  r.p0y = p0y;
  r.e1x = p1x - p0x;
  r.e1y = p1y - p0y;
  r.e2x = p2x - p0x;
  r.e2y = p2y - p0y;
  r.den = r.e1x * r.e2y - r.e1y * r.e2x;
  if (!(fabsf(r.den) > 1e-12f)) return false;  // degenerate (or NaN)
  const float xmin = fminf(fminf(p0x, p1x), p2x), xmax = fmaxf(fmaxf(p0x, p1x), p2x);
  const float ymin = fminf(fminf(p0y, p1y), p2y), ymax = fmaxf(fmaxf(p0y, p1y), p2y);
  const float fj0 = fmaxf(ceilf(xmin - 0.5f) - 1.0f, 0.0f);
  const float fj1 = fminf(floorf(xmax - 0.5f) + 1.0f, (float)(W - 1));
  const float fi0 = fmaxf(ceilf(ymin - 0.5f) - 1.0f, 0.0f);
  const float fi1 = fminf(floorf(ymax - 0.5f) + 1.0f, (float)(H - 1));
  if (!(fj0 <= fj1) || !(fi0 <= fi1)) return false;  // off the image (or NaN)
  r.j0 = (int)fj0;
  r.j1 = (int)fj1;
  r.i0 = (int)fi0;
  r.i1 = (int)fi1;
  return true;
}

// The key triangle t offers at centre (pi, pj), ~0 where it does not cover it.
__device__ __forceinline__ unsigned long long centre_key(const Tri& r, int t, int pi, int pj) {
  const float dy = ((float)pi + 0.5f) - r.p0y;
  const float dx = ((float)pj + 0.5f) - r.p0x;
  const float n1 = dx * r.e2y - dy * r.e2x;
  const float n2 = r.e1x * dy - r.e1y * dx;
  if (fabsf(r.den) <= 0x1p64f) {  // the sign test (header): exact where it rejects
    const float s = r.den > 0.0f ? 1.0f : -1.0f;
    if (n1 * s <= -0x1p-80f || n2 * s <= -0x1p-80f) return ~0ull;
  }
  // den != 0 here, so JAX's where(den == 0, 1, den) is den
  const float w1 = n1 / r.den;
  const float w2 = n2 / r.den;
  const float w0 = 1.0f - w1 - w2;
  if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) return ~0ull;
  const float zp = w0 * r.z0 + w1 * r.z1 + w2 * r.z2;
  return ((unsigned long long)ordered_bits(zp) << 32) | (unsigned int)t;
}

// The run of equal keys that lane is in, among runs of consecutive lanes:
// its first lane and its length.
__device__ __forceinline__ void key_run(int key, int lane, int& leader, int& length) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || key != prev);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  leader = 31 - __clz(heads & upto);
  const unsigned after = heads & ~upto;
  length = (after ? __ffs(after) - 1 : 32) - leader;
}

__global__ void raster_clear(int* __restrict__ counts, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    counts[i] = 0;
}

// Passes 1 and 3. grid (ceil(T / kBinThreads), B). Without kFill, counts
// each small triangle into its tiles; with it, writes each at its tile's
// cursor (pass 2's offsets, left at the lists' ends) and each wide triangle
// at its frame's wide cursor. A warp's lanes with one tile in a run of
// consecutive lanes take their places with one atomic.
template <bool kFill>
__global__ void raster_bin(const float* __restrict__ xy, const int* __restrict__ tris,
                           int* __restrict__ tile_counts, int* __restrict__ cursors,
                           int* __restrict__ wide_counts, int* __restrict__ lists,
                           int* __restrict__ wide_lists, long long V, int T, int H, int W,
                           int n_tx, int n_tiles) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kBinThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Tri r;
  const bool live = t < T && load_tri(xy, nullptr, tris, b, V, t, H, W, r);
  int tx0 = 0, tx1 = -1, ty0 = 0, ty1 = -1;
  if (live) {
    tx0 = r.j0 / kTile;
    tx1 = r.j1 / kTile;
    ty0 = r.i0 / kTile;
    ty1 = r.i1 / kTile;
  }
  const bool small = live && tx1 - tx0 <= 1 && ty1 - ty0 <= 1;
  // every lane reaches each shuffle and ballot below
  for (int q = 0; q < 4; ++q) {
    const int tx = tx0 + (q & 1), ty = ty0 + (q >> 1);
    const bool ok = small && tx <= tx1 && ty <= ty1;
    const int key = ok ? ty * n_tx + tx : -1;
    int leader, length;
    key_run(key, lane, leader, length);
    const unsigned oks = __ballot_sync(0xffffffffu, ok);
    if (!ok) continue;
    const long long k = (long long)b * n_tiles + key;
    if (!kFill) {
      if (lane == leader) atomicAdd(tile_counts + k, length);
    } else {
      int base = 0;
      if (lane == leader) base = atomicAdd(cursors + k, length);
      base = __shfl_sync(oks, base, leader);
      lists[base + lane - leader] = t;
    }
  }
  if (!kFill) return;
  const bool wide = live && !small;
  const unsigned group = __ballot_sync(0xffffffffu, wide);
  if (!wide) return;
  const int leader = __ffs(group) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(wide_counts + b, __popc(group));
  base = __shfl_sync(group, base, leader);
  wide_lists[(long long)b * T + base + __popc(group & ((1u << lane) - 1u))] = t;
}

// Pass 2. grid B, kScanThreads threads: cursors[b, k] = 4 T b + the sum of
// frame b's counts before tile k.
__global__ void raster_scan(const int* __restrict__ tile_counts, int* __restrict__ cursors,
                            int T, int n_tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 4 * T * b;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int k = base + (int)threadIdx.x;
    const int v = k < n_tiles ? tile_counts[(long long)b * n_tiles + k] : 0;
    int incl = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the warps' sums, scanned in place
      int s = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += o;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    if (k < n_tiles) cursors[(long long)b * n_tiles + k] = carry + before + incl - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten next round
  }
}

// Pass 4. kWarps warps a block, a warp a (frame, tile) of the B * n_tiles.
__global__ void raster_resolve(const float* __restrict__ xy, const float* __restrict__ z,
                               const int* __restrict__ tris,
                               const int* __restrict__ tile_counts,
                               const int* __restrict__ list_ends,
                               const int* __restrict__ wide_counts,
                               const int* __restrict__ lists,
                               const int* __restrict__ wide_lists, int* __restrict__ tri_id,
                               long long V, int T, int H, int W, int n_tx, int n_tiles,
                               int B) {
  __shared__ unsigned long long s_keys[kWarps][kPix];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long kk = (long long)blockIdx.x * kWarps + warp;
  if (kk >= (long long)B * n_tiles) return;  // the whole warp
  const int b = (int)(kk / n_tiles), k = (int)(kk - (long long)b * n_tiles);
  const int ty = k / n_tx, tx = k - ty * n_tx;
  const int r0 = ty * kTile, c0 = tx * kTile;
  const int r1 = min(r0 + kTile, H) - 1, c1 = min(c0 + kTile, W) - 1;
  unsigned long long* keys = s_keys[warp];
  volatile unsigned long long* seen = keys;
  for (int p = lane; p < kPix; p += 32) keys[p] = ~0ull;
  __syncwarp();

  // the tile's list: a lane a triangle, its centres inside the tile
  const int end = list_ends[kk], begin = end - tile_counts[kk];
  for (int e = begin + lane; e < end; e += 32) {
    const int t = lists[e];
    Tri r;
    if (!load_tri(xy, z, tris, b, V, t, H, W, r)) continue;  // never: binned triangles are live
    const int i0 = max(r.i0, r0), i1 = min(r.i1, r1);
    const int j0 = max(r.j0, c0), j1 = min(r.j1, c1);
    for (int pi = i0; pi <= i1; ++pi) {
      for (int pj = j0; pj <= j1; ++pj) {
        const unsigned long long key = centre_key(r, t, pi, pj);
        const int p = (pi - r0) * kTile + (pj - c0);
        if (key < seen[p]) atomicMin(keys + p, key);
      }
    }
  }

  // the frame's wide list: the warp a triangle, a lane its own pixels
  const int n_wide = wide_counts[b];
  for (int w = 0; w < n_wide; ++w) {
    const int t = wide_lists[(long long)b * T + w];
    Tri r;
    if (!load_tri(xy, z, tris, b, V, t, H, W, r)) continue;
    if (r.i1 < r0 || r.i0 > r1 || r.j1 < c0 || r.j0 > c1) continue;  // misses the tile
    for (int p = lane; p < kPix; p += 32) {
      const int pi = r0 + p / kTile, pj = c0 + p % kTile;
      if (pi < r.i0 || pi > r.i1 || pj < r.j0 || pj > r.j1) continue;
      const unsigned long long key = centre_key(r, t, pi, pj);
      if (key < seen[p]) atomicMin(keys + p, key);
    }
  }
  __syncwarp();

  int* out = tri_id + (long long)b * H * W;
  for (int p = lane; p < kPix; p += 32) {
    const int pi = r0 + p / kTile, pj = c0 + p % kTile;
    if (pi > r1 || pj > c1) continue;
    const unsigned long long key = keys[p];
    out[(long long)pi * W + pj] = key == ~0ull ? -1 : (int)(unsigned int)(key & 0xffffffffull);
  }
}

}  // namespace

// The int32 scratch rasterize_binned_fwd needs: tile counts [B, n_tiles], wide
// counts [B], cursors [B, n_tiles], lists [4 B T], wide lists [B, T].
static long long scratch_ints(int B, int T, int H, int W) {
  const long long n_tiles = (long long)((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  return 2 * (long long)B * n_tiles + B + 5 * (long long)B * T;
}

// scratch: scratch_ints(B, T, H, W) int32 from the caller (n_scratch of them)
extern "C" int rasterize_binned_fwd(const void* xy, const void* z, const void* tris, void* scratch,
                             long long n_scratch, void* tri_id, int B, long long V, int T,
                             int H, int W, void* stream) {
  if (B < 0 || B > 65535 || V < 0 || T < 0 || H <= 0 || W <= 0 ||
      5 * (long long)B * T >= (1ll << 31) || n_scratch < scratch_ints(B, T, H, W))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tx = (W + kTile - 1) / kTile;
  const int n_tiles = n_tx * ((H + kTile - 1) / kTile);
  int* tile_counts = (int*)scratch;
  int* wide_counts = tile_counts + (long long)B * n_tiles;
  int* cursors = wide_counts + B;
  int* lists = cursors + (long long)B * n_tiles;
  int* wide_lists = lists + 4 * (long long)B * T;
  const long long n_counts = (long long)B * n_tiles + B;
  raster_clear<<<(unsigned)((n_counts + 1023) / 1024), 1024, 0, s>>>(tile_counts, n_counts);
  if (T > 0) {
    const dim3 grid((T + kBinThreads - 1) / kBinThreads, B);
    raster_bin<false><<<grid, kBinThreads, 0, s>>>((const float*)xy, (const int*)tris,
                                                   tile_counts, cursors, wide_counts, lists,
                                                   wide_lists, V, T, H, W, n_tx, n_tiles);
    raster_scan<<<B, kScanThreads, 0, s>>>(tile_counts, cursors, T, n_tiles);
    raster_bin<true><<<grid, kBinThreads, 0, s>>>((const float*)xy, (const int*)tris,
                                                  tile_counts, cursors, wide_counts, lists,
                                                  wide_lists, V, T, H, W, n_tx, n_tiles);
  }
  const long long n_work = (long long)B * n_tiles;
  raster_resolve<<<(unsigned)((n_work + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
      (const float*)xy, (const float*)z, (const int*)tris, tile_counts, cursors, wide_counts,
      lists, wide_lists, (int*)tri_id, V, T, H, W, n_tx, n_tiles, B);
  return (int)cudaGetLastError();
}
