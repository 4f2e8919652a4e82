// A design of kernel E measured by the attribution study
// (radnerf_tpu_torch/studies/raster.py) and not on the path: the parent's
// z-buffer, with a sign test at every centre and the exact test of the
// centres that pass it queued by the warp and taken 32 at a time. Bit for
// bit with rasterize_plain; no faster than the parent's kernel (PERF.md, PR
// 12): the queue costs what the divisions it saves cost.
//
// Inputs and output as kernel E's (csrc/rasterize.cu). The sign test: w1 =
// n1 / den (and w2) is negative, not -0, wherever n1 and den have strictly
// opposite signs with |n1| >= 2^-80 and |den| <= 2^64 (the quotient is then
// at least 2^-144 in size), so such a centre is not covered.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // raster_triangles' block
constexpr int kQueue = 64;   // a warp's queue of centres for the exact test
constexpr int kFields = 10;  // p0x, p0y, e1x, e1y, e2x, e2y, den, z0, z1, z2

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  // the unsigned order of the result is the float order of f
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// grid (ceil(T / (32 kWarps)), B); H, W < 2^16, H W < 2^31
__global__ void raster_triangles(const float* __restrict__ xy,
                                 const float* __restrict__ z,
                                 const int* __restrict__ tris,
                                 unsigned long long* __restrict__ zbuf,
                                 long long V, int T, int H, int W) {
  __shared__ float s_tri[kWarps][kFields][32];
  __shared__ unsigned int s_pos[kWarps][kQueue];  // pi << 16 | pj
  __shared__ unsigned char s_owner[kWarps][kQueue];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int t = (blockIdx.x * kWarps + warp) * 32 + lane;
  float(*tri)[32] = s_tri[warp];
  unsigned int* pos = s_pos[warp];
  unsigned char* owner = s_owner[warp];

  // this lane's triangle and its n centres: rows from i0, columns j0..j1
  int n = 0, i0 = 0, j0 = 0, j1 = -1;
  float p0x = 0.0f, p0y = 0.0f, e1x = 0.0f, e1y = 0.0f, e2x = 0.0f, e2y = 0.0f, den = 1.0f;
  if (t < T) {
    const long long a0 = tris[3 * t], a1 = tris[3 * t + 1], a2 = tris[3 * t + 2];
    const float* pxy = xy + (long long)b * V * 2;
    const float* pz = z + (long long)b * V;
    p0x = pxy[2 * a0];
    p0y = pxy[2 * a0 + 1];
    const float p1x = pxy[2 * a1], p1y = pxy[2 * a1 + 1];
    const float p2x = pxy[2 * a2], p2y = pxy[2 * a2 + 1];
    e1x = p1x - p0x;
    e1y = p1y - p0y;
    e2x = p2x - p0x;
    e2y = p2y - p0y;
    den = e1x * e2y - e1y * e2x;
    // pixel centres within one pixel of the bounding box, clipped to the
    // image; bounds are formed in float so that any coordinate clips before
    // the cast
    const float xmin = fminf(fminf(p0x, p1x), p2x), xmax = fmaxf(fmaxf(p0x, p1x), p2x);
    const float ymin = fminf(fminf(p0y, p1y), p2y), ymax = fmaxf(fmaxf(p0y, p1y), p2y);
    const float fj0 = fmaxf(ceilf(xmin - 0.5f) - 1.0f, 0.0f);
    const float fj1 = fminf(floorf(xmax - 0.5f) + 1.0f, (float)(W - 1));
    const float fi0 = fmaxf(ceilf(ymin - 0.5f) - 1.0f, 0.0f);
    const float fi1 = fminf(floorf(ymax - 0.5f) + 1.0f, (float)(H - 1));
    // degenerate (or NaN) triangles and ranges off the image cover nothing
    if (fabsf(den) > 1e-12f && fj0 <= fj1 && fi0 <= fi1) {
      i0 = (int)fi0;
      j0 = (int)fj0;
      j1 = (int)fj1;
      n = ((int)fi1 - i0 + 1) * (j1 - j0 + 1);
      tri[0][lane] = p0x;
      tri[1][lane] = p0y;
      tri[2][lane] = e1x;
      tri[3][lane] = e1y;
      tri[4][lane] = e2x;
      tri[5][lane] = e2y;
      tri[6][lane] = den;
      tri[7][lane] = pz[a0];
      tri[8][lane] = pz[a1];
      tri[9][lane] = pz[a2];
    }
  }
  // the sign test applies where |den| <= 2^64 (header); s carries den's sign
  const bool sign_test = fabsf(den) <= 0x1p64f;
  const float s = den > 0.0f ? 1.0f : -1.0f;
  unsigned long long* frame = zbuf + (long long)b * H * W;
  const unsigned lower = (1u << lane) - 1u;

  // the exact test of the queued centre at slot q in JAX's expressions, and
  // an atomicMin where it is covered
  auto exact = [&](int q) {
    const int o = owner[q];
    const int ci = (int)(pos[q] >> 16), cj = (int)(pos[q] & 0xffffu);
    const float dy = ((float)ci + 0.5f) - tri[1][o];
    const float dx = ((float)cj + 0.5f) - tri[0][o];
    const float d = tri[6][o];  // != 0, so JAX's where(den == 0, 1, den) is den
    const float w1 = (dx * tri[5][o] - dy * tri[4][o]) / d;
    const float w2 = (tri[2][o] * dy - tri[3][o] * dx) / d;
    const float w0 = 1.0f - w1 - w2;
    if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
      const float zp = w0 * tri[7][o] + w1 * tri[8][o] + w2 * tri[9][o];
      const unsigned int id = (unsigned int)(t - lane + o);
      atomicMin(frame + (long long)ci * W + cj,
                ((unsigned long long)ordered_bits(zp) << 32) | id);
    }
  };

  __syncwarp();
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  int qn = 0;  // the queue's length, the same in every lane
  int pi = i0, pj = j0;
  for (int it = 0; it < n_max; ++it) {
    bool passed = false;
    if (it < n) {
      const float dy = ((float)pi + 0.5f) - p0y;
      const float dx = ((float)pj + 0.5f) - p0x;
      const float n1 = dx * e2y - dy * e2x;
      const float n2 = e1x * dy - e1y * dx;
      passed = !(sign_test && (n1 * s <= -0x1p-80f || n2 * s <= -0x1p-80f));
    }
    const unsigned m = __ballot_sync(0xffffffffu, passed);
    if (passed) {
      const int q = qn + __popc(m & lower);
      pos[q] = ((unsigned int)pi << 16) | (unsigned int)pj;
      owner[q] = (unsigned char)lane;
    }
    if (it < n && ++pj > j1) {
      pj = j0;
      ++pi;
    }
    qn += __popc(m);
    if (qn >= 32) {  // every lane takes one centre
      __syncwarp();
      exact(qn - 32 + lane);
      qn -= 32;
      __syncwarp();
    }
  }
  __syncwarp();
  if (lane < qn) exact(lane);
}

__global__ void unpack_ids(const unsigned long long* __restrict__ zbuf,
                           int* __restrict__ tri_id, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = zbuf[i];
  tri_id[i] = key == ~0ull ? -1 : (int)(unsigned int)(key & 0xffffffffull);
}

}  // namespace

// zbuf: scratch of B * H * W u64 from the caller
extern "C" int rasterize_queued_fwd(const void* xy, const void* z, const void* tris,
                             void* zbuf, void* tri_id, int B, long long V, int T,
                             int H, int W, void* stream) {
  if (B < 0 || B > 65535 || V < 0 || T < 0 || H <= 0 || W <= 0 || H >= 65536 || W >= 65536 ||
      (long long)H * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  cudaError_t err = cudaMemsetAsync(zbuf, 0xff, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    const dim3 grid((T + 32 * kWarps - 1) / (32 * kWarps), B);
    raster_triangles<<<grid, 32 * kWarps, 0, s>>>((const float*)xy, (const float*)z,
                                                  (const int*)tris, (unsigned long long*)zbuf,
                                                  V, T, H, W);
  }
  const int threads = 256;
  unpack_ids<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      (const unsigned long long*)zbuf, (int*)tri_id, n);
  return (int)cudaGetLastError();
}
