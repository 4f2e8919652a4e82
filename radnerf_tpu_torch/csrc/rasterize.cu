// Kernel E: hard z-buffer rasterization of a triangle mesh, a batch of frames.
//
// Replaces radnerf_tpu/preprocess/render_3dmm.py: _raster_hard (:218) with
// _bin_triangles (:172), the visibility pass of the 3DMM renderer that the
// photometric tracker runs at every step. The XLA formulation was shaped for
// the TPU: every triangle binned into at most 2x2 tiles of 16x16 pixels by one
// sort, a static list of K = 128 candidates per tile, and a vmap over tiles of
// [256 pixels, K] barycentric tests and an argmin. At the reference's mesh
// density (~69k triangles on a 512x512 face) a tile in the face holds more
// than K candidates, and the lists keep only the first K. A z-buffer with
// atomics needs no lists and drops nothing.
//
// Inputs: xy [B, V, 2] f32 (screen; pixel (i, j) has its centre at
// (j + 0.5, i + 0.5)), z [B, V] f32 (positive depth), tris [T, 3] i32.
// Output: tri_id [B, H, W] i32, the covering triangle of least depth, the
// lower id at equal depth, -1 where none covers.
//
// Pass 1, one thread per (frame, triangle): the pixel centres within one
// pixel of the triangle's bounding box, clipped to the image (the margin
// takes in a centre that the rounded tests put inside although it lies an
// ulp outside the box), less the margin rows and columns that no rounded
// test can cover (the trim, below); for each centre the inside test and the
// depth in JAX's float32 expressions, in JAX's order (built with
// -fmad=false, IEEE division), and for a covered centre an atomicMin of
// (order-preserving bits of zp) << 32 | triangle into a u64 buffer
// [B, H, W] that starts at all ones. Pass 2, one thread per pixel, unpacks
// the buffer into tri_id.
//
// What bounds it on an H100 (PERF.md; the attribution study
// radnerf_tpu_torch/studies/raster.py): instructions. At the photometric
// step's 64 x 512 x 512 a triangle tests ~13 centres and covers ~1: the
// margin rows and columns are most of the centres tested. The raster pass
// was 70% of E, the two IEEE divisions at every centre 45% of it, its
// atomics (against plain stores, or a buffer held in L2) 5%.
//
// The trim. A margin column lies outside the box by d > 0 (its centres at
// x = xmin - d). For the triangle the float ops see (p0, p0 + e1, p0 + e2,
// within u wx of the vertices, u = 2^-24) some exact barycentric of such a
// centre is at most -d / (2 wx): they sum to 1, and sum W_i (x_i - xmin) =
// -d over at most two negative W_i with x_i - xmin <= wx. The rounded w_i
// differ from the exact ones by at most
//   err = 4u (1 + |W1| + |W2| + R1 + R2),  Rk = (Ak + |Wk| Aden) / |den|,
// A1 = |dx e2y| + |dy e2x|, A2 = |e1x dy| + |e1y dx|, Aden = |e1x e2y| +
// |e1y e2x| (first order; dx, dy, the products, the differences, den and
// the quotient each round once, and w0 = (1 - w1) - w2 twice more). Over
// the window |dx| <= wx + 1, |dy| <= wy + 1, and |Wk| <= 2 Ak / |den| where
// Aden <= 2^20 |den|. So where d > 2 wx err the rounded w_i is negative at
// every centre of the column, and the column is dropped; the same for the
// last column and the first and last rows. The bound is evaluated in float
// with 4x room (16u for 4u), from X = wx + 2 and Y = wy + 2, and only where
// the coordinates are finite and below 2^40; a dropped centre is one the
// exact test rejects, so the result does not depend on the trim. It leaves
// ~2.6 centres a triangle of the ~13 (a column within ~1e-4 px of the box
// stays).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  // the unsigned order of the result is the float order of f
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void raster_triangles(const float* __restrict__ xy,
                                 const float* __restrict__ z,
                                 const int* __restrict__ tris,
                                 unsigned long long* __restrict__ zbuf, int B,
                                 long long V, int T, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T) return;
  const int b = (int)(i / T);
  const int t = (int)(i - (long long)b * T);
  const long long a0 = tris[3 * t], a1 = tris[3 * t + 1], a2 = tris[3 * t + 2];
  const float* pxy = xy + (long long)b * V * 2;
  const float* pz = z + (long long)b * V;
  const float p0x = pxy[2 * a0], p0y = pxy[2 * a0 + 1];
  const float p1x = pxy[2 * a1], p1y = pxy[2 * a1 + 1];
  const float p2x = pxy[2 * a2], p2y = pxy[2 * a2 + 1];
  const float z0 = pz[a0], z1 = pz[a1], z2 = pz[a2];

  const float e1x = p1x - p0x, e1y = p1y - p0y;
  const float e2x = p2x - p0x, e2y = p2y - p0y;
  const float den = e1x * e2y - e1y * e2x;
  if (!(fabsf(den) > 1e-12f)) return;  // degenerate (or NaN): covers nothing
  const float den_ = den;  // den != 0 here, so JAX's where(den == 0, 1, den) is den

  // pixel centres within one pixel of the bounding box, clipped to the image;
  // bounds are formed in float so that any coordinate clips before the cast
  const float xmin = fminf(fminf(p0x, p1x), p2x), xmax = fmaxf(fmaxf(p0x, p1x), p2x);
  const float ymin = fminf(fminf(p0y, p1y), p2y), ymax = fmaxf(fmaxf(p0y, p1y), p2y);
  const float fj0 = fmaxf(ceilf(xmin - 0.5f) - 1.0f, 0.0f);
  const float fj1 = fminf(floorf(xmax - 0.5f) + 1.0f, (float)(W - 1));
  const float fi0 = fmaxf(ceilf(ymin - 0.5f) - 1.0f, 0.0f);
  const float fi1 = fminf(floorf(ymax - 0.5f) + 1.0f, (float)(H - 1));
  if (!(fj0 <= fj1) || !(fi0 <= fi1)) return;  // off the image (or NaN)
  int j0 = (int)fj0, j1 = (int)fj1, i0 = (int)fi0, i1 = (int)fi1;

  // the trim (header): drop the margin rows and columns no rounded test covers
  const float wx = xmax - xmin, wy = ymax - ymin;
  const float ad = fabsf(den);
  const float aden = fabsf(e1x * e2y) + fabsf(e1y * e2x);
  const float reach = fmaxf(fmaxf(fabsf(xmin), fabsf(xmax)), fmaxf(fabsf(ymin), fabsf(ymax)));
  if (aden <= 0x1p20f * ad && reach < 0x1p40f) {
    const float X = wx + 2.0f, Y = wy + 2.0f;
    const float s = (X * fabsf(e2y) + Y * fabsf(e2x)) + (Y * fabsf(e1x) + X * fabsf(e1y));
    const float inv = 1.0f / ad;
    const float err = 0x1p-20f * (1.0f + 2.0f * s * inv + s * (1.0f + 2.0f * aden * inv) * inv);
    const float dx_min = 2.01f * wx * err + 0x1p-20f * wx;
    const float dy_min = 2.01f * wy * err + 0x1p-20f * wy;
    const float keep = 1.0f - 0x1p-20f;  // fl(xmin - c) may round up by an ulp
    const float cl = (float)j0 + 0.5f, cr = (float)j1 + 0.5f;
    const float ct = (float)i0 + 0.5f, cb = (float)i1 + 0.5f;
    if (cl < xmin && (xmin - cl) * keep > dx_min) ++j0;
    if (cr > xmax && (cr - xmax) * keep > dx_min) --j1;
    if (ct < ymin && (ymin - ct) * keep > dy_min) ++i0;
    if (cb > ymax && (cb - ymax) * keep > dy_min) --i1;
  }

  unsigned long long* frame = zbuf + (long long)b * H * W;
  for (int pi = i0; pi <= i1; ++pi) {
    const float py = (float)pi + 0.5f;
    const float dy = py - p0y;
    for (int pj = j0; pj <= j1; ++pj) {
      const float px = (float)pj + 0.5f;
      const float dx = px - p0x;
      const float w1 = (dx * e2y - dy * e2x) / den_;
      const float w2 = (e1x * dy - e1y * dx) / den_;
      const float w0 = 1.0f - w1 - w2;
      if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
        const float zp = w0 * z0 + w1 * z1 + w2 * z2;
        const unsigned long long key =
            ((unsigned long long)ordered_bits(zp) << 32) | (unsigned int)t;
        atomicMin(frame + (long long)pi * W + pj, key);
      }
    }
  }
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
extern "C" int rasterize_fwd(const void* xy, const void* z, const void* tris,
                             void* zbuf, void* tri_id, int B, long long V, int T,
                             int H, int W, void* stream) {
  if (B < 0 || V < 0 || T < 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  cudaError_t err = cudaMemsetAsync(zbuf, 0xff, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long work = (long long)B * T;
  if (work > 0) {
    raster_triangles<<<(unsigned)((work + threads - 1) / threads), threads, 0, s>>>(
        (const float*)xy, (const float*)z, (const int*)tris,
        (unsigned long long*)zbuf, B, V, T, H, W);
  }
  unpack_ids<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      (const unsigned long long*)zbuf, (int*)tri_id, n);
  return (int)cudaGetLastError();
}
