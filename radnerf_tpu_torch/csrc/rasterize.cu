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
// atomics needs no lists and drops nothing: on Hopper a 64-bit atomicMin in
// L2 is cheap, and the scatter the TPU avoided is the natural form here.
//
// Inputs: xy [B, V, 2] f32 (screen; pixel (i, j) has its centre at
// (j + 0.5, i + 0.5)), z [B, V] f32 (positive depth), tris [T, 3] i32.
// Output: tri_id [B, H, W] i32, the covering triangle of least depth, the
// lower id at equal depth, -1 where none covers.
//
// Pass 1, one thread per (frame, triangle): walks the pixel centres within
// one pixel of the triangle's bounding box, clipped to the image (the margin
// takes in a centre that the rounded tests put inside although it lies an
// ulp outside the box); for each it runs the inside test and the depth in
// JAX's float32 expressions, in JAX's order (built with -fmad=false, IEEE
// division), and for a covered centre does an atomicMin of
// (order-preserving bits of zp) << 32 | triangle into a u64 buffer
// [B, H, W] that starts at all ones. Pass 2, one thread per pixel, unpacks
// the buffer into tri_id.
//
// What bounds it on an H100: bytes. It reads xy, z and tris once, writes
// the buffer once, updates it once per covered (pixel, triangle) pair, reads
// it once and writes tri_id once: at 64 x 512 x 512 that is ~0.35 GB, ~0.1
// ms at 3.35 TB/s. The tests (~20 flops each, a few per triangle at the
// reference's density) are far below the float32 rate. This first design
// keeps one thread per triangle: a triangle far larger than a pixel makes
// its thread long, which a face mesh at 512x512 never has.

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
  const int j0 = (int)fj0, j1 = (int)fj1, i0 = (int)fi0, i1 = (int)fi1;

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
