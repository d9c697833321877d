// Whole-frame conformance path tracer in one launch (K1).
//
// Replaces the TPU kernel spath_tpu/ops/pallas/megakernel.py::_megakernel
// (launched there by mega_call). It computes the same function, not the
// same blocks: the TPU kernel puts 1024 rays on vector lanes and walks an
// SMEM triangle table with scalar reads; here one thread owns one ray.
//
//   - the camera ray's nearest hit is computed once, before the sample loop;
//   - each of spp samples walks up to max_bounces segments: Moller-Trumbore
//     against every triangle of the (T, 18) table with the epsilon bounds,
//     the source-triangle exclusion and a strict `<` so the lowest index
//     wins ties; the hit triangle's normal (flipped against the ray),
//     albedo and emission are read by index; two LCG draws advance the
//     pixel's uint32 seed only on a hit; the angle-uniform sampler picks
//     the next direction; the forward throughput is accumulated;
//   - a ray that misses stops its sample: every later term of the masked
//     TPU walk is zero and its seed does not move, so this is exact.
//
// Bound: compute, not memory. The headline frame (1920x1080, 64 spp, 5
// bounces, 7 triangles) is ~640M path segments, each tested against all T
// triangles at ~46 float operations a test, against 32 bytes read and 12
// written per pixel. So the design keeps everything in registers: rays,
// seeds and output are read and written once, by neighbouring threads at
// neighbouring addresses, and the table is read through the read-only
// cache, where all threads of a warp load the same address at the same
// time (a broadcast). Staging the table in shared memory, fast trig and
// FMA contraction are later measured choices.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// multiply and add rounds on its own as in the plain PyTorch version
// (megakernel_plain), division is IEEE, and cosf/sinf are the accurate
// library forms. A 1-ulp difference in any of these flips chaotic paths.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel.py), all
// row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): v0, e1, e2, normal, albedo,
//                        emission
//   out                  float32 (n, 3): mean radiance r, g, b
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 values equal to the JAX package's np.float32 constants.
constexpr float kEps = 0x1.6849b8p-47f;     // float32(1e-14)
constexpr float kInvEps = 0x1.6bcc42p+46f;  // float32(1 / 1e-14)
constexpr float kBig = 0x1.d1a94ap+39f;     // float32(1e12), the miss distance
constexpr float kTwoPi = 0x1.921fb6p+2f;    // float32(2 pi)
constexpr float kHalfPi = 0x1.921fb6p+0f;   // float32(pi / 2)
constexpr int kCols = 18;
constexpr int kBlock = 128;

struct Hit {
  float dist;
  int idx;
};

__device__ __forceinline__ Hit nearest(const float* __restrict__ tri,
                                       int n_tris, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       int src) {
  Hit best{kBig, -1};
  for (int t = 0; t < n_tris; ++t) {
    const float* r = tri + t * kCols;
    const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
    const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
    const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
    // h = d x e2
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const bool nondeg = fabsf(a) >= kEps;
    const float f = 1.0f / (nondeg ? a : 1.0f);
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    // q = s x e1
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (dx * qx + dy * qy + dz * qz);
    const float dist = f * (e2x * qx + e2y * qy + e2z * qz);
    const bool ok = nondeg && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && dist > kEps && dist < kInvEps &&
                    src != t && dist < best.dist;
    if (ok) {
      best.dist = dist;
      best.idx = t;
    }
  }
  return best;
}

// The reference's LCG: advance the seed, return ((seed >> 16) & 0x7FFF)
// divided (not multiplied by the reciprocal) by 32767.
__device__ __forceinline__ float lcg(uint32_t& seed) {
  seed = 214013u * seed + 2531011u;
  return static_cast<float>((seed >> 16) & 0x7FFFu) / 32767.0f;
}

__global__ void __launch_bounds__(kBlock)
    megakernel_forward(const float* __restrict__ origins,
                       const float* __restrict__ directions,
                       const int64_t* __restrict__ seeds,
                       const float* __restrict__ tri, float* __restrict__ out,
                       int n, int n_tris, int spp, int max_bounces) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float* o = origins + 3 * i;
  const float* d = directions + 3 * i;
  const float ox0 = o[0], oy0 = o[1], oz0 = o[2];
  const float dx0 = d[0], dy0 = d[1], dz0 = d[2];
  uint32_t seed = static_cast<uint32_t>(seeds[i]);

  // Camera rays are the same for every sample.
  const Hit first = nearest(tri, n_tris, ox0, oy0, oz0, dx0, dy0, dz0, -1);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    float ox = ox0, oy = oy0, oz = oz0;
    float dx = dx0, dy = dy0, dz = dz0;
    int src = -1;
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      const Hit h = bounce == 0
                        ? first
                        : nearest(tri, n_tris, ox, oy, oz, dx, dy, dz, src);
      if (h.idx < 0) break;
      const float* r = tri + h.idx * kCols;
      float nx = __ldg(r + 9), ny = __ldg(r + 10), nz = __ldg(r + 11);
      const float ar = __ldg(r + 12), ag = __ldg(r + 13), ab = __ldg(r + 14);
      const float er = __ldg(r + 15), eg = __ldg(r + 16), eb = __ldg(r + 17);
      if (nx * dx + ny * dy + nz * dz > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }

      const float u1 = lcg(seed);
      const float u2 = lcg(seed);

      // angle-uniform hemisphere sample about the flipped normal
      const float az = u1 * kTwoPi;
      const float el = u2 * kHalfPi;
      const float fx = cosf(el);
      float sx = cosf(az) * fx;
      float sy = sinf(el);
      float sz = sinf(az) * fx;
      if (!(nx * sx + ny * sy + nz * sz >= 0.0f)) {
        sx = -sx;
        sy = -sy;
        sz = -sz;
      }
      const float w = 2.0f * (sx * nx + sy * ny + sz * nz);

      rad_r = rad_r + thr_r * er;
      rad_g = rad_g + thr_g * eg;
      rad_b = rad_b + thr_b * eb;
      thr_r = thr_r * ar * w;
      thr_g = thr_g * ag * w;
      thr_b = thr_b * ab * w;

      ox = ox + h.dist * dx;
      oy = oy + h.dist * dy;
      oz = oz + h.dist * dz;
      dx = sx;
      dy = sy;
      dz = sz;
      src = h.idx;
    }
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  const float inv = 1.0f / static_cast<float>(spp);
  out[3 * i + 0] = acc_r * inv;
  out[3 * i + 1] = acc_g * inv;
  out[3 * i + 2] = acc_b * inv;
}

}  // namespace

extern "C" int spath_megakernel_forward(const float* origins,
                                        const float* directions,
                                        const int64_t* seeds,
                                        const float* tri, float* out, int n,
                                        int n_tris, int spp, int max_bounces,
                                        void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  megakernel_forward<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, out, n, n_tris, spp, max_bounces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spath_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
