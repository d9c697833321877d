// The conformance walk's pieces shared by the forward kernel K1
// (megakernel.cu) and the backward kernel K2 (megakernel_grad.cu), so
// that K2's replay of K1's walk compiles from one source and takes the
// same hits, draws and directions bit for bit.
//
// Numerics: every file that includes this header is built with
// -fmad=false and without --use_fast_math (ops/kernels/build.py), so each
// multiply and add rounds on its own as in the plain PyTorch versions,
// division is IEEE, and cosf/sinf are the accurate library forms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spath {

// float32 values equal to the JAX package's np.float32 constants.
constexpr float kEps = 0x1.6849b8p-47f;     // float32(1e-14)
constexpr float kInvEps = 0x1.6bcc42p+46f;  // float32(1 / 1e-14)
constexpr float kBig = 0x1.d1a94ap+39f;     // float32(1e12), the miss distance
constexpr float kTwoPi = 0x1.921fb6p+2f;    // float32(2 pi)
constexpr float kHalfPi = 0x1.921fb6p+0f;   // float32(pi / 2)
// Columns of the (T, 18) table: v0, e1, e2, normal, albedo, emission.
constexpr int kCols = 18;

struct Hit {
  float dist;
  int idx;
};

// Nearest hit of the ray o + t d against every triangle of the table:
// Moller-Trumbore with the epsilon bounds, the source-triangle exclusion
// and a strict `<`, so the lowest index wins ties. idx is -1 on a miss.
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

// What a hit gives the walk: the table's normal flipped against the
// incoming ray (fs = -1 where flipped, else 1), the angle-uniform sample
// about it and its weight w = 2 cos(theta).
struct Surface {
  float fs;
  float nx, ny, nz;
  float sx, sy, sz;
  float w;
};

// Shade a hit on triangle `idx` for a ray of direction d: flip the
// normal, draw two LCG uniforms (the seed advances only here, on a hit)
// and sample the next direction.
__device__ __forceinline__ Surface surface(const float* __restrict__ tri,
                                           int idx, float dx, float dy,
                                           float dz, uint32_t& seed) {
  const float* r = tri + idx * kCols;
  Surface s;
  s.nx = __ldg(r + 9);
  s.ny = __ldg(r + 10);
  s.nz = __ldg(r + 11);
  s.fs = 1.0f;
  if (s.nx * dx + s.ny * dy + s.nz * dz > 0.0f) {
    s.fs = -1.0f;
    s.nx = -s.nx;
    s.ny = -s.ny;
    s.nz = -s.nz;
  }

  const float u1 = lcg(seed);
  const float u2 = lcg(seed);

  // angle-uniform hemisphere sample about the flipped normal
  const float az = u1 * kTwoPi;
  const float el = u2 * kHalfPi;
  const float fx = cosf(el);
  s.sx = cosf(az) * fx;
  s.sy = sinf(el);
  s.sz = sinf(az) * fx;
  if (!(s.nx * s.sx + s.ny * s.sy + s.nz * s.sz >= 0.0f)) {
    s.sx = -s.sx;
    s.sy = -s.sy;
    s.sz = -s.sz;
  }
  s.w = 2.0f * (s.sx * s.nx + s.sy * s.ny + s.sz * s.nz);
  return s;
}

}  // namespace spath
