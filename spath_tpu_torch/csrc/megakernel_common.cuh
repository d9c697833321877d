// The conformance walk's pieces shared by the forward kernel K1
// (megakernel.cu) and the backward kernel K2 (megakernel_grad.cu), so
// that K2's replay of K1's walk compiles from one source and takes the
// same hits, draws and directions bit for bit. The nearest-hit sweeps
// take the table's row stride as a template argument: 18 columns for the
// conformance table, 21 for the quality table of K3 and K4
// (quality_walk.cuh).
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

// The origin terms of the ray from o against row r (v0, e1, e2):
// s = o - v0, q = s x e1 and e2q = e2 . q, shared by every direction from o.
struct OriginTerms {
  float sx, sy, sz, qx, qy, qz, e2q;
};

__device__ __forceinline__ OriginTerms origin_terms(const float* __restrict__ r,
                                                    float ox, float oy,
                                                    float oz) {
  OriginTerms o;
  o.sx = ox - __ldg(r + 0);
  o.sy = oy - __ldg(r + 1);
  o.sz = oz - __ldg(r + 2);
  const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
  o.qx = o.sy * e1z - o.sz * e1y;
  o.qy = o.sz * e1x - o.sx * e1z;
  o.qz = o.sx * e1y - o.sy * e1x;
  o.e2q = __ldg(r + 6) * o.qx + __ldg(r + 7) * o.qy + __ldg(r + 8) * o.qz;
  return o;
}

// One Moller-Trumbore test of direction d against triangle t (row r)
// from the origin terms o: the epsilon bounds, the source-triangle
// exclusion and a strict `<`, so the lowest index wins ties. Updates
// `best`.
__device__ __forceinline__ void mt_test(const float* __restrict__ r, int t,
                                        const OriginTerms& o, float dx,
                                        float dy, float dz, int src,
                                        Hit& best) {
  const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
  const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
  // h = d x e2
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool nondeg = fabsf(a) >= kEps;
  const float f = 1.0f / (nondeg ? a : 1.0f);
  const float u = f * (o.sx * hx + o.sy * hy + o.sz * hz);
  const float v = f * (dx * o.qx + dy * o.qy + dz * o.qz);
  const float dist = f * o.e2q;
  const bool ok = nondeg && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  u + v <= 1.0f && dist > kEps && dist < kInvEps &&
                  src != t && dist < best.dist;
  if (ok) {
    best.dist = dist;
    best.idx = t;
  }
}

// Nearest hit of the ray o + t d against every triangle of the table
// (rows of kStride floats starting v0, e1, e2). idx is -1 on a miss.
template <int kStride = kCols>
__device__ __forceinline__ Hit nearest(const float* __restrict__ tri,
                                       int n_tris, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       int src) {
  Hit best{kBig, -1};
  for (int t = 0; t < n_tris; ++t) {
    const float* r = tri + t * kStride;
    mt_test(r, t, origin_terms(r, ox, oy, oz), dx, dy, dz, src, best);
  }
  return best;
}

// Two nearest-hit sweeps of rays sharing the origin o (a shadow ray d1
// and the next bounce's ray d2) in one walk of the table: the origin
// terms are computed once per triangle. Each result is bit-equal to its
// own `nearest` call.
template <int kStride>
__device__ __forceinline__ void nearest2(const float* __restrict__ tri,
                                         int n_tris, float ox, float oy,
                                         float oz, float d1x, float d1y,
                                         float d1z, float d2x, float d2y,
                                         float d2z, int src, Hit& h1,
                                         Hit& h2) {
  h1 = Hit{kBig, -1};
  h2 = Hit{kBig, -1};
  for (int t = 0; t < n_tris; ++t) {
    const float* r = tri + t * kStride;
    const OriginTerms o = origin_terms(r, ox, oy, oz);
    mt_test(r, t, o, d1x, d1y, d1z, src, h1);
    mt_test(r, t, o, d2x, d2y, d2z, src, h2);
  }
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
