// The conformance walk and its pieces, shared by the forward kernels K1
// (megakernel.cu) and K6 (bigscene.cu) and their backward kernels K2
// (megakernel_grad.cu) and K8 (bigscene_grad.cu), so that every replay
// compiles from one source and takes the same hits, draws and directions
// bit for bit. Each bounce is one walk_step; K1 and K2 run theirs in
// their lane loop (megakernel_lanes.cuh), each thread sweeping the table
// through the cache on its own (nearest); K6 and K8 in their own queue of
// paths through StreamSweep (stream_sweep.cuh), which stages rows in
// shared memory for the CTA. The nearest-hit sweeps take the table's row
// stride as a template argument: 18 columns for the conformance table, 21
// for the quality table of K3 and K4 (quality_walk.cuh).
//
// Numerics: every file that includes this header is built with
// -fmad=false and without --use_fast_math (ops/kernels/build.py), so each
// multiply and add rounds on its own as in the plain PyTorch versions,
// division is IEEE, and sincosf, cosf and sinf are the accurate library
// forms.

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

// How the sweep helpers read a row's v0, e1, e2: through the read-only
// cache from the table in global memory (K1-K4), or from a block of rows
// staged in shared memory (the streamed kernels, stream_sweep.cuh). The
// arithmetic is the same for both.
struct GlobalRow {
  static __device__ __forceinline__ float at(const float* __restrict__ p) {
    return __ldg(p);
  }
};
struct SharedRow {
  static __device__ __forceinline__ float at(const float* p) { return *p; }
};

template <class Load = GlobalRow>
__device__ __forceinline__ OriginTerms origin_terms(const float* __restrict__ r,
                                                    float ox, float oy,
                                                    float oz) {
  OriginTerms o;
  o.sx = ox - Load::at(r + 0);
  o.sy = oy - Load::at(r + 1);
  o.sz = oz - Load::at(r + 2);
  const float e1x = Load::at(r + 3), e1y = Load::at(r + 4),
              e1z = Load::at(r + 5);
  o.qx = o.sy * e1z - o.sz * e1y;
  o.qy = o.sz * e1x - o.sx * e1z;
  o.qz = o.sx * e1y - o.sy * e1x;
  o.e2q = Load::at(r + 6) * o.qx + Load::at(r + 7) * o.qy +
          Load::at(r + 8) * o.qz;
  return o;
}

// One Moller-Trumbore test of direction d against triangle t (row r)
// from the origin terms o: the epsilon bounds, the source-triangle
// exclusion and a strict `<`, so the lowest index wins ties. Updates
// `best`.
template <class Load = GlobalRow>
__device__ __forceinline__ void mt_test(const float* __restrict__ r, int t,
                                        const OriginTerms& o, float dx,
                                        float dy, float dz, int src,
                                        Hit& best) {
  const float e1x = Load::at(r + 3), e1y = Load::at(r + 4),
              e1z = Load::at(r + 5);
  const float e2x = Load::at(r + 6), e2y = Load::at(r + 7),
              e2z = Load::at(r + 8);
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

// Whether surface() draws its two angles with one sincosf an angle (the
// bits of cosf's and sinf's, one range reduction an angle: K1 5.0 -> 4.8
// ms and K6 -2.5% at their headlines) or with cosf and sinf, which K8's
// replay runs 3% faster with (timed on an H100, PERF.md).
constexpr bool kSinCos = true;

// Shade a hit on triangle `idx` for a ray of direction d: flip the
// normal, draw two LCG uniforms (the seed advances only here, on a hit)
// and sample the next direction.
template <bool kJoint = kSinCos>
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
  float saz, caz, sel, cel;
  if constexpr (kJoint) {
    sincosf(az, &saz, &caz);
    sincosf(el, &sel, &cel);
  } else {
    caz = cosf(az);
    cel = cosf(el);
    saz = sinf(az);
    sel = sinf(el);
  }
  s.sx = caz * cel;
  s.sy = sel;
  s.sz = saz * cel;
  if (!(s.nx * s.sx + s.ny * s.sy + s.nz * s.sz >= 0.0f)) {
    s.sx = -s.sx;
    s.sy = -s.sy;
    s.sz = -s.sz;
  }
  s.w = 2.0f * (s.sx * s.nx + s.sy * s.ny + s.sz * s.nz);
  return s;
}

// Longest path the backward kernels' saved per-bounce state holds (K2,
// K4, K8, K10): K8's local arrays, K2's and K4's epochs (and so their
// rings). A shorter path reads and writes only its own bounces' slots.
constexpr int kMaxBounces = 64;

// A recorder that keeps nothing (K6).
struct NoRecord {
  __device__ __forceinline__ void operator()(int, int, const Surface&, float,
                                             float, float) {}
};

// A recorder of what the reverse sweep needs of each bounce of one sample
// (K8): the hit index, the flip sign fs, the sampled direction om, the
// weight w and the throughput tr before the bounce; len is the number of
// hits.
struct Saved {
  int len = 0;
  int idx[kMaxBounces];
  float fs[kMaxBounces], w[kMaxBounces];
  float omx[kMaxBounces], omy[kMaxBounces], omz[kMaxBounces];
  float tr[kMaxBounces], tg[kMaxBounces], tb[kMaxBounces];

  __device__ __forceinline__ void operator()(int b, int hit, const Surface& s,
                                             float thr_r, float thr_g,
                                             float thr_b) {
    idx[b] = hit;
    fs[b] = s.fs;
    w[b] = s.w;
    omx[b] = s.sx;
    omy[b] = s.sy;
    omz[b] = s.sz;
    tr[b] = thr_r;
    tg[b] = thr_g;
    tb[b] = thr_b;
    len = b + 1;
  }
};

// One sample's path between sweeps: the ray (origin o, direction d, and
// src, the triangle it leaves, -1 for a camera ray), the throughput
// before the next hit and the radiance gathered so far.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  int src;
  float thr_r, thr_g, thr_b;
  float rad_r, rad_g, rad_b;

  // A new sample along the camera ray o0 + t d0.
  __device__ __forceinline__ void start(float ox0, float oy0, float oz0,
                                        float dx0, float dy0, float dz0) {
    ox = ox0;
    oy = oy0;
    oz = oz0;
    dx = dx0;
    dy = dy0;
    dz = dz0;
    src = -1;
    thr_r = 1.0f;
    thr_g = 1.0f;
    thr_b = 1.0f;
    rad_r = 0.0f;
    rad_g = 0.0f;
    rad_b = 0.0f;
  }
};

// One bounce of the conformance walk at the hit h (h.idx >= 0) of the
// path's ray: shade the hit (two LCG draws, the angle sampler), add its
// emission times the throughput, scale the throughput, and turn the ray
// into the sampled direction from the hit point. rec(bounce, idx,
// surface, tr, tg, tb) sees the throughput before the bounce. Every walk
// of K1, K2, K6 and K8 runs its bounces through this step (kJoint: as
// surface() takes it).
template <bool kJoint = kSinCos, class Rec>
__device__ __forceinline__ void walk_step(const float* __restrict__ tri,
                                          const Hit& h, int bounce,
                                          uint32_t& seed, Path& p,
                                          Rec& rec) {
  const Surface sf = surface<kJoint>(tri, h.idx, p.dx, p.dy, p.dz, seed);
  const float* r = tri + h.idx * kCols;
  const float ar = __ldg(r + 12), ag = __ldg(r + 13), ab = __ldg(r + 14);
  const float er = __ldg(r + 15), eg = __ldg(r + 16), eb = __ldg(r + 17);
  rec(bounce, h.idx, sf, p.thr_r, p.thr_g, p.thr_b);

  p.rad_r = p.rad_r + p.thr_r * er;
  p.rad_g = p.rad_g + p.thr_g * eg;
  p.rad_b = p.rad_b + p.thr_b * eb;
  p.thr_r = p.thr_r * ar * sf.w;
  p.thr_g = p.thr_g * ag * sf.w;
  p.thr_b = p.thr_b * ab * sf.w;

  p.ox = p.ox + h.dist * p.dx;
  p.oy = p.oy + h.dist * p.dy;
  p.oz = p.oz + h.dist * p.dz;
  p.dx = sf.sx;
  p.dy = sf.sy;
  p.dz = sf.sz;
  p.src = h.idx;
}

}  // namespace spath
