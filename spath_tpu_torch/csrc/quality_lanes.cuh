// The lane loop of the fused quality kernels, K3 (megakernel_quality.cu)
// and K4 (megakernel_quality_grad.cu): a lane owns a pixel and walks its
// samples one bounce a step, so a warp's lanes stay busy while their paths
// end at different bounces.
//
// Each step of a warp is one sweep of the table a lane (TableQuality, each
// thread on its own): a new pixel's camera ray; or a bounce's shadow ray
// and, if the path goes on, its next ray (two rays from the hit point);
// or one ray, a last (or roulette-ending) bounce's shadow ray, or without
// NEE the next ray. The warp sweeps two rays a lane where any lane needs
// two, else one (nearest2's results are nearest's, bit for bit). Around
// each sweep the lane runs quality_walk.cuh's halves, bounce_end of the
// bounce just swept and bounce_begin of the next, as quality_sample does;
// when a sample's path ends (a miss, the roulette, or its last bounce) the
// lane starts the pixel's next sample from the camera hit at once, and
// when the pixel's samples are done it takes the next pixel (regeneration,
// as the streamed kernels' queue, quality_queue.cuh, does CTA-wide).
//
// A pixel's samples run in order in one lane and the hash stream is
// stateless, so whatever a kernel computes from a pixel's samples is the
// same function of the pixel, whichever lane runs it and when.
//
// Where the lanes take their pixels: pixel_source.cuh's PixelSource, a
// run sequence for K4 and a queue for K3.
//
// The kernel's lane hooks (a struct, one per thread):
//   take(a, w)          the lane took pixel w.pix
//   end(a, occ, w)      bounce_end of bounce w.b with the shadow ray's hit
//                       occ, through the kernel's recorder
//   sample(a, w)        sample w.s is over after w.b bounces, which hit
//   pixel(a, w)         the pixel's samples are done
//   pause(a)            whether the lane waits before its pixel's next
//                       sample (K4: until its ring has room for it)
// No hook synchronises: they run in the lane alone.

#pragma once

#include "pixel_source.cuh"
#include "quality_walk.cuh"

namespace spath {

// A lane's walk: its pixel, the sample's path between sweeps, and what
// the next sweep carries.
struct LaneWalk {
  int mode, pix, s, b;  // b: the sample's bounces done
  bool drained;
  float ox0, oy0, oz0, dx0, dy0, dz0;  // the pixel's camera ray
  uint32_t h1;
  Hit first;  // the camera ray's hit, the same for every sample
  QualityPath p;
  QualityStep x;

  __device__ __forceinline__ void init() {
    mode = kLaneIdle;
    pix = s = b = 0;
    drained = false;
    ox0 = oy0 = oz0 = dx0 = dy0 = dz0 = 0.0f;
    h1 = 0u;
    first = Hit{kBig, -1};
    p.start(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    x.omx = x.omy = x.omz = 0.0f;
    x.more = false;
  }

  // Walks the sample on from the hit h of its bounce b (ended: its path
  // is over) until the lane's next sweep: the bounces that need none
  // before them, and the samples that start when one ends. Returns the
  // lane's mode after it: kLaneBounce (a sweep to make), kLaneIdle (the
  // pixel's samples are done) or kLaneSample (the kernel paused the lane
  // before its next sample: ln.pause).
  template <class Lane>
  __device__ __forceinline__ int walk_on(const QualityArgs& a,
                                         const TableQuality& be, Hit h,
                                         bool ended, Lane& ln) {
    for (;;) {
      if (!ended && b < a.max_bounces && h.idx >= 0) {
        bounce_begin(a, be, h, b, h1, s, p, x);
        if (a.nee) return kLaneBounce;  // the shadow ray (and the next)
        ln.end(a, -1, *this);
        ++b;
        if (x.more) return kLaneBounce;  // the next ray
      }
      ln.sample(a, *this);
      if (++s == a.spp) return kLaneIdle;
      if (ln.pause(a)) return kLaneSample;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      h = first;
      b = 0;
      ended = false;
    }
  }

  // One step of the warp (every lane calls it): lanes without a pixel
  // take one, paused lanes resume, then one sweep a lane and the walk on
  // to the next sweep. Returns false, warp-uniformly, once every lane is
  // idle and no pixel is left.
  template <class Lane>
  __device__ __forceinline__ bool step(const QualityArgs& a,
                                       const TableQuality& be,
                                       PixelSource& src,
                                       const float* __restrict__ origins,
                                       const float* __restrict__ directions,
                                       const int64_t* __restrict__ keys,
                                       Lane& ln) {
    constexpr unsigned kFull = 0xffffffffu;
    const bool wants = mode == kLaneIdle && !drained;
    const int k = src.take(wants);
    if (wants) {
      if (k < src.n) {
        pix = k;
        ox0 = origins[3 * k + 0];
        oy0 = origins[3 * k + 1];
        oz0 = origins[3 * k + 2];
        dx0 = directions[3 * k + 0];
        dy0 = directions[3 * k + 1];
        dz0 = directions[3 * k + 2];
        h1 = fmix(static_cast<uint32_t>(keys[k]));
        s = 0;
        b = 0;
        p.start(ox0, oy0, oz0, dx0, dy0, dz0);
        mode = kLaneCamera;
        ln.take(a, *this);
      } else {
        drained = true;
      }
    }
    if (mode == kLaneSample && !ln.pause(a)) {
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      b = 0;
      mode = walk_on(a, be, first, false, ln);
      if (mode == kLaneIdle) ln.pixel(a, *this);
    }
    // (a lane whose resumed samples ended its pixel takes the next one at
    // the next step)
    if (!__any_sync(kFull, mode != kLaneIdle || !drained)) return false;

    const bool camera = mode == kLaneCamera;
    const bool two = mode == kLaneBounce && a.nee && x.more;
    const bool wide = __any_sync(kFull, two);
    const bool sweeps = camera || mode == kLaneBounce;
    Hit r1{kBig, -1}, r2{kBig, -1};
    if (sweeps) {
      const float ox = camera ? ox0 : p.ox, oy = camera ? oy0 : p.oy,
                  oz = camera ? oz0 : p.oz;
      const float d1x = camera ? dx0 : (a.nee ? x.omx : p.dx);
      const float d1y = camera ? dy0 : (a.nee ? x.omy : p.dy);
      const float d1z = camera ? dz0 : (a.nee ? x.omz : p.dz);
      const int from = camera ? -1 : p.src;
      if (wide) {
        be.two(ox, oy, oz, d1x, d1y, d1z, p.dx, p.dy, p.dz, from, r1, r2);
      } else {
        r1 = be.one(ox, oy, oz, d1x, d1y, d1z, from);
      }
    }
    if (!sweeps) return true;

    Hit h;               // the hit of the sample's bounce b
    bool ended = false;  // the sample's path is over after b bounces
    if (camera) {
      first = r1;
      if (ln.pause(a)) {
        mode = kLaneSample;  // sample 0 waits, as a later sample would
        return true;
      }
      h = first;
    } else if (a.nee) {
      ln.end(a, r1.idx, *this);
      ++b;
      h = r2;
      ended = !x.more;
    } else {
      h = r1;  // the next ray's hit; bounce b - 1 ended before the sweep
    }
    mode = walk_on(a, be, h, ended, ln);
    if (mode == kLaneIdle) ln.pixel(a, *this);
    return true;
  }
};

}  // namespace spath
