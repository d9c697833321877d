// The lane loop of the fused conformance kernels, K1 (megakernel.cu) and
// K2 (megakernel_grad.cu): a lane owns a pixel and walks its samples one
// bounce a step, so that a warp's lanes stay busy while their paths end
// at different bounces. (Counted: the loop it replaced, sample_walk in
// lockstep, a thread a pixel walking each sample as long as its warp's
// longest path, left 50.7% of its lanes idle at the conformance
// headline; PERF.md.)
//
// Each step of a warp is one sweep of the table a lane (nearest, each
// thread reading the table through the cache on its own): a new pixel's
// camera ray, or the next ray of its sample's path. Around it the lane
// runs walk_step (megakernel_common.cuh) on each hit, as sample_walk
// does; when a sample's path ends (a miss, or its last bounce) the lane
// starts the pixel's next sample from the camera ray's hit at once, and
// when the pixel's samples are done it takes the next pixel from its
// PixelSource (pixel_source.cuh). A pixel whose camera ray misses has
// only samples without a hit, whose radiance is zero and whose seed does
// not move: the lane ends them all at once.
//
// A pixel's samples run in order in one lane from the pixel's seed, so
// whatever a kernel computes from them is the same function of the pixel,
// whichever lane runs it and when: K1's frame is sample_walk's to the bit.
//
// The kernel's lane hooks (a struct, one per thread):
//   take(w)             the lane took pixel w.pix
//   (b, idx, s, tr, tg, tb)
//                       walk_step's recorder: bounce b hit triangle idx,
//                       shaded as s, with the throughput before it
//   sample(w)           sample w.s is over after w.b bounces, which hit
//   pixel(w)            the pixel's samples are done
//   pause(max_bounces)  whether the lane waits before its pixel's next
//                       sample (K2: until its ring has room for it)
// No hook synchronises: they run in the lane alone.

#pragma once

#include "megakernel_common.cuh"
#include "pixel_source.cuh"

namespace spath {

// What every lane of a launch walks: the (T, 18) table and the walk's
// sizes.
struct ConfArgs {
  const float* __restrict__ tri;
  int n_tris, spp, max_bounces;
};

// A lane's walk: its pixel, its seed, and the sample's path between
// sweeps.
struct ConfLane {
  int mode, pix, s, b;  // b: the sample's bounces done, each a hit
  bool drained;
  float ox0, oy0, oz0, dx0, dy0, dz0;  // the pixel's camera ray
  uint32_t seed;
  Hit first;  // the camera ray's hit, the same for every sample
  Path p;

  __device__ __forceinline__ void init() {
    mode = kLaneIdle;
    pix = s = b = 0;
    drained = false;
    ox0 = oy0 = oz0 = dx0 = dy0 = dz0 = 0.0f;
    seed = 0u;
    first = Hit{kBig, -1};
    p.start(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  }

  // Walks the sample on from h, the hit of its bounce b, until the lane's
  // next sweep: the bounce, and the samples that start as one ends.
  // Returns the lane's mode after it: kLaneBounce (a sweep to make),
  // kLaneIdle (the pixel's samples are done) or kLaneSample (the kernel
  // paused the lane before its next sample: ln.pause).
  template <class Lane>
  __device__ __forceinline__ int walk_on(const ConfArgs& a, Hit h,
                                         Lane& ln) {
    for (;;) {
      if (b < a.max_bounces && h.idx >= 0) {
        walk_step(a.tri, h, b, seed, p, ln);
        ++b;
        if (b < a.max_bounces) return kLaneBounce;
      }
      ln.sample(*this);
      // no hit: the camera ray missed (or max_bounces is 0), and every
      // later sample of the pixel ends so, with nothing to add
      if (b == 0) s = a.spp - 1;
      if (++s == a.spp) return kLaneIdle;
      if (ln.pause(a.max_bounces)) return kLaneSample;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      h = first;
      b = 0;
    }
  }

  // One step of the warp (every lane calls it): lanes without a pixel
  // take one, paused lanes resume, then one sweep a lane and the walk on
  // to the next sweep. Returns false, warp-uniformly, once every lane is
  // idle and no pixel is left.
  template <class Lane>
  __device__ __forceinline__ bool step(const ConfArgs& a, PixelSource& src,
                                       const float* __restrict__ origins,
                                       const float* __restrict__ directions,
                                       const int64_t* __restrict__ seeds,
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
        seed = static_cast<uint32_t>(seeds[k]);
        s = 0;
        b = 0;
        p.start(ox0, oy0, oz0, dx0, dy0, dz0);
        mode = kLaneCamera;
        ln.take(*this);
      } else {
        drained = true;
      }
    }
    if (mode == kLaneSample && !ln.pause(a.max_bounces)) {
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      b = 0;
      mode = walk_on(a, first, ln);
      if (mode == kLaneIdle) ln.pixel(*this);
    }
    // (a lane whose resumed samples ended its pixel takes the next one at
    // the next step)
    if (!__any_sync(kFull, mode != kLaneIdle || !drained)) return false;
    const bool camera = mode == kLaneCamera;
    if (!camera && mode != kLaneBounce) return true;

    // the camera ray (p as p.start left it: src -1) or the next ray
    const Hit h = nearest(a.tri, a.n_tris, p.ox, p.oy, p.oz, p.dx, p.dy,
                          p.dz, p.src);
    if (camera) {
      first = h;
      if (ln.pause(a.max_bounces)) {
        mode = kLaneSample;  // sample 0 waits, as a later sample would
        return true;
      }
    }
    mode = walk_on(a, h, ln);
    if (mode == kLaneIdle) ln.pixel(*this);
    return true;
  }
};

}  // namespace spath
