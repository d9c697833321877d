// The queue of pixels of the streamed quality kernels, one loop for the
// forward K9 and its hit export K11 (bigscene_quality.cu) and the reverse
// sweep K10 (bigscene_quality_grad.cu).
//
// A persistent grid (the card's resident CTAs of the kernel,
// ops/kernels/bigscene.py::queue_plan) takes pixels from one int32
// counter in device memory (zeroed by the wrapper), a warp at a time with
// one atomic; a lane whose pixel is done, or whose camera ray missed,
// takes the next unstarted pixel. When a sample's path ends (a miss, the
// roulette, or its last bounce) the lane hands it to its kernel's hook
// at once and starts the pixel's next sample from the camera hit, which
// needs no sweep. So one CTA-wide sweep carries, lane by lane, one of
// three loads: a new pixel's camera ray; a bounce's shadow ray and next
// ray (two rays from the hit point); or one ray, a last (or
// roulette-ending) bounce's shadow ray, or without NEE the next ray
// (StreamQuality::mixed). Every bounce is quality_walk.cuh's two halves,
// bounce_begin and bounce_end, around its sweep, as in quality_sample.
//
// A pixel's samples run in order in one lane and the hash stream is
// stateless (draw(h1, s * C1, b, k)), so whatever a kernel computes from
// a pixel's samples is the same function of the pixel as in lockstep;
// which lane runs which pixel, and when, varies from launch to launch.
//
// The kernel's lane hooks (a struct, one per thread):
//   take(a, k)            pixel k joins the lane
//   first(k)              pixel k's camera hit, read back (camera_known)
//   camera(k, h)          pixel k's camera hit h, just swept
//   end(a, b, occ, s, k, p, x)   bounce_end of bounce b with the shadow
//                         ray's hit occ, through the kernel's recorder
//   sample(a, k, s, len, h1, p)  sample s's path is over after len
//                         bounces, which hit
//   pixel(a, k)           the pixel's samples are done
// No hook synchronises: they run in the lane alone.

#pragma once

#include "quality_walk.cuh"

namespace spath {

// What a lane's next sweep carries.
enum QueueMode : int { kQueueIdle = 0, kQueueCamera = 1, kQueueBounce = 2 };

// Runs samples [s_begin, s_end) of each of the n pixels through the
// CTA's lanes. camera_known: the camera hits are read back (ln.first)
// instead of swept, so a lane may finish pixels before it needs a sweep
// (a missed camera ray): its warp then takes again until each lane has a
// ray to sweep or the queue is empty. Every thread of the CTA calls it.
template <class Lane>
__device__ __forceinline__ void quality_queue(
    const QualityArgs& a, const StreamQuality& be,
    const float* __restrict__ origins, const float* __restrict__ directions,
    const int64_t* __restrict__ keys, int* __restrict__ next_pixel, int n,
    int s_begin, int s_end, bool camera_known, Lane& ln) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nb = a.max_bounces;

  int mode = kQueueIdle;
  bool drained = false;  // the queue is empty for this lane
  int pix = 0;
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;  // the pixel's camera ray
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  uint32_t h1 = 0u;
  Hit first{kBig, -1};
  QualityPath p;
  p.start(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  QualityStep x;
  x.omx = x.omy = x.omz = 0.0f;
  x.more = false;
  int s = 0, b = 0;  // the sample, and its bounces done

  // Walk the lane's sample on from the hit h of its bounce b (ended: its
  // path is over) until its next sweep: the bounces that need none
  // before them, and the samples that start when one ends. Returns
  // whether the pixel's samples are done.
  auto walk_on = [&](Hit h, bool ended) {
    for (;;) {
      if (!ended && b < nb && h.idx >= 0) {
        bounce_begin(a, be, h, b, h1, s, p, x);
        if (a.nee) return false;  // the shadow ray (and the next ray)
        ln.end(a, b, -1, s, pix, p, x);
        ++b;
        if (x.more) return false;  // the next ray to sweep
      }
      ln.sample(a, pix, s, b, h1, p);
      if (++s == s_end) return true;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      h = first;
      b = 0;
      ended = false;
    }
  };

  for (;;) {
    // Lanes without work take the next pixels, one atomic a warp.
    for (;;) {
      const bool wants = mode == kQueueIdle && !drained;
      const unsigned takers = __ballot_sync(kFull, wants);
      if (takers == 0u) break;
      const int leader = __ffs(takers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(next_pixel, __popc(takers));
      base = __shfl_sync(kFull, base, leader);
      if (wants) {
        const int k = base + __popc(takers & ((1u << lane) - 1u));
        if (k < n) {
          pix = k;
          ox0 = origins[3 * k + 0];
          oy0 = origins[3 * k + 1];
          oz0 = origins[3 * k + 2];
          dx0 = directions[3 * k + 0];
          dy0 = directions[3 * k + 1];
          dz0 = directions[3 * k + 2];
          h1 = fmix(static_cast<uint32_t>(keys[k]));
          ln.take(a, k);
          s = s_begin;
          b = 0;
          p.start(ox0, oy0, oz0, dx0, dy0, dz0);
          if (!camera_known) {
            mode = kQueueCamera;
          } else {
            first = ln.first(k);
            if (walk_on(first, false)) {
              ln.pixel(a, k);
            } else {
              mode = kQueueBounce;
            }
          }
        } else {
          drained = true;
        }
      }
      if (!camera_known) break;  // every taker has a camera ray to sweep
    }
    // Every lane idle means the queue is empty and every pixel done.
    if (!__syncthreads_or(mode != kQueueIdle)) break;

    // One CTA-wide sweep: a camera ray; or with NEE the bounce's shadow
    // ray and, if the path goes on, its next ray; or without NEE the next
    // ray alone.
    const bool camera = mode == kQueueCamera;
    Hit r1, r2;
    be.mixed(mode != kQueueIdle, mode == kQueueBounce && a.nee && x.more,
             camera ? ox0 : p.ox, camera ? oy0 : p.oy, camera ? oz0 : p.oz,
             camera ? dx0 : (a.nee ? x.omx : p.dx),
             camera ? dy0 : (a.nee ? x.omy : p.dy),
             camera ? dz0 : (a.nee ? x.omz : p.dz), p.dx, p.dy, p.dz,
             camera ? -1 : p.src, r1, r2);
    if (mode == kQueueIdle) continue;

    Hit h;               // the hit of the sample's bounce b
    bool ended = false;  // the sample's path is over after b bounces
    if (camera) {
      // Camera rays are the same for every sample: swept once a pixel.
      first = r1;
      ln.camera(pix, first);
      h = first;
    } else if (a.nee) {
      ln.end(a, b, r1.idx, s, pix, p, x);
      ++b;
      h = r2;
      ended = !x.more;
    } else {
      h = r1;  // the next ray's hit; bounce b - 1 ended before the sweep
    }
    if (walk_on(h, ended)) {
      ln.pixel(a, pix);
      mode = kQueueIdle;
    } else {
      mode = kQueueBounce;
    }
  }
}

}  // namespace spath
