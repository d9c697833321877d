// Reverse sweep of the large-scene conformance path tracer (K8).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene_grad.py::_bigscene_bwd_kernel
// (launched there by bigscene_bwd_call). For each sample of a pixel it
// replays K6's walk (megakernel_common.cuh: walk_step through
// stream_sweep.cuh's StreamSweep, the same hits, draws and directions bit
// for bit), saving per bounce the hit index, the flip sign fs, the
// sampled direction om, the weight w and the throughput tr before the
// bounce, then runs K2's reverse sweep (megakernel_grad.cu) from the last
// hit back to the camera, with g = gbar / spp and bb the adjoint of the
// throughput after the bounce:
//
//   nbar = 2 * wbar * fs * om, wbar = sum_c bb_c * tr_c * albedo_c
//   abar = bb * tr * w,  ebar = g * tr,  bb = g * emission + bb * albedo * w
//
// Instead of adding into a (T, 9) adjoint held on chip (K2's scheme,
// impossible at 2^20 triangles), each (sample, bounce, ray) writes one
// event to a buffer at a fixed slot, ((s * max_bounces + b) * n + i): the
// triangle index, or -1 where the path had ended, and the 9 adjoints
// (normal, albedo, emission). No atomics. The stream scatter K7
// (stream_scatter.cu) then adds the events into the adjoint in event
// order. The hit positions never enter a continuous quantity of this
// estimator, so the vertex columns and the camera rays get no adjoint.
//
// The schedule is K6's (bigscene.cu): a queue of pixels on a persistent
// grid (the card's resident CTAs of this kernel,
// ops/kernels/bigscene.py::queue_plan), one int32 counter a launch that
// the wrapper zeroes; a lane takes the next pixel when its own is done,
// and when a sample's path ends (a miss, or its last bounce) the lane
// runs that sample's reverse sweep at once, with no CTA barrier, and
// starts the pixel's next sample from the camera hit, so each CTA-wide
// sweep carries live rays. A pixel's events and LCG state are the same
// function of its ray and seed as in lockstep: its samples run in order
// from its one LCG state, and each event goes to its fixed slot whichever
// lane writes it, so K7's input, and the table gradient, are the same
// bits launch to launch.
//
// Chunks: a frame's events can pass memory (at 1920x1080 one sample is
// 415 MB), so the wrapper launches the kernel once per chunk of samples,
// each launch followed by K7. The first launch (s0 == 0) sweeps each
// pixel's camera ray once and keeps its hit in first_dist/first_idx;
// later launches read it back and sweep no camera ray. Every launch
// starts a pixel from the LCG state in `state` (from `seeds` when
// s0 == 0) and leaves it there when the pixel's chunk is done, so the
// chunks replay one walk. A pixel whose camera ray missed writes -1 into
// all its chunk * max_bounces slots, and its seed does not move.
//
// Bound: compute, as K6: the replay repeats K6's sweeps; the reverse
// sweep adds ~40 operations a hit; each event writes 40 bytes.
//
// Layouts (checked by the Python wrapper ops/kernels/bigscene_grad.py),
// all contiguous:
//   origins, directions  float32 (n, 3); seeds int64 (n); tri (T, 18)
//   gbar                 float32 (n, 3): the cotangent of K6's output
//   first_dist, first_idx, state   float32, int32, int32 (n): carried
//   ev_idx, ev_val       int32 (E), float32 (E, 9), E = chunk *
//                        max_bounces * n
//   next_pixel           int32 (1): the launch's queue counter, 0 at launch
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kMaxBounces;
using spath::kStreamThreads;

constexpr int kAdj = 9;
constexpr unsigned kFull = 0xffffffffu;

// What a lane's next sweep carries.
enum Mode : int { kIdle = 0, kCamera = 1, kBounce = 2 };

// The reverse sweep of one sample (local index s in the chunk) of pixel
// i from its saved bounces: one event a bounce, -1 from the path's length
// on.
__device__ __forceinline__ void reverse_events(
    const float* __restrict__ tri, const spath::Saved& sv, int s, int i,
    int n, int max_bounces, float g_r, float g_g, float g_b,
    int* __restrict__ ev_idx, float* __restrict__ ev_val) {
  float bb_r = 0.0f, bb_g = 0.0f, bb_b = 0.0f;  // thr-bar after bounce b
  for (int b = max_bounces - 1; b >= 0; --b) {
    const size_t e =
        (static_cast<size_t>(s) * max_bounces + b) * n + static_cast<size_t>(i);
    if (b >= sv.len) {
      ev_idx[e] = -1;
      continue;
    }
    const int idx = sv.idx[b];
    const float* r = tri + idx * spath::kCols;
    const float ar = __ldg(r + 12), ag = __ldg(r + 13), ab = __ldg(r + 14);
    const float er = __ldg(r + 15), eg = __ldg(r + 16), eb = __ldg(r + 17);
    const float tr = sv.tr[b], tg = sv.tg[b], tb = sv.tb[b];
    const float w = sv.w[b], fs = sv.fs[b];
    const float wbar = bb_r * tr * ar + bb_g * tg * ag + bb_b * tb * ab;
    float* v = ev_val + e * kAdj;
    v[0] = 2.0f * wbar * fs * sv.omx[b];
    v[1] = 2.0f * wbar * fs * sv.omy[b];
    v[2] = 2.0f * wbar * fs * sv.omz[b];
    v[3] = bb_r * tr * w;
    v[4] = bb_g * tg * w;
    v[5] = bb_b * tb * w;
    v[6] = g_r * tr;
    v[7] = g_g * tg;
    v[8] = g_b * tb;
    ev_idx[e] = idx;
    bb_r = g_r * er + bb_r * ar * w;
    bb_g = g_g * eg + bb_g * ag * w;
    bb_b = g_b * eb + bb_b * ab * w;
  }
}

__global__ void __launch_bounds__(kStreamThreads)
    bigscene_backward(const float* __restrict__ origins,
                      const float* __restrict__ directions,
                      const int64_t* __restrict__ seeds,
                      const float* __restrict__ tri,
                      const float* __restrict__ gbar,
                      float* __restrict__ first_dist,
                      int* __restrict__ first_idx, int* __restrict__ state,
                      int* __restrict__ ev_idx, float* __restrict__ ev_val,
                      int* __restrict__ next_pixel, int n, int n_tris,
                      int spp, int max_bounces, int s0, int chunk) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const spath::StreamSweep sweep{tri, n_tris, tiles};
  const int lane = threadIdx.x & 31;
  const float inv = 1.0f / static_cast<float>(spp);

  int mode = kIdle;
  bool drained = false;  // the queue is empty for this lane
  int pix = 0;
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;  // the pixel's camera ray
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
  uint32_t seed = 0u;
  Hit first{spath::kBig, -1};
  spath::Path p;
  p.start(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  spath::Saved sv;
  int s = 0, bounce = 0;  // the chunk's sample, and its next bounce

  // The pixel's camera ray missed: every sample's path is empty and the
  // seed does not move.
  auto missed = [&]() {
    const size_t slots = static_cast<size_t>(chunk) * max_bounces;
    for (size_t k = 0; k < slots; ++k) {
      ev_idx[k * n + static_cast<size_t>(pix)] = -1;
    }
    state[pix] = static_cast<int>(seed);
  };

  // Walk the lane's sample on from the hit h of its bounce `bounce` (h.idx
  // < 0: the path is over) until it needs a sweep, running the reverse
  // sweep of each sample that ends and starting the pixel's next. Returns
  // whether the pixel is done.
  auto walk_on = [&](Hit h) {
    for (;;) {
      if (h.idx >= 0 && bounce < max_bounces) {
        // cosf and sinf: 3% faster here than sincosf (PERF.md)
        spath::walk_step<false>(tri, h, bounce, seed, p, sv);
        if (++bounce < max_bounces) return false;  // the next ray to sweep
      }
      reverse_events(tri, sv, s, pix, n, max_bounces, g_r, g_g, g_b, ev_idx,
                     ev_val);
      if (++s == chunk) {
        state[pix] = static_cast<int>(seed);
        return true;
      }
      sv.len = 0;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      bounce = 0;
      h = first;
    }
  };

  for (;;) {
    // Lanes without work take the next pixels, one atomic a warp. A later
    // chunk reads each pixel's camera hit back, so a lane may finish
    // pixels (a missed camera ray) before it needs a sweep: the warp takes
    // again until each of its lanes has a ray to sweep or the queue is
    // empty.
    for (;;) {
      const bool wants = mode == kIdle && !drained;
      const unsigned takers = __ballot_sync(kFull, wants);
      if (takers == 0u) break;
      const int leader = __ffs(takers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(next_pixel, __popc(takers));
      base = __shfl_sync(kFull, base, leader);
      if (!wants) continue;
      const int k = base + __popc(takers & ((1u << lane) - 1u));
      if (k >= n) {
        drained = true;
        continue;
      }
      pix = k;
      ox0 = origins[3 * k + 0];
      oy0 = origins[3 * k + 1];
      oz0 = origins[3 * k + 2];
      dx0 = directions[3 * k + 0];
      dy0 = directions[3 * k + 1];
      dz0 = directions[3 * k + 2];
      g_r = gbar[3 * k + 0] * inv;
      g_g = gbar[3 * k + 1] * inv;
      g_b = gbar[3 * k + 2] * inv;
      seed = s0 == 0 ? static_cast<uint32_t>(seeds[k])
                     : static_cast<uint32_t>(state[k]);
      if (s0 == 0) {
        mode = kCamera;  // camera rays are swept once a frame
        continue;
      }
      first = Hit{first_dist[k], first_idx[k]};
      if (first.idx < 0) {
        missed();
        continue;
      }
      s = 0;
      sv.len = 0;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      bounce = 0;
      mode = walk_on(first) ? kIdle : kBounce;
    }
    // Every lane idle means the queue is empty and every pixel done.
    if (!__syncthreads_or(mode != kIdle)) break;

    const bool camera = mode == kCamera;
    const Hit h = sweep(mode != kIdle, camera ? ox0 : p.ox,
                        camera ? oy0 : p.oy, camera ? oz0 : p.oz,
                        camera ? dx0 : p.dx, camera ? dy0 : p.dy,
                        camera ? dz0 : p.dz, camera ? -1 : p.src);
    if (mode == kIdle) continue;
    if (camera) {
      first = h;
      first_dist[pix] = first.dist;
      first_idx[pix] = first.idx;
      if (first.idx < 0) {
        missed();
        mode = kIdle;
        continue;
      }
      s = 0;
      sv.len = 0;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      bounce = 0;
    }
    mode = walk_on(h) ? kIdle : kBounce;
  }
}

}  // namespace

// CTAs of K8 resident on one SM (the persistent grid is this times the
// SMs), or a negative cudaError_t.
extern "C" int spath_bigscene_backward_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bigscene_backward, kStreamThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

extern "C" int spath_bigscene_backward(
    const float* origins, const float* directions, const int64_t* seeds,
    const float* tri, const float* gbar, float* first_dist, int* first_idx,
    int* state, int* ev_idx, float* ev_val, int* next_pixel, int n,
    int n_tris, int spp, int max_bounces, int s0, int chunk, int grid,
    void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || spp < 1 ||
      max_bounces < 0 || max_bounces > kMaxBounces || s0 < 0 || chunk < 1 ||
      s0 + chunk > spp || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bigscene_backward<<<grid, kStreamThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, gbar, first_dist, first_idx, state,
      ev_idx, ev_val, next_pixel, n, n_tris, spp, max_bounces, s0, chunk);
  return static_cast<int>(cudaGetLastError());
}
