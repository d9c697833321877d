// Reverse sweep of the large-scene quality path tracer (K10).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene_quality.py::_bigq_bwd_kernel
// (launched there by bigq_bwd_call). For each sample of a pixel it
// replays K9's walk (quality_walk.cuh: K9's bounce halves, bounce_begin
// and bounce_end, through the streamed backend StreamQuality, so the same
// hits, draws and lights bit for bit), saving per bounce what K4 saves,
// then runs K4's reverse sweep with the live position chain
// (quality_reverse.cuh: reverse_bounce) from the last hit back to the
// camera.
//
// Instead of adding into a (T, 19) adjoint held on chip (K4's per-warp
// slices, impossible at 2^20 triangles), each (sample, bounce, ray) writes
// two events to a buffer at fixed slots: a surface event at the hit
// triangle (columns 0-17; area 0) at ((k * B + b) * 2) * n + i, and a
// light event at the light whose NEE term counted (columns 0-11 and
// 15-18; albedo 0) at ((k * B + b) * 2 + 1) * n + i, k the sample's index
// in the launch, B = max_bounces; either gets index -1 where it does not
// apply. No atomics. The stream scatter K7 (stream_scatter.cu, at 19
// columns) then adds the events into the adjoint in event order. The
// camera-ray adjoint (origin, direction) is summed per pixel over samples
// in K4's order.
//
// The schedule is K9's, in the loop they share (quality_queue.cuh): a
// queue of pixels on a persistent grid (the card's resident CTAs of this
// kernel, ops/kernels/bigscene.py::queue_plan), one int32 counter a
// launch that the wrapper zeroes, and each CTA-wide sweep carrying a
// camera ray, a shadow ray with or without the next ray, or the next ray
// alone, lane by lane (StreamQuality::mixed). When a sample's path ends
// (a miss, the roulette or its last bounce) the lane runs that sample's
// reverse sweep at once, with no CTA barrier, as K8 does (bigscene_grad.cu),
// and starts the pixel's next sample from the camera hit. In lockstep (the
// first port: a thread a ray, each sample's walk through quality_sample,
// a CTA sweeping as often as its longest path needed) 75% of the lanes
// idled through the sweeps of the 10k-triangle 1080p 4-spp training
// frame. A pixel's samples run in order in one lane and the hash stream is
// stateless, so each event, at its fixed slot, and each pixel's ray
// adjoint, summed in sample order, are the same bits as in lockstep,
// whichever lane writes them: K7's input and the table gradient do not
// change launch to launch.
//
// Chunks: a frame's events can pass memory (at 1920x1080 and 5 bounces
// one sample is 2 x 80 B x 5 x 2,073,600 = 1.66 GB), so the wrapper
// launches the kernel once per chunk of samples, each launch followed by
// K7. The first launch (s0 == 0) sweeps each pixel's camera ray once,
// keeps its hit in first_dist/first_idx and starts the ray adjoint at
// zero; later launches read both back and sweep no camera ray (a pixel
// whose camera ray missed writes -1 into all its slots without a sweep),
// so the chunks replay one walk and sum the ray adjoint in one order.
//
// Bound: compute, as K9: the replay repeats K9's sweeps; the reverse sweep
// adds ~155 float operations a hit and ~206 where the NEE term counted;
// each (sample, bounce, ray) writes 160 bytes of events. The 64 bounces of
// saved state (Bounce, 64 bytes each) live on the thread's stack.
//
// Layouts (checked by the Python wrapper
// ops/kernels/bigscene_quality_grad.py), all contiguous:
//   origins, directions, keys, tri, rows, lcdf   as K9 (bigscene_quality.cu)
//   gbar                 float32 (n, 3): the cotangent of K9's output
//   first_dist, first_idx   float32, int32 (n): carried
//   grays                float32 (n, 6): d(loss)/d(origin, direction),
//                        carried and summed over the chunks
//   ev_idx, ev_val       int32 (E), float32 (E, 19), E = chunk *
//                        max_bounces * 2 * n
//   next_pixel           int32 (1): the launch's queue counter, 0 at launch
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_queue.cuh"
#include "quality_reverse.cuh"

namespace {

using spath::Bounce;
using spath::Hit;
using spath::kAdj19;
using spath::kMaxBounces;
using spath::kStreamThreads;
using spath::QualityArgs;

// K10's hooks of the queue (quality_queue.cuh): each bounce saved, each
// sample's reverse sweep as its path ends, the pixel's ray adjoint summed
// in sample order.
struct BackwardLane {
  const float* __restrict__ gbar;
  float* __restrict__ first_dist;
  int* __restrict__ first_idx;
  float* __restrict__ grays;
  int* __restrict__ ev_idx;
  float* __restrict__ ev_val;
  int n, s0;
  float g_r, g_g, g_b;  // the pixel's cotangent over spp
  // the camera ray's adjoint, summed over samples
  float go_x, go_y, go_z, gd_x, gd_y, gd_z;
  Bounce st[kMaxBounces];

  __device__ __forceinline__ void take(const QualityArgs& a, int k) {
    g_r = gbar[3 * k + 0] * a.inv_spp;
    g_g = gbar[3 * k + 1] * a.inv_spp;
    g_b = gbar[3 * k + 2] * a.inv_spp;
    if (s0 > 0) {
      go_x = grays[6 * k + 0];
      go_y = grays[6 * k + 1];
      go_z = grays[6 * k + 2];
      gd_x = grays[6 * k + 3];
      gd_y = grays[6 * k + 4];
      gd_z = grays[6 * k + 5];
    } else {
      go_x = go_y = go_z = gd_x = gd_y = gd_z = 0.0f;
    }
  }
  __device__ __forceinline__ Hit first(int k) const {
    return Hit{first_dist[k], first_idx[k]};
  }
  // Only the first launch (s0 == 0) sweeps the camera rays.
  __device__ __forceinline__ void camera(int k, const Hit& h) const {
    first_dist[k] = h.dist;
    first_idx[k] = h.idx;
  }
  __device__ __forceinline__ void end(const QualityArgs& a, int b, int occ,
                                      int, int, spath::QualityPath& p,
                                      spath::QualityStep& x) {
    spath::bounce_end(a, b, occ, p, x, spath::Saver{st});
  }
  // The reverse sweep of sample s, whose path hit at its first len
  // bounces: two events a bounce, -1 from len on.
  __device__ __forceinline__ void sample(const QualityArgs& a, int pix,
                                         int s, int len, uint32_t h1,
                                         const spath::QualityPath&) {
    const int nb = a.max_bounces;
    const uint32_t sc = static_cast<uint32_t>(s) * spath::kC1;
    float tb_r = 0.0f, tb_g = 0.0f, tb_b = 0.0f;  // thr-bar after bounce b
    float ob_x = 0.0f, ob_y = 0.0f, ob_z = 0.0f;  // o-bar of bounce b + 1
    for (int b = nb - 1; b >= 0; --b) {
      const size_t es = (static_cast<size_t>(s - s0) * nb + b) * 2 * n +
                        static_cast<size_t>(pix);
      const size_t el = es + static_cast<size_t>(n);
      if (b >= len) {
        ev_idx[es] = -1;
        ev_idx[el] = -1;
        continue;
      }
      const Bounce& B = st[b];
      float* sf = ev_val + es * kAdj19;
      float lt[spath::kLight];
      spath::ReverseOut ro;
      const int li = spath::reverse_bounce(a, h1, sc, b, B, g_r, g_g, g_b,
                                           tb_r, tb_g, tb_b, ob_x, ob_y,
                                           ob_z, sf, lt, ro);
      sf[18] = 0.0f;
      ev_idx[es] = B.idx;
      ev_idx[el] = li;
      if (li >= 0) {
        float* lv = ev_val + el * kAdj19;
        for (int c = 0; c < 12; ++c) lv[c] = lt[c];
        lv[12] = 0.0f;
        lv[13] = 0.0f;
        lv[14] = 0.0f;
        for (int c = 12; c < spath::kLight; ++c) lv[c + 3] = lt[c];
      }
      // the origin's adjoint goes to the bounce before, or at bounce 0
      // to the camera ray with the direction's
      if (b == 0) {
        go_x = go_x + ro.on_x;
        go_y = go_y + ro.on_y;
        go_z = go_z + ro.on_z;
        gd_x = gd_x + ro.gd_x;
        gd_y = gd_y + ro.gd_y;
        gd_z = gd_z + ro.gd_z;
      } else {
        ob_x = ro.on_x;
        ob_y = ro.on_y;
        ob_z = ro.on_z;
      }
    }
  }
  __device__ __forceinline__ void pixel(const QualityArgs&, int k) const {
    grays[6 * k + 0] = go_x;
    grays[6 * k + 1] = go_y;
    grays[6 * k + 2] = go_z;
    grays[6 * k + 3] = gd_x;
    grays[6 * k + 4] = gd_y;
    grays[6 * k + 5] = gd_z;
  }
};

// At least 4 resident CTAs an SM: ptxas then keeps 128 registers, against
// 152 and 3 CTAs an SM without the bound (8% slower on the 10k 1080p
// 4-spp training frame on an H100; 5 CTAs, 96 registers: 6% slower).
__global__ void __launch_bounds__(kStreamThreads, 4)
    bigscene_quality_backward(
        const float* __restrict__ origins,
        const float* __restrict__ directions,
        const int64_t* __restrict__ keys, const float* __restrict__ lcdf,
        const float* __restrict__ gbar, float* __restrict__ first_dist,
        int* __restrict__ first_idx, float* __restrict__ grays,
        int* __restrict__ ev_idx, float* __restrict__ ev_val,
        int* __restrict__ next_pixel, int n, QualityArgs a, int s0,
        int chunk) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const spath::StreamQuality be{a.tri, a.n_tris, tiles, a.rows, lcdf,
                                a.n_rows};
  BackwardLane ln;
  ln.gbar = gbar;
  ln.first_dist = first_dist;
  ln.first_idx = first_idx;
  ln.grays = grays;
  ln.ev_idx = ev_idx;
  ln.ev_val = ev_val;
  ln.n = n;
  ln.s0 = s0;
  spath::quality_queue(a, be, origins, directions, keys, next_pixel, n, s0,
                       s0 + chunk, s0 > 0, ln);
}

}  // namespace

// CTAs of K10 resident on one SM (the persistent grid is this times the
// SMs), or a negative cudaError_t.
extern "C" int spath_bigscene_quality_backward_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bigscene_quality_backward, kStreamThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// flags: as spath::make_args takes them.
extern "C" int spath_bigscene_quality_backward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, const float* gbar,
    float* first_dist, int* first_idx, float* grays, int* ev_idx,
    float* ev_val, int* next_pixel, int n, int n_tris, int n_rows, int spp,
    int max_bounces, int rr_start, int flags, float inv_spp, int s0,
    int chunk, int grid, void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || n_rows < 0 ||
      spp < 1 || max_bounces < 0 || max_bounces > kMaxBounces ||
      rr_start < 0 || s0 < 0 || chunk < 1 || s0 + chunk > spp || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  bigscene_quality_backward<<<grid, kStreamThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, lcdf, gbar, first_dist, first_idx, grays,
      ev_idx, ev_val, next_pixel, n, a, s0, chunk);
  return static_cast<int>(cudaGetLastError());
}
