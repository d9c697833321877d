// Reverse sweep of the large-scene quality path tracer (K10).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene_quality.py::_bigq_bwd_kernel
// (launched there by bigq_bwd_call). One thread owns one ray. For each
// sample it replays K9's walk in lockstep (quality_walk.cuh:
// quality_sample through the streamed backend StreamQuality: K9's bounce
// halves, bounce_begin and bounce_end, and its sweeps, so the same hits,
// draws and lights bit for bit), saving
// per bounce what K4 saves, then runs K4's reverse sweep with the live
// position chain (quality_reverse.cuh: reverse_bounce) from the last hit
// back to the camera.
//
// Instead of adding into a (T, 19) adjoint held on chip (K4's per-warp
// slices, impossible at 2^20 triangles), each (sample, bounce, ray) writes
// two events to a buffer at fixed slots: a surface event at the hit
// triangle (columns 0-17; area 0) at ((s * B + b) * 2) * n + i, and a
// light event at the light whose NEE term counted (columns 0-11 and
// 15-18; albedo 0) at ((s * B + b) * 2 + 1) * n + i, B = max_bounces;
// either gets index -1 where it does not apply. No atomics. The stream
// scatter K7 (stream_scatter.cu, at 19 columns) then adds the events into
// the adjoint in event order. The camera-ray adjoint (origin, direction)
// is summed per ray over samples by its own thread in K4's order.
//
// Chunks: a frame's events can pass memory (at 1920x1080 and 5 bounces
// one sample is 2 x 80 B x 5 x 2,073,600 = 1.66 GB), so the wrapper
// launches the kernel once per chunk of samples, each launch followed by
// K7. The first launch (s0 == 0) sweeps the camera rays and keeps each
// ray's hit in first_dist/first_idx and starts the ray adjoint at zero;
// later launches read both back, so the chunks replay one walk and sum
// the ray adjoint in one order.
//
// Bound: compute, as K9: the replay repeats K9's sweeps; the reverse sweep
// adds ~155 float operations a hit and ~206 where the NEE term counted;
// each (sample, bounce, ray) writes 160 bytes of events.
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
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_reverse.cuh"

namespace {

using spath::Bounce;
using spath::Hit;
using spath::kAdj19;
using spath::kMaxBounces;
using spath::kStreamThreads;
using spath::QualityArgs;

__global__ void __launch_bounds__(kStreamThreads)
    bigscene_quality_backward(
        const float* __restrict__ origins,
        const float* __restrict__ directions,
        const int64_t* __restrict__ keys, const float* __restrict__ lcdf,
        const float* __restrict__ gbar, float* __restrict__ first_dist,
        int* __restrict__ first_idx, float* __restrict__ grays,
        int* __restrict__ ev_idx, float* __restrict__ ev_val, int n,
        QualityArgs a, int s0, int chunk) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const int i = blockIdx.x * kStreamThreads + threadIdx.x;
  // No early return: every thread takes part in the CTA's sweeps.
  const bool live = i < n;
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
  uint32_t h1 = 0u;
  // the camera ray's adjoint, summed over samples
  float go_x = 0.0f, go_y = 0.0f, go_z = 0.0f;
  float gd_x = 0.0f, gd_y = 0.0f, gd_z = 0.0f;
  if (live) {
    ox0 = origins[3 * i + 0];
    oy0 = origins[3 * i + 1];
    oz0 = origins[3 * i + 2];
    dx0 = directions[3 * i + 0];
    dy0 = directions[3 * i + 1];
    dz0 = directions[3 * i + 2];
    g_r = gbar[3 * i + 0] * a.inv_spp;
    g_g = gbar[3 * i + 1] * a.inv_spp;
    g_b = gbar[3 * i + 2] * a.inv_spp;
    h1 = spath::fmix(static_cast<uint32_t>(keys[i]));
    if (s0 > 0) {
      go_x = grays[6 * i + 0];
      go_y = grays[6 * i + 1];
      go_z = grays[6 * i + 2];
      gd_x = grays[6 * i + 3];
      gd_y = grays[6 * i + 4];
      gd_z = grays[6 * i + 5];
    }
  }
  const spath::StreamQuality be{a.tri, a.n_tris, tiles, a.rows, lcdf,
                                a.n_rows};
  Hit first{spath::kBig, -1};
  if (s0 == 0) {
    // Camera rays are the same for every sample: swept once a frame.
    first = be.one(live, ox0, oy0, oz0, dx0, dy0, dz0, -1);
    if (live) {
      first_dist[i] = first.dist;
      first_idx[i] = first.idx;
    }
  } else if (live) {
    first = Hit{first_dist[i], first_idx[i]};
  }

  Bounce st[kMaxBounces];
  const int nb = a.max_bounces;
  for (int k = 0; k < chunk; ++k) {
    const int s = s0 + k;
    // ---- forward replay of K9's walk ----
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    const int len =
        spath::quality_sample(a, be, live, ox0, oy0, oz0, dx0, dy0, dz0,
                              first, h1, s, rr, rg, rb, spath::Saver{st});
    if (!live) continue;
    const uint32_t sc = static_cast<uint32_t>(s) * spath::kC1;

    // ---- reverse sweep, two events a bounce ----
    float tb_r = 0.0f, tb_g = 0.0f, tb_b = 0.0f;  // thr-bar after bounce b
    float ob_x = 0.0f, ob_y = 0.0f, ob_z = 0.0f;  // o-bar of bounce b + 1
    for (int b = nb - 1; b >= 0; --b) {
      const size_t es = (static_cast<size_t>(k) * nb + b) * 2 * n +
                        static_cast<size_t>(i);
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
  if (live) {
    grays[6 * i + 0] = go_x;
    grays[6 * i + 1] = go_y;
    grays[6 * i + 2] = go_z;
    grays[6 * i + 3] = gd_x;
    grays[6 * i + 4] = gd_y;
    grays[6 * i + 5] = gd_z;
  }
}

}  // namespace

// flags: as spath::make_args takes them.
extern "C" int spath_bigscene_quality_backward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, const float* gbar,
    float* first_dist, int* first_idx, float* grays, int* ev_idx,
    float* ev_val, int n, int n_tris, int n_rows, int spp, int max_bounces,
    int rr_start, int flags, float inv_spp, int s0, int chunk,
    void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || n_rows < 0 ||
      spp < 1 || max_bounces < 0 || max_bounces > kMaxBounces ||
      rr_start < 0 || s0 < 0 || chunk < 1 || s0 + chunk > spp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  const int grid = (n + kStreamThreads - 1) / kStreamThreads;
  bigscene_quality_backward<<<grid, kStreamThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, lcdf, gbar, first_dist, first_idx, grays,
      ev_idx, ev_val, n, a, s0, chunk);
  return static_cast<int>(cudaGetLastError());
}
