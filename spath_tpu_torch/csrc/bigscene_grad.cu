// Reverse sweep of the large-scene conformance path tracer (K8).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene_grad.py::_bigscene_bwd_kernel
// (launched there by bigscene_bwd_call). One thread owns one ray. For
// each sample it replays K6's walk from the shared header
// megakernel_common.cuh (sample_walk through stream_sweep.cuh's
// StreamSweep: the same hits, draws and directions bit for bit), saving
// per bounce the hit index, the flip sign fs, the sampled
// direction om, the weight w and the throughput tr before the bounce,
// then runs K2's reverse sweep (megakernel_grad.cu) from the last hit
// back to the camera, with g = gbar / spp and bb the adjoint of the
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
// Chunks: a frame's events can pass memory (at 1920x1080 one sample is
// 415 MB), so the wrapper launches the kernel once per chunk of samples,
// each launch followed by K7. The first launch (s0 == 0) sweeps the
// camera rays and keeps each ray's hit in first_dist/first_idx; every
// launch starts from the LCG state in `state` (from `seeds` when
// s0 == 0) and leaves it there, so the chunks replay one walk.
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
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kMaxBounces;
using spath::kStreamThreads;

constexpr int kAdj = 9;

__global__ void __launch_bounds__(kStreamThreads)
    bigscene_backward(const float* __restrict__ origins,
                      const float* __restrict__ directions,
                      const int64_t* __restrict__ seeds,
                      const float* __restrict__ tri,
                      const float* __restrict__ gbar,
                      float* __restrict__ first_dist,
                      int* __restrict__ first_idx, int* __restrict__ state,
                      int* __restrict__ ev_idx, float* __restrict__ ev_val,
                      int n, int n_tris, int spp, int max_bounces, int s0,
                      int chunk) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const int i = blockIdx.x * kStreamThreads + threadIdx.x;
  // No early return: every thread takes part in the CTA's sweeps.
  const bool live = i < n;
  const float inv = 1.0f / static_cast<float>(spp);
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
  uint32_t seed = 0u;
  if (live) {
    ox0 = origins[3 * i + 0];
    oy0 = origins[3 * i + 1];
    oz0 = origins[3 * i + 2];
    dx0 = directions[3 * i + 0];
    dy0 = directions[3 * i + 1];
    dz0 = directions[3 * i + 2];
    g_r = gbar[3 * i + 0] * inv;
    g_g = gbar[3 * i + 1] * inv;
    g_b = gbar[3 * i + 2] * inv;
    seed = s0 == 0 ? static_cast<uint32_t>(seeds[i])
                   : static_cast<uint32_t>(state[i]);
  }
  const spath::StreamSweep sweep{tri, n_tris, tiles};
  Hit first{spath::kBig, -1};
  if (s0 == 0) {
    // Camera rays are the same for every sample: swept once a frame.
    first = sweep(live, ox0, oy0, oz0, dx0, dy0, dz0, -1);
    if (live) {
      first_dist[i] = first.dist;
      first_idx[i] = first.idx;
    }
  } else if (live) {
    first = Hit{first_dist[i], first_idx[i]};
  }

  spath::Saved sv;
  for (int s = 0; s < chunk; ++s) {
    // ---- forward replay of K6's walk ----
    sv.len = 0;
    float rad_r, rad_g, rad_b;
    spath::sample_walk(tri, sweep, live, ox0, oy0, oz0, dx0, dy0, dz0, first,
                       max_bounces, seed, rad_r, rad_g, rad_b, sv);
    if (!live) continue;

    // ---- reverse sweep, one event a bounce ----
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
  if (live) state[i] = static_cast<int>(seed);
}

}  // namespace

extern "C" int spath_bigscene_backward(
    const float* origins, const float* directions, const int64_t* seeds,
    const float* tri, const float* gbar, float* first_dist, int* first_idx,
    int* state, int* ev_idx, float* ev_val, int n, int n_tris, int spp,
    int max_bounces, int s0, int chunk, void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || spp < 1 ||
      max_bounces < 0 || max_bounces > kMaxBounces || s0 < 0 || chunk < 1 ||
      s0 + chunk > spp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n + kStreamThreads - 1) / kStreamThreads;
  bigscene_backward<<<grid, kStreamThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, gbar, first_dist, first_idx, state,
      ev_idx, ev_val, n, n_tris, spp, max_bounces, s0, chunk);
  return static_cast<int>(cudaGetLastError());
}
