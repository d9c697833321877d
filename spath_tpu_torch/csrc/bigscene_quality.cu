// Whole-frame quality path tracer for large scenes in one launch (K9), and
// the same launch with its hit export (K11).
//
// Replaces the TPU kernels
// spath_tpu/ops/pallas/megakernel_bigscene_quality.py::_bigq_kernel
// (hook set _make_ctx_big, launched there by bigq_call) and, with the
// export, ::_bigq_hits_kernel (launched by bigq_hits_call). K9 computes K3's
// function (megakernel_quality.cu: hash draws, cosine sampler, NEE with
// MIS, Russian roulette, stratification) for 1 <= T <= 2^20 triangles:
// every bounce is K3's (quality_walk.cuh: bounce_begin, the bounce's
// sweep, bounce_end) through the streamed backend StreamQuality: the
// table's v0/e1/e2 columns staged through shared memory in 256-row blocks
// (stream_sweep.cuh), the shadow ray and the next bounce's ray tested
// against each staged block together from their shared origin, and the
// light chosen by a binary search of the cdf at the light rows. With the
// same arithmetic (-fmad=false, no fast math) the result equals K3's to
// the bit at T <= 1024 and the plain version's (quality_plain) at every T.
//
// Not ported from the TPU kernel, with their contracts kept: the Plucker
// features in bf16 split terms and the one-hot attribute gather (exact
// fp32 Moller-Trumbore and an indexed load here), and the sublane-chunked
// light table with its one-hot MXU row fetch (_select_light_vmem; an
// indexed load of the chosen row here). Where u lies at or above the cdf
// at every light, the light is the last row, T - 1, as in the wavefront
// and K3; the JAX kernel clips to the last light there.
//
// Bound: compute. A bounce sweeps every triangle for two rays (the shared
// origin terms computed once), ~75 float operations a staged row; the
// light choice is ~log2(L) loads. The sweep synchronises the CTA, so a
// lane without a live ray idles through it: with one ray a lane in
// lockstep (the first port), 79% of the lanes idled through the sweeps
// of a 10k-triangle 1080p 16-spp frame (camera misses, paths that ended
// early, samples done). The design keeps the lanes on live rays instead,
// as K6's (bigscene.cu), in the loop K9, K11 and K10 share
// (quality_queue.cuh):
//
//   - a queue of pixels: a persistent grid (the card's resident CTAs of
//     this kernel, ops/kernels/bigscene.py::queue_plan) takes pixels from
//     one int32 counter in device memory (zeroed by the wrapper), a warp at
//     a time with one atomic; a lane whose pixel is done, or whose camera
//     ray missed, takes the next unstarted pixel;
//   - regeneration: when a sample's path ends (a miss, the roulette, or its
//     last bounce) the lane adds its radiance and starts the pixel's next
//     sample at once from the camera hit, which needs no sweep.
//
// So one CTA-wide sweep carries, lane by lane, one of three loads: a new
// pixel's camera ray; a bounce's shadow ray and next ray (two rays from the
// hit point); or one ray, a last (or roulette-ending) bounce's shadow ray, or
// without NEE the next ray (StreamQuality::mixed: the two-ray sweep for every
// lane if any lane of the CTA carries two). A pixel's result is the same
// function of its ray and key as before: the hash stream is stateless
// (draw(h1, s * C1, b, k)), so a lane's state is its pixel, sample and bounce;
// the samples' radiances are summed in sample order and multiplied by 1/spp.
// Which lane runs which pixel, and when, varies from launch to launch; no sum
// spans pixels, so the bits do not.
//
// K11 is K9 with an export flag, not a second walk: the kernel is a
// template over it. K11 writes each (sample, bounce) nearest hit the walk
// took (quality_walk.cuh: HitSaver) at its fixed slot
// (s * max_bounces + b) * n + pixel, from whichever lane runs the pixel,
// and a miss (1e12, -1) from the path's length on. The radiance is K9's to
// the bit. The export adds 8 bytes a (sample, bounce, ray) of writes, no
// longer coalesced across a warp; the JAX package unrolls its sample loop
// for it and gates it at spp <= 8, and the wrapper keeps that gate (the
// buffers take 663 MB at 1920x1080, 5 bounces and 8 spp).
//
// Layouts (checked by the Python wrapper ops/kernels/bigscene_quality.py),
// all row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   keys                 int64 (n): the ray's uint32 stream key
//   tri                  float32 (T, 21): the quality table, as K3's
//   rows                 int32 (L): the light rows, ascending
//   lcdf                 float32 (L): the table's cdf at those rows
//   out                  float32 (n, 3): mean radiance r, g, b
//   hit_dist, hit_idx    float32, int32 (spp, max_bounces, n): K11's
//                        export, null for K9
//   next_pixel           int32 (1): the queue's counter, 0 at launch
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_queue.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;
using spath::QualityArgs;

// K9's and K11's hooks of the queue (quality_queue.cuh): the samples'
// radiance summed in sample order, K11's export of each bounce's hit.
template <bool kExport>
struct ForwardLane {
  float* __restrict__ out;
  float* __restrict__ hit_dist;
  int* __restrict__ hit_idx;
  int n;
  float acc_r, acc_g, acc_b;

  __device__ __forceinline__ void take(const QualityArgs&, int) {
    acc_r = 0.0f;
    acc_g = 0.0f;
    acc_b = 0.0f;
  }
  // Never called: K9 sweeps every camera ray.
  __device__ __forceinline__ Hit first(int) const {
    return Hit{spath::kBig, -1};
  }
  __device__ __forceinline__ void camera(int, const Hit&) const {}
  __device__ __forceinline__ void end(const QualityArgs& a, int b, int occ,
                                      int s, int pix, spath::QualityPath& p,
                                      spath::QualityStep& x) const {
    if constexpr (kExport) {
      const size_t at = static_cast<size_t>(s) * a.max_bounces * n + pix;
      spath::bounce_end(a, b, occ, p, x,
                        spath::HitSaver{hit_dist + at, hit_idx + at,
                                        static_cast<size_t>(n)});
    } else {
      spath::bounce_end(a, b, occ, p, x, spath::NoSave{});
    }
  }
  // The sample's radiance; K11 exports its bounces from `len` on as
  // misses.
  __device__ __forceinline__ void sample(const QualityArgs& a, int pix,
                                         int s, int len, uint32_t,
                                         const spath::QualityPath& p) {
    if constexpr (kExport) {
      const int nb = a.max_bounces;
      const size_t at = static_cast<size_t>(s) * nb * n + pix;
      for (int b = len; b < nb; ++b) {
        hit_dist[at + static_cast<size_t>(b) * n] = spath::kBig;
        hit_idx[at + static_cast<size_t>(b) * n] = -1;
      }
    }
    acc_r = acc_r + p.rad_r;
    acc_g = acc_g + p.rad_g;
    acc_b = acc_b + p.rad_b;
  }
  __device__ __forceinline__ void pixel(const QualityArgs& a, int pix) {
    const float inv = 1.0f / static_cast<float>(a.spp);
    out[3 * pix + 0] = acc_r * inv;
    out[3 * pix + 1] = acc_g * inv;
    out[3 * pix + 2] = acc_b * inv;
  }
};

template <bool kExport>
__global__ void __launch_bounds__(kStreamThreads)
    bigscene_quality_forward(const float* __restrict__ origins,
                             const float* __restrict__ directions,
                             const int64_t* __restrict__ keys,
                             const float* __restrict__ lcdf,
                             float* __restrict__ out,
                             float* __restrict__ hit_dist,
                             int* __restrict__ hit_idx,
                             int* __restrict__ next_pixel, int n,
                             QualityArgs a) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const spath::StreamQuality be{a.tri, a.n_tris, tiles, a.rows, lcdf,
                                a.n_rows};
  ForwardLane<kExport> ln{out, hit_dist, hit_idx, n, 0.0f, 0.0f, 0.0f};
  spath::quality_queue(a, be, origins, directions, keys, next_pixel, n, 0,
                       a.spp, false, ln);
}

template <bool kExport>
int occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bigscene_quality_forward<kExport>, kStreamThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

int launch(const float* origins, const float* directions, const int64_t* keys,
           const float* tri, const int* rows, const float* lcdf, float* out,
           float* hit_dist, int* hit_idx, int* next_pixel, int n, int n_tris,
           int n_rows, int spp, int max_bounces, int rr_start, int flags,
           float inv_spp, int grid, void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || n_rows < 0 ||
      spp < 1 || max_bounces < 0 || rr_start < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  auto* kernel = hit_dist != nullptr ? &bigscene_quality_forward<true>
                                     : &bigscene_quality_forward<false>;
  kernel<<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, lcdf, out, hit_dist, hit_idx, next_pixel, n,
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// CTAs of K9 (export == 0) or K11 (export != 0) resident on one SM (the
// persistent grid is this times the SMs), or a negative cudaError_t.
extern "C" int spath_bigscene_quality_forward_occupancy(int export_hits) {
  return export_hits != 0 ? occupancy<true>() : occupancy<false>();
}

// K9. flags: as spath::make_args takes them.
extern "C" int spath_bigscene_quality_forward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, float* out,
    int* next_pixel, int n, int n_tris, int n_rows, int spp, int max_bounces,
    int rr_start, int flags, float inv_spp, int grid, void* stream) {
  return launch(origins, directions, keys, tri, rows, lcdf, out, nullptr,
                nullptr, next_pixel, n, n_tris, n_rows, spp, max_bounces,
                rr_start, flags, inv_spp, grid, stream);
}

// K11: K9 with the hit export into hit_dist and hit_idx.
extern "C" int spath_bigscene_quality_forward_hits(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, float* out,
    float* hit_dist, int* hit_idx, int* next_pixel, int n, int n_tris,
    int n_rows, int spp, int max_bounces, int rr_start, int flags,
    float inv_spp, int grid, void* stream) {
  if (hit_dist == nullptr || hit_idx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(origins, directions, keys, tri, rows, lcdf, out, hit_dist,
                hit_idx, next_pixel, n, n_tris, n_rows, spp, max_bounces,
                rr_start, flags, inv_spp, grid, stream);
}
