// Whole-frame quality path tracer for large scenes in one launch (K9), and
// the same launch with its hit export (K11).
//
// Replaces the TPU kernels
// spath_tpu/ops/pallas/megakernel_bigscene_quality.py::_bigq_kernel
// (hook set _make_ctx_big, launched there by bigq_call) and, with the
// export, ::_bigq_hits_kernel (launched by bigq_hits_call). K9 computes K3's
// function (megakernel_quality.cu: hash draws, cosine sampler, NEE with
// MIS, Russian roulette, stratification) for 1 <= T <= 2^20 triangles:
// one thread owns one ray, and the walk is K3's (quality_walk.cuh:
// quality_sample) through its streamed backend, StreamQuality: the table's
// v0/e1/e2 columns staged through shared memory in 256-row blocks
// (stream_sweep.cuh), the shadow ray and the next bounce's ray tested
// against each staged block together from their shared origin
// (stream_nearest2: each block staged once a bounce), and the light chosen
// by a binary search of the cdf at the light rows. With the same
// arithmetic (-fmad=false, no fast math) the result equals K3's to the
// bit at T <= 1024 and the plain version's (quality_plain) at every T.
//
// Not ported from the TPU kernel, with their contracts kept: the Plucker
// features in bf16 split terms and the one-hot attribute gather (exact
// fp32 Moller-Trumbore and an indexed load here), and the sublane-chunked
// light table with its one-hot MXU row fetch (_select_light_vmem; an
// indexed load of the chosen row here). Where u lies at or above the cdf
// at every light, the light is the last row, T - 1, as in the wavefront
// and K3; the JAX kernel clips to the last light there.
//
// Bound: compute. Each bounce sweeps every triangle for two rays (the
// shared origin terms computed once), ~75 float operations a staged row;
// the light choice is ~log2(L) loads. The cost the design accepts: a ray
// whose path ended idles through its CTA's remaining sweeps, and each
// 256-row block costs two CTA barriers.
//
// K11 is K9 with an export flag, not a second walk: the kernel is a
// template over the walk's recorder, spath::NoSave for K9 (so K9's code
// and bits are its own) and spath::HitSaver for K11, which writes each
// (sample, bounce) nearest hit the walk took (quality_walk.cuh: HitSaver),
// a miss (1e12, -1) where the path had missed or ended. The radiance is
// K9's to the bit. The export adds 8 bytes a (sample, bounce, ray) of
// writes; the JAX package unrolls its sample loop for it and gates it at
// spp <= 8, and the wrapper keeps that gate (the buffers take 663 MB at
// 1920x1080, 5 bounces and 8 spp).
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
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_walk.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;
using spath::QualityArgs;

template <bool kExport>
__global__ void __launch_bounds__(kStreamThreads)
    bigscene_quality_forward(const float* __restrict__ origins,
                             const float* __restrict__ directions,
                             const int64_t* __restrict__ keys,
                             const float* __restrict__ lcdf,
                             float* __restrict__ out,
                             float* __restrict__ hit_dist,
                             int* __restrict__ hit_idx, int n,
                             QualityArgs a) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const int i = blockIdx.x * kStreamThreads + threadIdx.x;
  // No early return: every thread takes part in the CTA's sweeps.
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  uint32_t h1 = 0u;
  if (live) {
    ox = origins[3 * i + 0];
    oy = origins[3 * i + 1];
    oz = origins[3 * i + 2];
    dx = directions[3 * i + 0];
    dy = directions[3 * i + 1];
    dz = directions[3 * i + 2];
    h1 = spath::fmix(static_cast<uint32_t>(keys[i]));
  }
  const spath::StreamQuality be{a.tri, a.n_tris, tiles, a.rows, lcdf,
                                a.n_rows};
  // Camera rays are the same for every sample.
  const Hit first = be.one(live, ox, oy, oz, dx, dy, dz, -1);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < a.spp; ++s) {
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    if constexpr (kExport) {
      const size_t at = static_cast<size_t>(s) * a.max_bounces * n + i;
      const spath::HitSaver save{hit_dist + at, hit_idx + at,
                                 static_cast<size_t>(n)};
      const int len =
          spath::quality_sample(a, be, live, ox, oy, oz, dx, dy, dz, first,
                                h1, s, rad_r, rad_g, rad_b, save);
      if (live) {
        for (int b = len; b < a.max_bounces; ++b) {
          hit_dist[at + static_cast<size_t>(b) * n] = spath::kBig;
          hit_idx[at + static_cast<size_t>(b) * n] = -1;
        }
      }
    } else {
      spath::quality_sample(a, be, live, ox, oy, oz, dx, dy, dz, first, h1,
                            s, rad_r, rad_g, rad_b, spath::NoSave{});
    }
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  if (live) {
    const float inv = 1.0f / static_cast<float>(a.spp);
    out[3 * i + 0] = acc_r * inv;
    out[3 * i + 1] = acc_g * inv;
    out[3 * i + 2] = acc_b * inv;
  }
}

int launch(const float* origins, const float* directions, const int64_t* keys,
           const float* tri, const int* rows, const float* lcdf, float* out,
           float* hit_dist, int* hit_idx, int n, int n_tris, int n_rows,
           int spp, int max_bounces, int rr_start, int flags, float inv_spp,
           void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || n_rows < 0 ||
      spp < 1 || max_bounces < 0 || rr_start < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  const int grid = (n + kStreamThreads - 1) / kStreamThreads;
  auto* kernel = hit_dist != nullptr ? &bigscene_quality_forward<true>
                                     : &bigscene_quality_forward<false>;
  kernel<<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, lcdf, out, hit_dist, hit_idx, n, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9. flags: as spath::make_args takes them.
extern "C" int spath_bigscene_quality_forward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, float* out, int n,
    int n_tris, int n_rows, int spp, int max_bounces, int rr_start,
    int flags, float inv_spp, void* stream) {
  return launch(origins, directions, keys, tri, rows, lcdf, out, nullptr,
                nullptr, n, n_tris, n_rows, spp, max_bounces, rr_start, flags,
                inv_spp, stream);
}

// K11: K9 with the hit export into hit_dist and hit_idx.
extern "C" int spath_bigscene_quality_forward_hits(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* lcdf, float* out,
    float* hit_dist, int* hit_idx, int n, int n_tris, int n_rows, int spp,
    int max_bounces, int rr_start, int flags, float inv_spp, void* stream) {
  if (hit_dist == nullptr || hit_idx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(origins, directions, keys, tri, rows, lcdf, out, hit_dist,
                hit_idx, n, n_tris, n_rows, spp, max_bounces, rr_start, flags,
                inv_spp, stream);
}
