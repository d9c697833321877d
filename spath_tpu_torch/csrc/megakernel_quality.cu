// Whole-frame quality path tracer in one launch (K3).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_quality.py::_quality_kernel (launched
// there by megakernel_quality_grad.py::quality_call). It computes the same
// function, not the same blocks: the TPU kernel puts 1024 rays on vector
// lanes and walks an SMEM triangle table with scalar reads; here one
// thread owns one ray. The camera ray's nearest hit is computed once,
// before the sample loop; each sample then runs the quality walk of
// quality_walk.cuh (hash draws, cosine sampler, NEE with MIS, Russian
// roulette, stratification) through its table backend, TableQuality. The TPU kernel's dead-tile skip and
// live-first ray order are not carried over: a thread whose camera ray
// misses leaves its sample at once.
//
// Bound: compute, not memory. Each bounce sweeps every triangle once for
// the nearest hit and once more for the shadow ray (the two share the
// origin terms, nearest2), searches the cdf at the emissive rows for the
// light choice (O(log L) loads), and shades; rays, keys and the output are read and written once, by
// neighbouring threads at neighbouring addresses, and the table is read
// through the read-only cache, every thread of a warp loading the same
// address. Staging the table in shared memory, fast math and FMA
// contraction are later measured choices.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// multiply and add rounds on its own as in the plain PyTorch version
// (ops/kernels/megakernel_quality.py::quality_plain), division and sqrtf
// are IEEE, and cosf/sinf are the accurate library forms.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel_quality.py),
// all row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   keys                 int64 (n): the ray's uint32 stream key
//                        seed * 0x9E3779B9 + pixel
//   tri                  float32 (T, 21): v0, e1, e2, normal, albedo,
//                        emission, prob, area, cdf
//   rows                 int32 (L): the ascending rows the light choice
//                        searches (the emissive ones, or all T)
//   out                  float32 (n, 3): mean radiance r, g, b
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include "quality_walk.cuh"

namespace {

using spath::Hit;
using spath::QualityArgs;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    quality_forward(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const int64_t* __restrict__ keys, float* __restrict__ out,
                    int n, QualityArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float ox = origins[3 * i + 0], oy = origins[3 * i + 1],
              oz = origins[3 * i + 2];
  const float dx = directions[3 * i + 0], dy = directions[3 * i + 1],
              dz = directions[3 * i + 2];
  const uint32_t h1 = spath::fmix(static_cast<uint32_t>(keys[i]));

  // Camera rays are the same for every sample.
  const Hit first = spath::nearest<spath::kQCols>(a.tri, a.n_tris, ox, oy,
                                                  oz, dx, dy, dz, -1);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < a.spp; ++s) {
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    spath::quality_sample(a, spath::table_quality(a), ox, oy, oz, dx, dy,
                          dz, first, h1, s, rad_r, rad_g, rad_b,
                          spath::NoSave{});
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  const float inv = 1.0f / static_cast<float>(a.spp);
  out[3 * i + 0] = acc_r * inv;
  out[3 * i + 1] = acc_g * inv;
  out[3 * i + 2] = acc_b * inv;
}

}  // namespace

// flags: as spath::make_args takes them.
extern "C" int spath_quality_forward(const float* origins,
                                     const float* directions,
                                     const int64_t* keys, const float* tri,
                                     const int* rows, float* out, int n,
                                     int n_tris, int n_rows, int spp,
                                     int max_bounces, int rr_start, int flags,
                                     float inv_spp, void* stream) {
  if (n < 1 || n_tris < 1 || n_rows < 0 || spp < 1 || max_bounces < 0 ||
      rr_start < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  const int grid = (n + kBlock - 1) / kBlock;
  quality_forward<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, out, n, a);
  return static_cast<int>(cudaGetLastError());
}
