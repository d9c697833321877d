// Whole-frame quality path tracer in one launch (K3).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_quality.py::_quality_kernel (launched
// there by megakernel_quality_grad.py::quality_call). It computes the same
// function, not the same blocks: the TPU kernel puts 1024 rays on vector
// lanes and walks an SMEM triangle table with scalar reads; here a lane
// owns a pixel and walks it through quality_lanes.cuh: one bounce of
// quality_walk.cuh (hash draws, cosine sampler, NEE with MIS, Russian
// roulette, stratification) a step through its table backend,
// TableQuality, the camera ray's hit swept once a pixel, the pixel's next
// sample started as soon as a path ends and the next pixel taken when its
// samples are done. A warp's steps so follow its lanes' total work, not
// the longest path of each sample (counted: the lockstep loop left 57.6%
// of the lanes idle at the quality headline, PERF.md). The lanes take
// their pixels from a queue (one counter, one atomic a warp) on a
// persistent grid of K3's resident CTAs (fixed runs of pixels a warp
// measured slower on an H100, PERF.md). A pixel's samples are summed in sample order in one lane, so
// the frame is the same bits whichever lane runs which pixel. The TPU
// kernel's dead-tile skip and live-first ray order are not carried over:
// a lane whose camera ray misses takes its next pixel at once.
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
//   next_pixel           int32 (1,), zero: the queue's counter
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include "quality_lanes.cuh"
#include "quality_walk.cuh"

namespace {

using spath::LaneWalk;
using spath::PixelSource;
using spath::QualityArgs;

constexpr int kBlock = 128;

// K3's lane hooks: the sum of the pixel's samples, then its mean.
struct MeanLane {
  float* __restrict__ out;
  float acc_r, acc_g, acc_b;

  __device__ __forceinline__ void take(const QualityArgs&, const LaneWalk&) {
    acc_r = acc_g = acc_b = 0.0f;
  }
  __device__ __forceinline__ void end(const QualityArgs& a, int occ,
                                      LaneWalk& w) {
    spath::bounce_end(a, w.b, occ, w.p, w.x, spath::NoSave{});
  }
  __device__ __forceinline__ void sample(const QualityArgs&,
                                         const LaneWalk& w) {
    acc_r = acc_r + w.p.rad_r;
    acc_g = acc_g + w.p.rad_g;
    acc_b = acc_b + w.p.rad_b;
  }
  __device__ __forceinline__ bool pause(const QualityArgs&) const {
    return false;
  }
  __device__ __forceinline__ void pixel(const QualityArgs& a,
                                        const LaneWalk& w) {
    const float inv = 1.0f / static_cast<float>(a.spp);
    out[3 * w.pix + 0] = acc_r * inv;
    out[3 * w.pix + 1] = acc_g * inv;
    out[3 * w.pix + 2] = acc_b * inv;
  }
};

// At most 72 registers a thread: the lane loop's state would otherwise
// cost K3 its seventh resident CTA an SM (PERF.md).
__global__ void __launch_bounds__(kBlock, 7)
    quality_forward(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const int64_t* __restrict__ keys, float* __restrict__ out,
                    int* __restrict__ next_pixel, int n, QualityArgs a) {
  PixelSource src{next_pixel, n};
  LaneWalk w;
  w.init();
  MeanLane ln{out, 0.0f, 0.0f, 0.0f};
  const spath::TableQuality be = spath::table_quality(a);
  while (w.step(a, be, src, origins, directions, keys, ln)) {
  }
}

}  // namespace

// K3's resident CTAs an SM (its grid is sized from them), or minus a
// cudaError_t.
extern "C" int spath_quality_forward_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quality_forward, kBlock, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// flags: as spath::make_args takes them. next_pixel: the queue's zeroed
// counter; grid: CTAs of kBlock threads.
extern "C" int spath_quality_forward(const float* origins,
                                     const float* directions,
                                     const int64_t* keys, const float* tri,
                                     const int* rows, float* out,
                                     int* next_pixel, int n, int n_tris,
                                     int n_rows, int spp, int max_bounces,
                                     int rr_start, int flags, float inv_spp,
                                     int grid, void* stream) {
  if (n < 1 || n_tris < 1 || n_rows < 0 || spp < 1 || max_bounces < 0 ||
      rr_start < 0 || next_pixel == nullptr || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  quality_forward<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, out, next_pixel, n, a);
  return static_cast<int>(cudaGetLastError());
}
