// Whole-frame conformance path tracer in one launch (K1).
//
// Replaces the TPU kernel spath_tpu/ops/pallas/megakernel.py::_megakernel
// (launched there by mega_call). It computes the same function, not the
// same blocks: the TPU kernel puts 1024 rays on vector lanes and walks an
// SMEM triangle table with scalar reads; here a lane owns a pixel and
// walks it through megakernel_lanes.cuh, one bounce a step:
//
//   - the camera ray's nearest hit is swept once a pixel;
//   - each of spp samples walks up to max_bounces segments: Moller-Trumbore
//     against every triangle of the (T, 18) table with the epsilon bounds,
//     the source-triangle exclusion and a strict `<` so the lowest index
//     wins ties; the hit triangle's normal (flipped against the ray),
//     albedo and emission are read by index; two LCG draws advance the
//     pixel's uint32 seed only on a hit; the angle-uniform sampler picks
//     the next direction; the forward throughput is accumulated
//     (walk_step, megakernel_common.cuh);
//   - a ray that misses ends its sample: every later term of the masked
//     TPU walk is zero and its seed does not move, so this is exact; the
//     lane starts the pixel's next sample at once, and takes the next
//     pixel when the samples are done (regeneration), so a warp's steps
//     follow its lanes' total work, not each sample's longest path
//     (counted: the lockstep loop this replaced left 50.7% of its lanes
//     idle at the conformance headline, PERF.md).
//
// The lanes take their pixels from a queue (one int32 counter, one atomic
// a warp, pixel_source.cuh) on a persistent grid of K1's resident CTAs
// (ops/kernels/megakernel.py). A pixel's samples are summed in sample
// order in one lane, so the frame is the same bits whichever lane runs
// which pixel: those of megakernel_plain and of the lockstep loop.
//
// Bound: compute, not memory. The headline frame (1920x1080, 64 spp, 5
// bounces, 7 triangles) is ~127M sweeps of all T triangles at ~46 float
// operations a test, against 32 bytes read and 12 written per pixel. So
// the design keeps everything in registers: rays, seeds and output are
// read and written once, and the table is read through the read-only
// cache, where all threads of a warp load the same address at the same
// time (a broadcast).
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// multiply and add rounds on its own as in the plain PyTorch version
// (megakernel_plain), division is IEEE, and sincosf is the accurate
// library form. A 1-ulp difference in any of these flips chaotic paths.
// The bounce (walk_step) lives in megakernel_common.cuh, from which the
// backward kernel K2 (megakernel_grad.cu, on this lane loop too) and the
// streamed kernels K6 and K8 replay it.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel.py), all
// row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): v0, e1, e2, normal, albedo,
//                        emission
//   out                  float32 (n, 3): mean radiance r, g, b
//   next_pixel           int32 (1,), zero: the queue's counter
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include "megakernel_common.cuh"
#include "megakernel_lanes.cuh"

namespace {

using spath::ConfLane;

constexpr int kBlock = 128;

// K1's lane hooks: the sum of the pixel's samples, then its mean.
struct MeanLane {
  float* __restrict__ out;
  float inv;  // 1 / spp
  float acc_r, acc_g, acc_b;

  __device__ __forceinline__ void take(const ConfLane&) {
    acc_r = acc_g = acc_b = 0.0f;
  }
  __device__ __forceinline__ void operator()(int, int, const spath::Surface&,
                                             float, float, float) {}
  __device__ __forceinline__ void sample(const ConfLane& w) {
    acc_r = acc_r + w.p.rad_r;
    acc_g = acc_g + w.p.rad_g;
    acc_b = acc_b + w.p.rad_b;
  }
  __device__ __forceinline__ bool pause(int) const { return false; }
  __device__ __forceinline__ void pixel(const ConfLane& w) {
    out[3 * w.pix + 0] = acc_r * inv;
    out[3 * w.pix + 1] = acc_g * inv;
    out[3 * w.pix + 2] = acc_b * inv;
  }
};

__global__ void __launch_bounds__(kBlock)
    megakernel_forward(const float* __restrict__ origins,
                       const float* __restrict__ directions,
                       const int64_t* __restrict__ seeds,
                       const float* __restrict__ tri, float* __restrict__ out,
                       int* __restrict__ next_pixel, int n, int n_tris,
                       int spp, int max_bounces) {
  spath::PixelSource src{next_pixel, n};
  ConfLane w;
  w.init();
  MeanLane ln{out, 1.0f / static_cast<float>(spp), 0.0f, 0.0f, 0.0f};
  const spath::ConfArgs a{tri, n_tris, spp, max_bounces};
  while (w.step(a, src, origins, directions, seeds, ln)) {
  }
}

}  // namespace

// K1's resident CTAs an SM (its grid is sized from them), or minus a
// cudaError_t.
extern "C" int spath_megakernel_forward_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, megakernel_forward, kBlock, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// next_pixel: the queue's zeroed counter; grid: CTAs of kBlock threads.
extern "C" int spath_megakernel_forward(const float* origins,
                                        const float* directions,
                                        const int64_t* seeds,
                                        const float* tri, float* out,
                                        int* next_pixel, int n, int n_tris,
                                        int spp, int max_bounces, int grid,
                                        void* stream) {
  if (n < 1 || n_tris < 1 || spp < 1 || max_bounces < 0 ||
      next_pixel == nullptr || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  megakernel_forward<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, out, next_pixel, n, n_tris, spp,
      max_bounces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spath_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
