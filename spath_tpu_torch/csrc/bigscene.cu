// Whole-frame conformance path tracer for large scenes in one launch (K6).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene.py::_bigscene_kernel (walk
// _bigscene_walk, sweep _sweep, launched there by bigscene_call). It
// computes K1's function (megakernel.cu) for 1 <= T <= 2^20 triangles
// through the streamed sweep of stream_sweep.cuh, which stages the
// table's v0/e1/e2 columns in 256-row blocks through shared memory for
// the CTA's 128 lanes instead of reading the whole table through the
// cache per thread. Every bounce is K1's (megakernel_common.cuh:
// walk_step), with the same arithmetic (-fmad=false, no fast math), so
// the result equals K1's to the bit at T <= 1024 and the plain version's
// (megakernel_plain) at every T.
//
// Bound: compute. Every sweep runs ~46 float operations for each of T
// triangles against the 36 bytes of a staged row that the CTA's 128
// lanes share. The sweep synchronises the CTA, so a lane without a live
// ray idles through it: with one pixel a lane in lockstep (the first
// port), 74% of the lanes idled through the sweeps of a 10k-triangle
// 1080p64 frame (camera misses, paths that ended early, samples done).
// The design keeps the lanes on live rays instead:
//
//   - a queue of pixels: a persistent grid (the card's resident CTAs,
//     ops/kernels/bigscene.py::queue_plan) takes pixels from one int32
//     counter in device memory (zeroed by the wrapper), a warp at a time
//     with one atomic; a lane whose pixel is done, or whose camera ray
//     missed, takes the next unstarted pixel;
//   - regeneration: when a path ends (a miss, or its last bounce) the lane
//     starts its pixel's next sample at once; a sample's first bounce
//     reuses the camera hit and needs no sweep.
//
// So each CTA-wide sweep carries, lane by lane, a new pixel's camera ray
// (src -1) or a live path's next ray, and only the queue's tail idles
// (counted on that frame: 6% of the lanes, 8% at 8 spp).
// A pixel's result is the same function of its own ray and seed as
// before: the camera sweep first, then its spp samples in order, each
// continuing the pixel's one LCG state, the radiance summed in sample
// order and multiplied by 1/spp. Which lane runs which pixel, and when,
// varies from launch to launch; no sum spans pixels, so the bits do not.
//
// Not ported from the TPU kernel: the Plucker features in bf16 split
// terms (its way to run the tests on the MXU; Hopper's float32 tensor
// core path is TF32, not exact) and the one-hot attribute gather (an
// indexed load here).
//
// Layouts (checked by the Python wrapper ops/kernels/bigscene.py), all
// row-major and contiguous, as K1's:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): v0, e1, e2, normal, albedo,
//                        emission
//   out                  float32 (n, 3): mean radiance r, g, b
//   next_pixel           int32 (1): the queue's counter, 0 at launch
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;

constexpr unsigned kFull = 0xffffffffu;

// What a lane's next sweep carries.
enum Mode : int { kIdle = 0, kCamera = 1, kBounce = 2 };

__global__ void __launch_bounds__(kStreamThreads)
    bigscene_forward(const float* __restrict__ origins,
                     const float* __restrict__ directions,
                     const int64_t* __restrict__ seeds,
                     const float* __restrict__ tri, float* __restrict__ out,
                     int* __restrict__ next_pixel, int n, int n_tris,
                     int spp, int max_bounces) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const spath::StreamSweep sweep{tri, n_tris, tiles};
  const int lane = threadIdx.x & 31;
  const float inv = 1.0f / static_cast<float>(spp);
  spath::NoRecord rec;

  int mode = kIdle;
  bool drained = false;  // the queue is empty for this lane
  int pix = 0;
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;  // the pixel's camera ray
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  uint32_t seed = 0u;
  Hit first{spath::kBig, -1};
  spath::Path p;
  p.start(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  int sample = 0, bounce = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (;;) {
    // Lanes without work take the next pixels, one atomic a warp.
    const bool wants = mode == kIdle && !drained;
    const unsigned takers = __ballot_sync(kFull, wants);
    if (takers != 0u) {
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
          seed = static_cast<uint32_t>(seeds[k]);
          mode = kCamera;
        } else {
          drained = true;
        }
      }
    }
    // Every lane idle means the queue is empty and every pixel done.
    if (!__syncthreads_or(mode != kIdle)) break;

    const bool camera = mode == kCamera;
    const Hit h = sweep(mode != kIdle, camera ? ox0 : p.ox,
                        camera ? oy0 : p.oy, camera ? oz0 : p.oz,
                        camera ? dx0 : p.dx, camera ? dy0 : p.dy,
                        camera ? dz0 : p.dz, camera ? -1 : p.src);
    if (mode == kIdle) continue;

    bool ended = false;  // the sample's path is over
    if (camera) {
      // Camera rays are the same for every sample: swept once a pixel.
      first = h;
      acc_r = 0.0f;
      acc_g = 0.0f;
      acc_b = 0.0f;
      if (max_bounces == 0 || first.idx < 0) {
        // Every sample's radiance is 0 and the seed never moves.
        out[3 * pix + 0] = acc_r * inv;
        out[3 * pix + 1] = acc_g * inv;
        out[3 * pix + 2] = acc_b * inv;
        mode = kIdle;
        continue;
      }
      sample = 0;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      spath::walk_step(tri, first, 0, seed, p, rec);
      bounce = 1;
    } else if (h.idx < 0) {
      ended = true;
    } else {
      spath::walk_step(tri, h, bounce, seed, p, rec);
      ++bounce;
    }
    // Regeneration: a sample whose path is over adds its radiance, and
    // the pixel's next sample starts at once from the camera hit.
    while (ended || bounce == max_bounces) {
      acc_r = acc_r + p.rad_r;
      acc_g = acc_g + p.rad_g;
      acc_b = acc_b + p.rad_b;
      if (++sample == spp) break;
      p.start(ox0, oy0, oz0, dx0, dy0, dz0);
      spath::walk_step(tri, first, 0, seed, p, rec);
      bounce = 1;
      ended = false;
    }
    if (sample == spp) {
      out[3 * pix + 0] = acc_r * inv;
      out[3 * pix + 1] = acc_g * inv;
      out[3 * pix + 2] = acc_b * inv;
      mode = kIdle;
    } else {
      mode = kBounce;
    }
  }
}

}  // namespace

// CTAs of K6 resident on one SM (the persistent grid is this times the
// SMs), or a negative cudaError_t.
extern "C" int spath_bigscene_forward_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bigscene_forward, kStreamThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

extern "C" int spath_bigscene_forward(const float* origins,
                                      const float* directions,
                                      const int64_t* seeds, const float* tri,
                                      float* out, int* next_pixel, int n,
                                      int n_tris, int spp, int max_bounces,
                                      int grid, void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || spp < 1 ||
      max_bounces < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bigscene_forward<<<grid, kStreamThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, out, next_pixel, n, n_tris, spp,
      max_bounces);
  return static_cast<int>(cudaGetLastError());
}
