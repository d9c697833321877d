// Whole-frame conformance path tracer for large scenes in one launch (K6).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_bigscene.py::_bigscene_kernel (walk
// _bigscene_walk, sweep _sweep, launched there by bigscene_call). It
// computes K1's function (megakernel.cu) for 1 <= T <= 2^20 triangles:
// one thread owns one ray, and the walk is K1's (megakernel_common.cuh:
// sample_walk), through the streamed sweep of stream_sweep.cuh, which stages the table's v0/e1/e2 columns in
// 256-row blocks through shared memory instead of reading the whole table
// through the cache per thread. With the same arithmetic (megakernel_common.cuh,
// -fmad=false, no fast math) the result equals K1's to the bit at
// T <= 1024 and the plain version's (megakernel_plain) at every T.
//
// Not ported from the TPU kernel: the Plucker features in bf16 split
// terms (its way to run the tests on the MXU; Hopper's float32 tensor
// core path is TF32, not exact) and the one-hot attribute gather (an
// indexed load here).
//
// Bound: compute. Every sweep runs ~46 float operations for each of T
// triangles, a few thousand times the 36 bytes of a staged row that the
// CTA's 128 rays share, so the staging traffic (from L2 for T up to
// ~10^6) is small beside the tests. The cost the design accepts: a ray
// whose path ended idles through its CTA's remaining sweeps, and each
// 256-row block costs two CTA barriers.
//
// Layouts (checked by the Python wrapper ops/kernels/bigscene.py), all
// row-major and contiguous, as K1's:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): v0, e1, e2, normal, albedo,
//                        emission
//   out                  float32 (n, 3): mean radiance r, g, b
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;

__global__ void __launch_bounds__(kStreamThreads)
    bigscene_forward(const float* __restrict__ origins,
                     const float* __restrict__ directions,
                     const int64_t* __restrict__ seeds,
                     const float* __restrict__ tri, float* __restrict__ out,
                     int n, int n_tris, int spp, int max_bounces) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const int i = blockIdx.x * kStreamThreads + threadIdx.x;
  // No early return: every thread takes part in the CTA's sweeps.
  const bool live = i < n;
  float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
  float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
  uint32_t seed = 0u;
  if (live) {
    ox0 = origins[3 * i + 0];
    oy0 = origins[3 * i + 1];
    oz0 = origins[3 * i + 2];
    dx0 = directions[3 * i + 0];
    dy0 = directions[3 * i + 1];
    dz0 = directions[3 * i + 2];
    seed = static_cast<uint32_t>(seeds[i]);
  }

  // Camera rays are the same for every sample.
  const spath::StreamSweep sweep{tri, n_tris, tiles};
  const Hit first = sweep(live, ox0, oy0, oz0, dx0, dy0, dz0, -1);
  spath::NoRecord rec;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    float rad_r, rad_g, rad_b;
    spath::sample_walk(tri, sweep, live, ox0, oy0, oz0, dx0, dy0, dz0, first,
                       max_bounces, seed, rad_r, rad_g, rad_b, rec);
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  if (live) {
    const float inv = 1.0f / static_cast<float>(spp);
    out[3 * i + 0] = acc_r * inv;
    out[3 * i + 1] = acc_g * inv;
    out[3 * i + 2] = acc_b * inv;
  }
}

}  // namespace

extern "C" int spath_bigscene_forward(const float* origins,
                                      const float* directions,
                                      const int64_t* seeds, const float* tri,
                                      float* out, int n, int n_tris, int spp,
                                      int max_bounces, void* stream) {
  if (n < 1 || n_tris < 1 || n_tris > spath::kBigMaxTris || spp < 1 ||
      max_bounces < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n + kStreamThreads - 1) / kStreamThreads;
  bigscene_forward<<<grid, kStreamThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, out, n, n_tris, spp, max_bounces);
  return static_cast<int>(cudaGetLastError());
}
