// Whole-frame conformance path tracer in one launch (K1).
//
// Replaces the TPU kernel spath_tpu/ops/pallas/megakernel.py::_megakernel
// (launched there by mega_call). It computes the same function, not the
// same blocks: the TPU kernel puts 1024 rays on vector lanes and walks an
// SMEM triangle table with scalar reads; here one thread owns one ray.
//
//   - the camera ray's nearest hit is computed once, before the sample loop;
//   - each of spp samples walks up to max_bounces segments: Moller-Trumbore
//     against every triangle of the (T, 18) table with the epsilon bounds,
//     the source-triangle exclusion and a strict `<` so the lowest index
//     wins ties; the hit triangle's normal (flipped against the ray),
//     albedo and emission are read by index; two LCG draws advance the
//     pixel's uint32 seed only on a hit; the angle-uniform sampler picks
//     the next direction; the forward throughput is accumulated;
//   - a ray that misses stops its sample: every later term of the masked
//     TPU walk is zero and its seed does not move, so this is exact.
//
// Bound: compute, not memory. The headline frame (1920x1080, 64 spp, 5
// bounces, 7 triangles) is ~640M path segments, each tested against all T
// triangles at ~46 float operations a test, against 32 bytes read and 12
// written per pixel. So the design keeps everything in registers: rays,
// seeds and output are read and written once, by neighbouring threads at
// neighbouring addresses, and the table is read through the read-only
// cache, where all threads of a warp load the same address at the same
// time (a broadcast). Staging the table in shared memory, fast trig and
// FMA contraction are later measured choices.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// multiply and add rounds on its own as in the plain PyTorch version
// (megakernel_plain), division is IEEE, and cosf/sinf are the accurate
// library forms. A 1-ulp difference in any of these flips chaotic paths.
// The walk (sample_walk through TableSweep, a bounce a walk_step) lives
// in megakernel_common.cuh, from which the backward kernel K2
// (megakernel_grad.cu) and the streamed kernels K6 and K8 replay it.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel.py), all
// row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): v0, e1, e2, normal, albedo,
//                        emission
//   out                  float32 (n, 3): mean radiance r, g, b
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include "megakernel_common.cuh"

namespace {

using spath::Hit;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    megakernel_forward(const float* __restrict__ origins,
                       const float* __restrict__ directions,
                       const int64_t* __restrict__ seeds,
                       const float* __restrict__ tri, float* __restrict__ out,
                       int n, int n_tris, int spp, int max_bounces) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float* o = origins + 3 * i;
  const float* d = directions + 3 * i;
  const float ox0 = o[0], oy0 = o[1], oz0 = o[2];
  const float dx0 = d[0], dy0 = d[1], dz0 = d[2];
  uint32_t seed = static_cast<uint32_t>(seeds[i]);

  const spath::TableSweep sweep{tri, n_tris};
  // Camera rays are the same for every sample.
  const Hit first = sweep(true, ox0, oy0, oz0, dx0, dy0, dz0, -1);
  spath::NoRecord rec;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    float rad_r, rad_g, rad_b;
    spath::sample_walk(tri, sweep, true, ox0, oy0, oz0, dx0, dy0, dz0, first,
                       max_bounces, seed, rad_r, rad_g, rad_b, rec);
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  const float inv = 1.0f / static_cast<float>(spp);
  out[3 * i + 0] = acc_r * inv;
  out[3 * i + 1] = acc_g * inv;
  out[3 * i + 2] = acc_b * inv;
}

}  // namespace

extern "C" int spath_megakernel_forward(const float* origins,
                                        const float* directions,
                                        const int64_t* seeds,
                                        const float* tri, float* out, int n,
                                        int n_tris, int spp, int max_bounces,
                                        void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  megakernel_forward<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, out, n, n_tris, spp, max_bounces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spath_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
