// Reverse sweep of the whole-frame conformance path tracer (K2).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_grad.py::_mega_bwd_kernel (launched
// there by mega_bwd_call), with position_chain=False as that kernel runs
// it. It computes the same function, not the same blocks: one thread owns
// one ray, as in K1.
//
// For each sample a thread replays K1's walk through the shared header
// (the hoisted camera hit, the early exit when the path ends, two LCG
// draws only on a hit), saving per bounce only what the reverse sweep
// needs: the hit index, the flip sign fs, the sampled direction om, the
// weight w and the throughput tr before the bounce. Albedo and emission
// are read again from the table by index. The reverse sweep then runs
// from the last hit back to the camera, with g = gbar / spp and bb the
// adjoint of the throughput after the bounce (the JAX kernel's tb), in
// that kernel's order of operations:
//
//   abar = bb * tr * w                    albedo adjoint
//   wbar = sum_c bb_c * tr_c * albedo_c   weight adjoint
//   ebar = g * tr                         emission adjoint
//   nbar = 2 * wbar * fs * om             normal adjoint (the table's
//                                         unflipped normal)
//   bb   = g * emission + bb * albedo * w
//
// Hit positions never enter a continuous quantity of this estimator, so
// the vertex and edge columns (0-8) and the camera rays get no adjoint;
// the wrapper zero-pads columns 0-8.
//
// Accumulation is deterministic: no float atomics. Each warp owns a
// (T, 9) slice of shared memory. At every (sample, bounce) step the lanes
// that hit stage their triangle index and 9 adjoints in shared memory;
// then lanes 0-8, one per column, add the staged values into the slice in
// lane order. At the end the block sums its warps' slices in warp order
// into its row of `partial` (grid, T * 9), and the wrapper sums the rows
// (torch.sum, a fixed-order reduction). The grid has a fixed size for a
// given n (blocks walk the rays in a grid-stride loop), so two launches on
// the same inputs give the same bits.
//
// Bound: compute, as K1. The replay repeats K1's ~46 float operations per
// Moller-Trumbore test for every sweep; the reverse sweep adds ~40 per
// hit and the accumulation 9 shared-memory adds per hit, serialised over
// the warp's hitting lanes. Rays, seeds and gbar are read once; the
// output is grid * T * 9 floats. The per-bounce state sits in local
// memory (an array indexed by bounce), backed by the L1 cache.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel_grad.py),
// all row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): as K1's table
//   gbar                 float32 (n, 3): the cotangent of K1's output
//   partial              float32 (grid, T * 9): per-block adjoints of
//                        columns 9-17, grid = spath_megakernel_backward_grid(n)
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "megakernel_common.cuh"

namespace {

using spath::Hit;
using spath::kCols;
using spath::kMaxBounces;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// Adjoint columns per triangle: normal, albedo, emission (table cols 9-17).
constexpr int kAdj = 9;
// A staged contribution: the triangle index (as float bits), 9 adjoints.
constexpr int kStage = kAdj + 1;
// Most blocks a launch uses; larger frames loop (grid-stride).
constexpr int kMaxGrid = 2048;

__host__ __device__ int shared_bytes(int n_tris) {
  return static_cast<int>(sizeof(float)) * kWarps *
         (n_tris * kAdj + 32 * kStage);
}

__global__ void __launch_bounds__(kBlock)
    megakernel_backward(const float* __restrict__ origins,
                        const float* __restrict__ directions,
                        const int64_t* __restrict__ seeds,
                        const float* __restrict__ tri,
                        const float* __restrict__ gbar,
                        float* __restrict__ partial, int n, int n_tris,
                        int spp, int max_bounces) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = n_tris * kAdj;
  float* acc = smem + warp * slice;
  float* stage = smem + kWarps * slice + warp * 32 * kStage;
  for (int k = lane; k < slice; k += 32) acc[k] = 0.0f;
  __syncwarp();

  const float inv = 1.0f / static_cast<float>(spp);
  const spath::TableSweep sweep{tri, n_tris};
  spath::Saved sv;

  // Every lane of a warp runs the same chunks, samples and reverse steps,
  // so the warp-wide exchanges below see all 32 lanes.
  for (int base = blockIdx.x * kBlock; base < n; base += gridDim.x * kBlock) {
    const int i = base + threadIdx.x;
    const bool live = i < n;
    float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
    float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
    float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
    uint32_t seed = 0u;
    Hit first{spath::kBig, -1};
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
      seed = static_cast<uint32_t>(seeds[i]);
      // Camera rays are the same for every sample.
      first = sweep(true, ox0, oy0, oz0, dx0, dy0, dz0, -1);
    }

    for (int s = 0; s < spp; ++s) {
      // ---- forward replay of K1's walk ----
      sv.len = 0;
      float rad_r, rad_g, rad_b;
      spath::sample_walk(tri, sweep, live, ox0, oy0, oz0, dx0, dy0, dz0, first,
                         max_bounces, seed, rad_r, rad_g, rad_b, sv);
      const int len = sv.len;

      // ---- reverse sweep, the warp's longest path first ----
      const int depth = __reduce_max_sync(kFull, len);
      float bb_r = 0.0f, bb_g = 0.0f, bb_b = 0.0f;  // thr-bar after bounce b
      for (int b = depth - 1; b >= 0; --b) {
        const bool hit = b < len;
        if (hit) {
          const int idx = sv.idx[b];
          const float* r = tri + idx * kCols;
          const float ar = __ldg(r + 12), ag = __ldg(r + 13),
                      ab = __ldg(r + 14);
          const float er = __ldg(r + 15), eg = __ldg(r + 16),
                      eb = __ldg(r + 17);
          const float tr = sv.tr[b], tg = sv.tg[b], tb = sv.tb[b];
          const float w = sv.w[b], fs = sv.fs[b];
          float* e = stage + lane * kStage;
          e[0] = __int_as_float(idx);
          const float wbar = bb_r * tr * ar + bb_g * tg * ag + bb_b * tb * ab;
          e[1] = 2.0f * wbar * fs * sv.omx[b];
          e[2] = 2.0f * wbar * fs * sv.omy[b];
          e[3] = 2.0f * wbar * fs * sv.omz[b];
          e[4] = bb_r * tr * w;
          e[5] = bb_g * tg * w;
          e[6] = bb_b * tb * w;
          e[7] = g_r * tr;
          e[8] = g_g * tg;
          e[9] = g_b * tb;
          bb_r = g_r * er + bb_r * ar * w;
          bb_g = g_g * eg + bb_g * ag * w;
          bb_b = g_b * eb + bb_b * ab * w;
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        __syncwarp();
        if (lane < kAdj) {
          for (unsigned m = hits; m != 0u; m &= m - 1u) {
            const float* e = stage + (__ffs(m) - 1) * kStage;
            float* a = acc + __float_as_int(e[0]) * kAdj + lane;
            *a = *a + e[1 + lane];
          }
        }
        __syncwarp();
      }
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < slice; k += kBlock) {
    float sum = smem[k];
    for (int w = 1; w < kWarps; ++w) sum = sum + smem[w * slice + k];
    partial[blockIdx.x * slice + k] = sum;
  }
}

}  // namespace

extern "C" int spath_megakernel_backward_grid(int n) {
  const int blocks = (n + kBlock - 1) / kBlock;
  return blocks < kMaxGrid ? blocks : kMaxGrid;
}

extern "C" int spath_megakernel_backward(const float* origins,
                                         const float* directions,
                                         const int64_t* seeds,
                                         const float* tri, const float* gbar,
                                         float* partial, int n, int n_tris,
                                         int spp, int max_bounces,
                                         void* stream) {
  if (n < 1 || n_tris < 1 || spp < 1 || max_bounces < 0 ||
      max_bounces > kMaxBounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = shared_bytes(n_tris);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel_backward, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  megakernel_backward<<<spath_megakernel_backward_grid(n), kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      origins, directions, seeds, tri, gbar, partial, n, n_tris, spp,
      max_bounces);
  return static_cast<int>(cudaGetLastError());
}
