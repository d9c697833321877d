// Reverse sweep of the whole-frame quality path tracer (K4).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_quality_grad.py::_qbwd_kernel (launched
// there by quality_bwd_call), whose per-tile body is _bwd_tile_quality and
// per-bounce body _reverse_bounce. One thread owns one ray, as in K3.
//
// For each sample a thread replays K3's walk through quality_walk.cuh
// (the same source, so the same hits, draws and lights), saving per bounce
// only what cannot be recomputed: the ray before the bounce, the hit
// distance and index, the throughput, the two MIS weights, the light
// whose term counted (-1 if none) and the roulette's q. The hash draws
// are stateless and recomputed from (key, sample, bounce, draw); the
// table's columns are read again by index. The reverse sweep then runs
// from the last hit back to the camera, one bounce at a time through
// quality_reverse.cuh (reverse_bounce, shared with K10): the roulette's
// 1/q, the emitter term, the albedo, the NEE term with its live position
// chain to the light and the hit point, and the Moller-Trumbore distance
// chain to the hit triangle and the ray's origin.
//
// Outputs: the table adjoint, 19 columns per triangle (v0, e1, e2,
// normal, albedo, emission, area), scattered at the hit triangle (18
// columns) and at the light on the lanes whose NEE term counted (16
// columns); and per ray the camera-ray adjoint (origin, direction), summed
// over samples by its own thread, with no reduction.
//
// Accumulation is deterministic: no float atomics. Each warp owns a
// (T, 19) slice of shared memory. At every (sample, bounce) step of the
// reverse sweep the lanes that hit stage their triangle, their light and
// 34 adjoints; then lanes 0-18, one per column, add the staged values into
// the slice in lane order, the surface term before the light term. At the
// end the block sums its warps' slices in warp order into its row of
// `partial` (grid, T * 19), and the wrapper sums the rows (torch.sum, a
// fixed-order reduction). Four warp slices need 76 KB of shared memory at
// T = 256 and 304 KB at T = 1024, above the 227 KB a Hopper block can
// have, so the block has 128 threads (4 slices) up to T = 704 and 64
// threads (2 slices, 2 warps) above: one 64-thread block per SM at
// T = 1024. The grid has a fixed size for a given (n, T) (blocks walk the
// rays in a grid-stride loop), so two launches on the same inputs give
// the same bits.
//
// Bound: compute, as K3. The replay repeats K3's sweeps; the reverse
// sweep adds ~155 float operations per hit and ~206 more where the NEE
// term counted, the accumulation up to 34 shared-memory adds per hit,
// serialised over the warp's hitting lanes.
// Rays, keys and gbar are read once; the outputs are grid * T * 19 and
// n * 6 floats. The saved per-bounce state sits in local memory (an array
// indexed by bounce), backed by the L1 cache.
//
// Layouts (checked by the Python wrapper
// ops/kernels/megakernel_quality_grad.py), all row-major and contiguous:
//   origins, directions, keys, tri, rows   as K3 (megakernel_quality.cu)
//   gbar                 float32 (n, 3): the cotangent of K3's output
//   partial              float32 (grid, T * 19): per-block table adjoints,
//                        grid = spath_quality_backward_grid(n, T)
//   grays                float32 (n, 6): d(loss)/d(origin, direction)
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_reverse.cuh"
#include "quality_walk.cuh"

namespace {

using spath::Bounce;
using spath::Hit;
using spath::kMaxBounces;
using spath::kQCols;
using spath::kSurf;
using spath::QualityArgs;

constexpr unsigned kFull = 0xffffffffu;
// Adjoint columns per triangle: v0, e1, e2, normal, albedo, emission, area.
constexpr int kAdj = spath::kAdj19;
// A staged contribution: triangle and light (as float bits), 18 surface
// adjoints (columns 0-17), 16 light adjoints (columns 0-11, 15-18).
constexpr int kStage = 2 + kSurf + spath::kLight;
// Most blocks a launch uses; larger frames loop (grid-stride).
constexpr int kMaxGrid = 2048;
// Shared memory a Hopper block may use.
constexpr int kMaxShared = 232448;

__host__ __device__ int shared_bytes(int n_tris, int warps) {
  return static_cast<int>(sizeof(float)) * warps *
         (n_tris * kAdj + 32 * kStage);
}

int block_threads(int n_tris) {
  return shared_bytes(n_tris, 4) <= kMaxShared ? 128 : 64;
}

__global__ void __launch_bounds__(128)
    quality_backward(const float* __restrict__ origins,
                     const float* __restrict__ directions,
                     const int64_t* __restrict__ keys,
                     const float* __restrict__ gbar,
                     float* __restrict__ partial, float* __restrict__ grays,
                     int n, QualityArgs a) {
  extern __shared__ float smem[];
  const float* __restrict__ tri = a.tri;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slice = a.n_tris * kAdj;
  float* acc = smem + warp * slice;
  float* stage = smem + warps * slice + warp * 32 * kStage;
  for (int k = lane; k < slice; k += 32) acc[k] = 0.0f;
  __syncwarp();

  Bounce st[kMaxBounces];

  // Every lane of a warp runs the same chunks, samples and reverse steps,
  // so the warp-wide exchanges below see all 32 lanes.
  for (int base = blockIdx.x * blockDim.x; base < n;
       base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    const bool live = i < n;
    float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
    float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
    float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
    uint32_t h1 = 0u;
    Hit first{spath::kBig, -1};
    if (live) {
      ox0 = origins[3 * i + 0];
      oy0 = origins[3 * i + 1];
      oz0 = origins[3 * i + 2];
      dx0 = directions[3 * i + 0];
      dy0 = directions[3 * i + 1];
      dz0 = directions[3 * i + 2];
      g_r = gbar[3 * i + 0] * a.inv_spp;
      g_g = gbar[3 * i + 1] * a.inv_spp;
      g_b = gbar[3 * i + 2] * a.inv_spp;
      h1 = spath::fmix(static_cast<uint32_t>(keys[i]));
      // Camera rays are the same for every sample.
      first = spath::nearest<kQCols>(tri, a.n_tris, ox0, oy0, oz0, dx0, dy0,
                                     dz0, -1);
    }
    // the camera ray's adjoint, summed over samples
    float go_x = 0.0f, go_y = 0.0f, go_z = 0.0f;
    float gd_x = 0.0f, gd_y = 0.0f, gd_z = 0.0f;

    for (int s = 0; s < a.spp; ++s) {
      // ---- forward replay of K3's walk ----
      int len = 0;
      if (live) {
        float rr = 0.0f, rg = 0.0f, rb = 0.0f;
        len = spath::quality_sample(a, spath::table_quality(a), ox0, oy0,
                                    oz0, dx0, dy0, dz0, first, h1, s, rr,
                                    rg, rb, spath::Saver{st});
      }
      const uint32_t sc = static_cast<uint32_t>(s) * spath::kC1;

      // ---- reverse sweep, the warp's longest path first ----
      const int depth = __reduce_max_sync(kFull, len);
      float tb_r = 0.0f, tb_g = 0.0f, tb_b = 0.0f;  // thr-bar after bounce b
      float ob_x = 0.0f, ob_y = 0.0f, ob_z = 0.0f;  // o-bar of bounce b + 1
      for (int b = depth - 1; b >= 0; --b) {
        const bool hit = b < len;
        int li = -1;
        if (hit) {
          const Bounce& B = st[b];
          float* e = stage + lane * kStage;
          spath::ReverseOut ro;
          li = spath::reverse_bounce(a, h1, sc, b, B, g_r, g_g, g_b, tb_r,
                                     tb_g, tb_b, ob_x, ob_y, ob_z, e + 2,
                                     e + 2 + kSurf, ro);
          e[0] = __int_as_float(B.idx);
          e[1] = __int_as_float(li);
          // the origin's adjoint goes to the bounce before, or at bounce
          // 0 to the camera ray with the direction's
          if (b == 0) {
            go_x = go_x + ro.on_x;
            go_y = go_y + ro.on_y;
            go_z = go_z + ro.on_z;
            gd_x = gd_x + ro.gd_x;
            gd_y = gd_y + ro.gd_y;
            gd_z = gd_z + ro.gd_z;
          } else {
            ob_x = ro.on_x;
            ob_y = ro.on_y;
            ob_z = ro.on_z;
          }
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        __syncwarp();
        if (lane < kAdj) {
          // lane c owns column c: surface adds, then the light's
          const int lcol = lane < 12 ? lane : (lane >= 15 ? lane - 3 : -1);
          for (unsigned m = hits; m != 0u; m &= m - 1u) {
            const float* x = stage + (__ffs(m) - 1) * kStage;
            if (lane < kSurf) {
              float* p = acc + __float_as_int(x[0]) * kAdj + lane;
              *p = *p + x[2 + lane];
            }
            const int lrow = __float_as_int(x[1]);
            if (lrow >= 0 && lcol >= 0) {
              float* p = acc + lrow * kAdj + lane;
              *p = *p + x[2 + kSurf + lcol];
            }
          }
        }
        __syncwarp();
      }
    }
    if (live) {
      grays[6 * i + 0] = go_x;
      grays[6 * i + 1] = go_y;
      grays[6 * i + 2] = go_z;
      grays[6 * i + 3] = gd_x;
      grays[6 * i + 4] = gd_y;
      grays[6 * i + 5] = gd_z;
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < slice; k += blockDim.x) {
    float sum = smem[k];
    for (int w = 1; w < warps; ++w) sum = sum + smem[w * slice + k];
    partial[blockIdx.x * slice + k] = sum;
  }
}

}  // namespace

extern "C" int spath_quality_backward_grid(int n, int n_tris) {
  const int threads = block_threads(n_tris);
  const int blocks = (n + threads - 1) / threads;
  return blocks < kMaxGrid ? blocks : kMaxGrid;
}

// flags: as spath::make_args takes them.
extern "C" int spath_quality_backward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* gbar, float* partial,
    float* grays, int n, int n_tris, int n_rows, int spp, int max_bounces,
    int rr_start, int flags, float inv_spp, void* stream) {
  const int threads = block_threads(n_tris);
  if (n < 1 || n_tris < 1 || n_rows < 0 || spp < 1 || max_bounces < 0 ||
      max_bounces > kMaxBounces || rr_start < 0 ||
      shared_bytes(n_tris, threads / 32) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  const int smem = shared_bytes(n_tris, threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quality_backward, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  quality_backward<<<spath_quality_backward_grid(n, n_tris), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, gbar, partial, grays, n, a);
  return static_cast<int>(cudaGetLastError());
}
