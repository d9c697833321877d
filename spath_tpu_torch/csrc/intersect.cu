// Standalone nearest hit of N rays against T triangles (K5).
//
// Replaces the TPU kernel spath_tpu/ops/pallas/intersect_pallas.py::_kernel
// (launched there by _forward under the custom VJP nearest_hit_pallas): the
// sweep the wavefront runs outside the fused kernels, at every bounce of
// every sample, and the visibility residual's sweeps (the NEE
// shadow-boundary edge rays, and the whole re-walk when no hits are
// exported). It keeps the reference semantics: the epsilon bounds of
// Moller-Trumbore, exclusion of each ray's source triangle by index, ties
// to the lowest index (a strict `<` in increasing index order), and
// {1e12, -1} on a miss. With -fmad=false and the plain version's order of
// operations, dist and idx are bit-identical to the plain sweep's
// (ops/intersect.py: _sweep) on every ray, the rays of ended paths that a
// wavefront still sweeps included.
//
// Design for Hopper, not block for block from the TPU kernel: one thread
// per ray, a CTA of kStreamThreads rays staging the triangles' v0, e1, e2
// through shared memory in blocks of 256 rows with cp.async,
// double-buffered (stream_sweep.cuh: stream_nearest, the large-scene
// kernels' sweep without their walk), each staged row tested with K1's
// mt_test. The TPU kernel's bf16 split packing of Plucker features for its
// matrix unit (pack_lhs/pack_rhs) is a TPU layout and not K5's (it is kept
// only as the operands of the microbenchmark T1, sweep_mm.cu); the products
// here are exact float32.
//
// Bound: operations. Each (ray, triangle) test is ~46 float operations
// (the origin terms included); device memory sees 36 bytes a ray (origin,
// direction, source index) and 12 out (distance, index), and the table's
// 36 bytes a row once per CTA, from L2.
//
// Layouts (checked by the Python wrapper ops/kernels/intersect.py), all
// row-major and contiguous:
//   origins, directions  float32 (n, 3)
//   src                  int64 (n): the source triangle, -1 for none
//   tri                  float32 (T, 9): v0, e1 = v1 - v0, e2 = v2 - v0
//   dist                 float32 (n): the nearest distance, 1e12 on a miss
//   idx                  int64 (n): the nearest triangle, -1 on a miss
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;

// Floats a row of the packed table: v0, e1, e2.
constexpr int kTriCols = 9;

__global__ void __launch_bounds__(kStreamThreads)
    nearest_hit(const float* __restrict__ origins,
                const float* __restrict__ directions,
                const int64_t* __restrict__ src,
                const float* __restrict__ tri, float* __restrict__ dist,
                int64_t* __restrict__ idx, int n, int n_tris) {
  __shared__ __align__(16) float tiles[2 * spath::kTileFloats];
  const int i = blockIdx.x * kStreamThreads + threadIdx.x;
  // No early return: every thread takes part in the CTA's sweep.
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  int s = -1;
  if (live) {
    ox = origins[3 * i + 0];
    oy = origins[3 * i + 1];
    oz = origins[3 * i + 2];
    dx = directions[3 * i + 0];
    dy = directions[3 * i + 1];
    dz = directions[3 * i + 2];
    s = static_cast<int>(src[i]);
  }
  const Hit h = spath::stream_nearest<kTriCols>(tri, n_tris, tiles, live, ox,
                                                oy, oz, dx, dy, dz, s);
  if (live) {
    dist[i] = h.dist;
    idx[i] = h.idx;
  }
}

}  // namespace

extern "C" int spath_nearest_hit(const float* origins, const float* directions,
                                 const int64_t* src, const float* tri,
                                 float* dist, int64_t* idx, int n, int n_tris,
                                 void* stream) {
  if (n < 1 || n_tris < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kStreamThreads - 1) / kStreamThreads;
  nearest_hit<<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, src, tri, dist, idx, n, n_tris);
  return static_cast<int>(cudaGetLastError());
}
