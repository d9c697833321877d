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
// Design for Hopper, not block for block from the TPU kernel. Bound:
// operations. Each (ray, triangle) test is ~46 float operations (the
// origin terms included); device memory sees 36 bytes a ray (origin,
// direction, source index) and 12 out (distance, index), and the table's
// 36 bytes a row once per CTA, from L2. The first port (a thread a ray, a
// 128-ray CTA on stream_sweep.cuh's stream_nearest) issued 84 SASS
// instructions a (ray, row) pair, 9 of them scalar shared-memory loads
// (its rows were 36 bytes), and a residual slice (262,144 rays) made 1.29
// waves of its CTAs, the second a quarter full. So:
//
//   - a CTA stages blocks of kTileRows rows of v0, e1, e2 through shared
//     memory with cp.async, double-buffered, each row padded to 12 floats
//     and read as three vector loads into registers; each thread holds
//     kRays rays and tests each of them against the row, so a row is
//     loaded once for kRays tests, four rows a loop step. Each test
//     (test_pair) computes mt_test's values (megakernel_common.cuh) by
//     the same expressions, in increasing row order per ray: each ray's
//     arithmetic is the plain sweep's;
//   - a cull before the division (may_pass): h, a and s . h first, and
//     where no lane of the warp can pass the test whatever f = 1 / a and
//     u round to (a degenerate, or u below 0 or above 1 by a margin no
//     rounding crosses), the warp skips the rest: the correctly rounded
//     division and 48 instructions of a pair's 85. Most rows miss every
//     ray of a warp, so a pair takes 37 instructions there
//     (tools/sass_loop.py on the sm_90a build);
//   - the grid is the ray tiles times `splits` ranges of row blocks
//     (ops/kernels/intersect.py::sweep_plan sizes it from this kernel's
//     resident CTAs: many waves of them, so that a few rays against many
//     triangles still fill the card and no SM waits long on its last
//     CTAs, whose warps cull unevenly).
//     With one split each ray's hit goes to dist/idx. With more, each
//     CTA writes its range's nearest hit to the partials and merge_hits
//     takes, per ray, the partials in split order with a strict `<`:
//     each range's hit is the nearest in the range with ties to its
//     lowest index, so this is the sequential sweep's result to the bit.
//
// The TPU kernel's bf16 split packing of Plucker features for its matrix
// unit (pack_lhs/pack_rhs) is a TPU layout and not K5's (it is kept only
// as the operands of the microbenchmark T1, sweep_mm.cu); the products
// here are exact float32.
//
// Layouts (checked by the Python wrapper ops/kernels/intersect.py), all
// row-major and contiguous:
//   origins, directions  float32 (n, 3)
//   src                  int64 (n): the source triangle, -1 for none
//   tri                  float32 (T, 9): v0, e1 = v1 - v0, e2 = v2 - v0
//   dist                 float32 (n): the nearest distance, 1e12 on a miss
//   idx                  int64 (n): the nearest triangle, -1 on a miss
//   part_dist, part_idx  float32, int32 (splits, n): scratch, null for one
//                        split
// The launches go on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns a cudaError_t.

#include "stream_sweep.cuh"

namespace {

using spath::Hit;
using spath::kStreamThreads;
using spath::kTileRows;

// Floats a row of the packed table: v0, e1, e2; and of a staged row, padded
// to three float4.
constexpr int kTriCols = 9;
constexpr int kRowFloats = 12;
constexpr int kBufFloats = kTileRows * kRowFloats;
// Rays a thread holds.
constexpr int kRays = 2;
// Threads of the merge.
constexpr int kMergeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// The cull's bounds (may_pass): 2^-100, and 1 + 2^-21.
constexpr float kTinyRatio = 0x1p-100f;
constexpr float kAboveOne = 0x1.00001p+0f;

// Can mt_test accept a pair whose a = e1 . h and sh = s . h are these?
// False only where it cannot, whatever the rounding of f = 1 / a and of
// u = f * sh: a degenerate (|a| < eps, or NaN), or with su = sh * sign(a)
// and m = |a|,
//   - su < -RN(m * 2^-100): u = sh / a < -2^-101 (m >= eps keeps the
//     bound's rounding error below 2^-150), so f * sh rounds to a
//     negative number and u >= 0 fails;
//   - su > RN(m * (1 + 2^-21)): sh / a > (1 + 2^-21)(1 - 2^-24), above
//     (1 + 2^-24) / (1 - 2^-24), so f * sh lies above 1 + 2^-24 and
//     rounds above 1: u <= 1 fails.
// NaN or infinite values fail both comparisons and pass.
__device__ __forceinline__ bool may_pass(float a, float sh) {
  const float m = fabsf(a);
  const float su = a < 0.0f ? -sh : sh;
  return m >= spath::kEps && !(su < -(m * kTinyRatio)) &&
         !(su > m * kAboveOne);
}

// One Moller-Trumbore test of the ray (o, d, src) against row t (v0, e1,
// e2 in r), updating best: mt_test's arithmetic with origin_terms'
// (megakernel_common.cuh), each value by the same expression, so the same
// bits, and a cull before the division: where no lane of the warp
// may_pass, the warp leaves the test there. Every lane of the warp calls
// it.
__device__ __forceinline__ void test_pair(const float* r, int t, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, int src,
                                          Hit& best) {
  const float sx = ox - r[0];
  const float sy = oy - r[1];
  const float sz = oz - r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  // h = d x e2
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float sh = sx * hx + sy * hy + sz * hz;
  if (!__any_sync(kFull, may_pass(a, sh))) return;
  // q = s x e1
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float e2q = e2x * qx + e2y * qy + e2z * qz;
  const bool nondeg = fabsf(a) >= spath::kEps;
  const float f = 1.0f / (nondeg ? a : 1.0f);
  const float u = f * sh;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  const float dist = f * e2q;
  const bool ok = nondeg && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  u + v <= 1.0f && dist > spath::kEps &&
                  dist < spath::kInvEps && src != t && dist < best.dist;
  if (ok) {
    best.dist = dist;
    best.idx = t;
  }
}

// Start the asynchronous copies of rows [base, base + rows) of the (T, 9)
// table into buf, 12 floats a row, and commit them as one group.
__device__ __forceinline__ void stage_padded(float* buf,
                                             const float* __restrict__ tri,
                                             int base, int rows) {
  for (int k = threadIdx.x; k < rows * kTriCols; k += kStreamThreads) {
    const int r = k / kTriCols;
    const int c = k - r * kTriCols;
    __pipeline_memcpy_async(
        buf + r * kRowFloats + c,
        tri + static_cast<size_t>(base + r) * kTriCols + c, sizeof(float));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kStreamThreads)
    nearest_hit(const float* __restrict__ origins,
                const float* __restrict__ directions,
                const int64_t* __restrict__ src,
                const float* __restrict__ tri, float* __restrict__ dist,
                int64_t* __restrict__ idx, float* __restrict__ part_dist,
                int* __restrict__ part_idx, int n, int n_tris) {
  __shared__ __align__(16) float tiles[2 * kBufFloats];
  const int splits = gridDim.y;
  const int n_blocks = (n_tris + kTileRows - 1) / kTileRows;
  const int split = blockIdx.y;
  const int b0 = static_cast<int>(static_cast<int64_t>(split) * n_blocks /
                                  splits);
  const int b1 = static_cast<int>(
      static_cast<int64_t>(split + 1) * n_blocks / splits);
  // Thread t holds rays first + j * kStreamThreads, j < kRays.
  const int first = blockIdx.x * (kStreamThreads * kRays) + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  int s[kRays];
  Hit best[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = first + j * kStreamThreads;
    const bool live = i < n;
    ox[j] = live ? origins[3 * i + 0] : 0.0f;
    oy[j] = live ? origins[3 * i + 1] : 0.0f;
    oz[j] = live ? origins[3 * i + 2] : 0.0f;
    dx[j] = live ? directions[3 * i + 0] : 0.0f;
    dy[j] = live ? directions[3 * i + 1] : 0.0f;
    dz[j] = live ? directions[3 * i + 2] : 0.0f;
    s[j] = live ? static_cast<int>(src[i]) : -1;
    best[j] = Hit{spath::kBig, -1};
  }
  // No early return: every thread takes part in the CTA's staging and
  // every lane in its warp's tests (a lane past n tests a zero ray, which
  // no row accepts).
  if (b0 < b1) {
    stage_padded(tiles, tri, b0 * kTileRows,
                 min(kTileRows, n_tris - b0 * kTileRows));
  }
  for (int blk = b0; blk < b1; ++blk) {
    // Prefetch block blk + 1 into the other buffer, which every thread
    // finished reading at the end of the step before; an empty group at
    // the last step keeps the count of groups in flight the same.
    const int base = blk * kTileRows;
    if (blk + 1 < b1) {
      stage_padded(tiles + ((blk + 1 - b0) & 1) * kBufFloats, tri,
                   base + kTileRows,
                   min(kTileRows, n_tris - base - kTileRows));
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* buf = tiles + ((blk - b0) & 1) * kBufFloats;
    const int rows = min(kTileRows, n_tris - base);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float4* q = reinterpret_cast<const float4*>(buf + r * kRowFloats);
      const float4 p0 = q[0], p1 = q[1], p2 = q[2];
      const float row[kTriCols] = {p0.x, p0.y, p0.z, p0.w, p1.x,
                                   p1.y, p1.z, p1.w, p2.x};
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        test_pair(row, base + r, ox[j], oy[j], oz[j], dx[j], dy[j], dz[j],
                  s[j], best[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = first + j * kStreamThreads;
    if (i >= n) continue;
    if (splits == 1) {
      dist[i] = best[j].dist;
      idx[i] = best[j].idx;
    } else {
      const size_t at = static_cast<size_t>(split) * n + i;
      part_dist[at] = best[j].dist;
      part_idx[at] = best[j].idx;
    }
  }
}

// Each ray's nearest hit from its splits' partials, in split order with a
// strict `<`: the lowest index wins ties, as in one sequential sweep.
__global__ void __launch_bounds__(kMergeThreads)
    merge_hits(const float* __restrict__ part_dist,
               const int* __restrict__ part_idx, float* __restrict__ dist,
               int64_t* __restrict__ idx, int n, int splits) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n) return;
  Hit best{spath::kBig, -1};
  for (int k = 0; k < splits; ++k) {
    const size_t at = static_cast<size_t>(k) * n + i;
    const float d = part_dist[at];
    if (d < best.dist) {
      best.dist = d;
      best.idx = part_idx[at];
    }
  }
  dist[i] = best.dist;
  idx[i] = best.idx;
}

}  // namespace

// Rays a CTA of K5 holds (its ray tile), and its CTAs resident on one SM
// (or a negative cudaError_t): ops/kernels/intersect.py::sweep_plan.
extern "C" int spath_nearest_hit_tile() { return kStreamThreads * kRays; }

extern "C" int spath_nearest_hit_occupancy() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nearest_hit, kStreamThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// splits: ranges of row blocks a ray tile's rows are cut into, 1 to the
// table's blocks; above 1 part_dist and part_idx hold (splits, n).
extern "C" int spath_nearest_hit(const float* origins, const float* directions,
                                 const int64_t* src, const float* tri,
                                 float* dist, int64_t* idx, float* part_dist,
                                 int* part_idx, int n, int n_tris, int splits,
                                 void* stream) {
  const int n_blocks = (n_tris + kTileRows - 1) / kTileRows;
  if (n < 1 || n_tris < 1 || splits < 1 || splits > n_blocks ||
      splits > 65535 ||
      (splits > 1 && (part_dist == nullptr || part_idx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int tile = kStreamThreads * kRays;
  const dim3 grid((n + tile - 1) / tile, splits);
  nearest_hit<<<grid, kStreamThreads, 0, s>>>(origins, directions, src, tri,
                                              dist, idx, part_dist, part_idx,
                                              n, n_tris);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_hits<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                 s>>>(part_dist, part_idx, dist, idx, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
