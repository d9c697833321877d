// The streamed nearest-hit sweep of the large-scene kernels: the
// conformance forward K6 (bigscene.cu) and its backward K8
// (bigscene_grad.cu), which run the conformance walk of K1
// (megakernel_common.cuh: walk_step) through it, and the quality
// forward K9 (bigscene_quality.cu) and its backward K10
// (bigscene_quality_grad.cu), which run the quality walk of K3
// (quality_walk.cuh: bounce_begin, bounce_end) through it. So K8 replays K6's
// hits, and K10 K9's, bit for bit. The sweeps take the table's row stride as a
// template argument: 18 floats for the conformance table, 21 for the quality
// table; both rows start with v0, e1, e2.
//
// Counterpart of spath_tpu/ops/pallas/megakernel_bigscene.py::_sweep
// (its walk, _bigscene_walk, is K6's loop over walk_step). The TPU kernel streams
// blocks of 256 triangles from HBM into VMEM and runs the Moller-Trumbore tests as matrix products; here a
// CTA of kStreamThreads threads (one ray each) stages blocks of kTileRows
// rows of the table's v0, e1, e2 columns (9 floats a row) into shared
// memory with cp.async, double-buffered, and every thread tests its ray
// against each staged row with the same code as K1
// (megakernel_common.cuh: origin_terms, mt_test, read from shared
// memory). Blocks go in increasing index order and rows within a block
// too, with a strict `<`, so the lowest index wins ties and the hit is
// bit-equal to K1's `nearest` on the same ray. The winner's shading
// attributes are read by index after the sweep (the TPU kernel's one-hot
// gather in the sweep is its way to an exact gather).
//
// The sweep synchronises the CTA, so every thread of a CTA calls it the
// same number of times: a thread whose path has ended (or that has no
// ray) helps stage rows and skips the tests. The queue kernels (K6, K8,
// K9, K10, K11) keep each lane on a live ray and stop when the queue of
// pixels is empty.
//
// Numerics: as K1 (-fmad=false, no fast math); see megakernel_common.cuh.

#pragma once

#include <cuda_pipeline.h>

#include "megakernel_common.cuh"

namespace spath {

// Threads (rays) a CTA.
constexpr int kStreamThreads = 128;
// Rows a staged block, and floats of its v0, e1, e2 columns.
constexpr int kTileRows = 256;
constexpr int kGeo = 9;
constexpr int kTileFloats = kTileRows * kGeo;
// Largest scene the streamed kernels take (JAX's BIG_MAX_TRIS).
constexpr int kBigMaxTris = 1 << 20;

// Start the asynchronous copies of rows [base, base + kTileRows) of the
// table's first 9 columns (rows of kStride floats) into buf, 4 bytes a
// copy (the (T, 18) rows are 8-byte aligned, the (T, 21) rows 4-byte),
// and commit them as one group.
template <int kStride>
__device__ __forceinline__ void stage_rows(float* buf,
                                           const float* __restrict__ tri,
                                           int n_tris, int base) {
  const int rows = min(kTileRows, n_tris - base);
  for (int k = threadIdx.x; k < rows * kGeo; k += blockDim.x) {
    const int r = k / kGeo;
    __pipeline_memcpy_async(
        buf + k,
        tri + static_cast<size_t>(base + r) * kStride + (k - r * kGeo),
        sizeof(float));
  }
  __pipeline_commit();
}

// Stream every row of the (T, kStride) table through `tiles` (2 *
// kTileFloats floats of shared memory), double-buffered, and hand each
// staged row to test(row, index) in increasing index order. Every thread
// of the CTA calls it; a thread with live == false only helps stage.
template <int kStride, class Test>
__device__ __forceinline__ void stream_rows(const float* __restrict__ tri,
                                            int n_tris, float* tiles,
                                            bool live, Test test) {
  const int n_blocks = (n_tris + kTileRows - 1) / kTileRows;
  stage_rows<kStride>(tiles, tri, n_tris, 0);
  for (int j = 0; j < n_blocks; ++j) {
    // Prefetch block j + 1 into the other buffer, which every thread
    // finished reading at the end of step j - 1; an empty group at the
    // last step keeps the count of groups in flight the same.
    if (j + 1 < n_blocks) {
      stage_rows<kStride>(tiles + ((j + 1) & 1) * kTileFloats, tri, n_tris,
                          (j + 1) * kTileRows);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    if (live) {
      const float* buf = tiles + (j & 1) * kTileFloats;
      const int base = j * kTileRows;
      const int rows = min(kTileRows, n_tris - base);
      for (int r = 0; r < rows; ++r) test(buf + r * kGeo, base + r);
    }
    __syncthreads();
  }
}

// Nearest hit of the ray o + t d against every triangle of the table,
// streamed; {kBig, -1} for a thread with live == false.
template <int kStride = kCols>
__device__ __forceinline__ Hit stream_nearest(const float* __restrict__ tri,
                                              int n_tris, float* tiles,
                                              bool live, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, int src) {
  Hit best{kBig, -1};
  stream_rows<kStride>(tri, n_tris, tiles, live,
                       [&](const float* row, int t) {
                         mt_test<SharedRow>(
                             row, t, origin_terms<SharedRow>(row, ox, oy, oz),
                             dx, dy, dz, src, best);
                       });
  return best;
}

// The streamed nearest2 (megakernel_common.cuh): two rays sharing the
// origin o, a shadow ray d1 and the next bounce's ray d2, tested against
// each staged row with the origin terms computed once. Each block is
// staged once for both, and each result is bit-equal to its own
// stream_nearest (and to nearest) call.
template <int kStride>
__device__ __forceinline__ void stream_nearest2(
    const float* __restrict__ tri, int n_tris, float* tiles, bool live,
    float ox, float oy, float oz, float d1x, float d1y, float d1z, float d2x,
    float d2y, float d2z, int src, Hit& h1, Hit& h2) {
  h1 = Hit{kBig, -1};
  h2 = Hit{kBig, -1};
  stream_rows<kStride>(tri, n_tris, tiles, live,
                       [&](const float* row, int t) {
                         const OriginTerms o =
                             origin_terms<SharedRow>(row, ox, oy, oz);
                         mt_test<SharedRow>(row, t, o, d1x, d1y, d1z, src,
                                            h1);
                         mt_test<SharedRow>(row, t, o, d2x, d2y, d2z, src,
                                            h2);
                       });
}

// K6's and K8's sweep: the streamed sweep above, through the CTA's
// `tiles`. It synchronises the CTA, so every thread calls it the same
// number of times.
struct StreamSweep {
  const float* __restrict__ tri;
  int n_tris;
  float* tiles;

  __device__ __forceinline__ Hit operator()(bool active, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, int src) const {
    return stream_nearest(tri, n_tris, tiles, active, ox, oy, oz, dx, dy, dz,
                          src);
  }
};

}  // namespace spath
