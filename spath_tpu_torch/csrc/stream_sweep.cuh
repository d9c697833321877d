// The streamed nearest-hit sweep of the large-scene forward kernel K6
// (bigscene.cu) and its backward K8 (bigscene_grad.cu). Both run the
// conformance walk of K1 (megakernel_common.cuh: sample_walk) through it,
// so that K8 replays K6's hits, draws and directions bit for bit.
//
// Counterpart of spath_tpu/ops/pallas/megakernel_bigscene.py::_sweep
// (the walk, _bigscene_walk, is sample_walk). The TPU kernel streams
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
// ray) helps stage rows and skips the tests, and the walk stops sweeping
// when no thread of the CTA still has a live path (__syncthreads_or).
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
// table's first 9 columns into buf, 4 bytes a copy (the (T, 18) rows are
// 8-byte aligned), and commit them as one group.
__device__ __forceinline__ void stage_rows(float* buf,
                                           const float* __restrict__ tri,
                                           int n_tris, int base) {
  const int rows = min(kTileRows, n_tris - base);
  for (int k = threadIdx.x; k < rows * kGeo; k += blockDim.x) {
    const int r = k / kGeo;
    __pipeline_memcpy_async(
        buf + k, tri + static_cast<size_t>(base + r) * kCols + (k - r * kGeo),
        sizeof(float));
  }
  __pipeline_commit();
}

// Nearest hit of the ray o + t d against every triangle of the (T, 18)
// table, streamed through `tiles` (2 * kTileFloats floats of shared
// memory). Every thread of the CTA calls it; a thread with live == false
// only helps stage and gets {kBig, -1}.
__device__ __forceinline__ Hit stream_nearest(const float* __restrict__ tri,
                                              int n_tris, float* tiles,
                                              bool live, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, int src) {
  Hit best{kBig, -1};
  const int n_blocks = (n_tris + kTileRows - 1) / kTileRows;
  stage_rows(tiles, tri, n_tris, 0);
  for (int j = 0; j < n_blocks; ++j) {
    // Prefetch block j + 1 into the other buffer, which every thread
    // finished reading at the end of step j - 1; an empty group at the
    // last step keeps the count of groups in flight the same.
    if (j + 1 < n_blocks) {
      stage_rows(tiles + ((j + 1) & 1) * kTileFloats, tri, n_tris,
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
      for (int r = 0; r < rows; ++r) {
        const float* row = buf + r * kGeo;
        mt_test<SharedRow>(row, base + r,
                           origin_terms<SharedRow>(row, ox, oy, oz), dx, dy,
                           dz, src, best);
      }
    }
    __syncthreads();
  }
  return best;
}

// K6's and K8's sweep for sample_walk (megakernel_common.cuh): the
// streamed sweep above, through the CTA's `tiles`. It synchronises the
// CTA, so the walk goes on sweeping while any thread of the CTA has a
// live path (__syncthreads_or).
struct StreamSweep {
  const float* __restrict__ tri;
  int n_tris;
  float* tiles;

  static constexpr bool kCtaWide = true;
  __device__ __forceinline__ Hit operator()(bool active, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, int src) const {
    return stream_nearest(tri, n_tris, tiles, active, ox, oy, oz, dx, dy, dz,
                          src);
  }
};

}  // namespace spath
