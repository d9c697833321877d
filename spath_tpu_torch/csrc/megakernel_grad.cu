// Reverse sweep of the whole-frame conformance path tracer (K2).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_grad.py::_mega_bwd_kernel (launched
// there by mega_bwd_call), with position_chain=False as that kernel runs
// it. It computes the same function, not the same blocks: a lane owns a
// pixel, as in K1, and alternates two warp-wide epochs:
//   - forward: E = kEpoch (4) steps of K1's lane loop
//     (megakernel_lanes.cuh: the same source, so the same hits, draws and
//     directions), with regeneration across the pixel's samples and then
//     its next pixels; each bounce appends its record to the lane's ring
//     in global memory: only what the reverse sweep needs, the hit index
//     with the flip sign fs, the weight w, the sampled direction om and
//     the throughput tr before the bounce (32 bytes, two float4). Albedo
//     and emission are read again from the table by index. A sample that
//     ends leaves a tag (pixel, bounces) for the reverse epoch.
//   - reverse: every lane runs the records of its finished samples, in
//     sample order and last bounce first within a sample, one reverse
//     bounce a step. A sample still in flight stays in the ring for the
//     next epochs; the ring holds E + max_bounces - 1 records, and a lane
//     waits before a sample the ring could not hold.
// Counted on the conformance headline (PERF.md): the lockstep loop this
// replaced stepped 57,719 forward and 67,930 reverse warp steps; these
// epochs 30,236 and 52,904 (33,022 at E = 64); a reverse in the lane as
// each sample ends 131,091 (a warp would run its longest ending sample at
// nearly every step). E is short because of the ring, not the count: at
// E = 64 the rings (68 records a lane, 321 MB on an H100) do not stay in
// L2, and their stores took 3.4 of K2's 11.9 ms; at E = 4 (8 records a
// lane, 34 MB) K2 takes 8.7 ms, of which the stores 0.7 and the reverse
// epochs 2.4 (timed, PERF.md).
//
// The reverse sweep runs from the last hit back to the camera, with
// g = gbar / spp and bb the adjoint of the throughput after the bounce
// (the JAX kernel's tb), in that kernel's order of operations:
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
// Accumulation is deterministic: no float atomics. At every step of a
// reverse epoch each lane with a record has its triangle's 9 adjoints in
// registers. Up to T = 8 each pair of lanes owns a (T, 9) slice of
// shared memory (16 a warp), and the even lane adds its values into it,
// then the odd lane: the adds of a step run in parallel across pairs.
// Above, each warp owns one slice: the lanes stage their triangle and
// adjoints in shared memory, and lanes 0-8, one per column, add the
// staged values in lane order, keeping a running sum in a register while
// consecutive adds hit one row. The warps take runs from a queue (one
// int32 counter, one atomic a run): run r of R is the pixels r, r + R,
// r + 2R, ..., so that every run samples the whole frame and the runs
// take about as long (runs of consecutive pixels, some all sky and some
// all scene, measured slower: PERF.md). A run's lanes, epochs and ring
// start afresh, so what the run adds, and in which order, is a function
// of its pixels alone. After each reverse epoch the warp adds its slices,
// in order, into the run's own float64 row of `partial` (R, T * 9),
// zeroed by the wrapper, and zeroes them; the wrapper sums the rows in
// run order (torch.sum, a fixed-order reduction) and rounds once. So two
// launches give the same bits, whichever warp takes which run. The grid
// is persistent, K2's resident CTAs, R a multiple of its warps
// (ops/kernels/megakernel_grad.py).
//
// Bound: compute, as K1. The replay repeats K1's sweeps; the reverse
// sweep adds ~40 float operations per hit and 9 shared-memory adds. Rays,
// seeds and gbar are read once; each record is written once and read
// once (through L2), the rows written once.
//
// Layouts (checked by the Python wrapper ops/kernels/megakernel_grad.py),
// all row-major and contiguous:
//   origins, directions  float32 (n, 3): the camera rays
//   seeds                int64 (n): the pixel's uint32 LCG seed
//   tri                  float32 (T, 18): as K1's table
//   gbar                 float32 (n, 3): the cotangent of K1's output
//   partial              float64 (n_runs, T * 9), zero: each run's
//                        adjoints of columns 9-17
//   rings                float32 (grid * 128 *
//                        spath_megakernel_backward_ring(max_bounces)):
//                        each lane's ring
//   next_run             int32 (1,), zero: the queue's counter
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "megakernel_common.cuh"
#include "megakernel_lanes.cuh"

namespace {

using spath::ConfLane;
using spath::kCols;
using spath::kMaxBounces;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// Adjoint columns per triangle: normal, albedo, emission (table cols 9-17).
constexpr int kAdj = 9;
// A staged contribution: the triangle index (as float bits), 9 adjoints.
constexpr int kStage = kAdj + 1;
// Forward steps an epoch (E): a short epoch keeps every lane's ring
// (E + max_bounces - 1 records) in L2 (timed on an H100, PERF.md).
constexpr int kEpoch = 4;
// Forward steps between two adds of the float32 slices into the run's
// float64 row: a slice sums no more than these steps' terms.
constexpr int kFlushSteps = 64;
// Largest T of the lane-pair slices.
constexpr int kPairMaxTris = 8;
// float4 a record.
constexpr int kRecord = 2;

// Shared memory of a block: its warps' slices, and above T = 8 their
// stages.
__host__ __device__ int shared_bytes(int n_tris, bool pairs) {
  return static_cast<int>(sizeof(float)) * kWarps *
         (pairs ? 16 * n_tris * kAdj : n_tris * kAdj + 32 * kStage);
}

// Records a lane's ring holds: an epoch's, and those of a sample still in
// flight.
__host__ __device__ int ring_records(int max_bounces) {
  return kEpoch + max_bounces - 1;
}

// float4 of a lane's ring: its records, then one int2 tag a record.
__host__ __device__ int ring_float4(int max_bounces) {
  const int size = ring_records(max_bounces);
  return kRecord * size + (size + 1) / 2;
}

// A bounce's record: the hit index, its sign bit the flip (fs = -1), the
// weight, the sampled direction and the throughput before the bounce.
__device__ __forceinline__ void put(float4* r, int idx,
                                    const spath::Surface& s, float tr,
                                    float tg, float tb) {
  r[0] = make_float4(__int_as_float(s.fs < 0.0f ? ~idx : idx), s.w, s.sx,
                     s.sy);
  r[1] = make_float4(s.sz, tr, tg, tb);
}

// K2's forward lane hooks: each bounce's record to the ring, each
// finished sample's tag.
struct RecordLane {
  float4* ring;  // size records, then size tags
  int size;      // records the ring holds
  int head;      // where the next record goes
  int ntags;
  int fin;  // records of finished samples not yet reversed

  __device__ __forceinline__ int2* tags() const {
    return reinterpret_cast<int2*>(ring + kRecord * size);
  }
  __device__ __forceinline__ void take(const ConfLane&) {}
  __device__ __forceinline__ void operator()(int, int idx,
                                             const spath::Surface& s,
                                             float tr, float tg, float tb) {
    put(ring + kRecord * head, idx, s, tr, tg, tb);
    head = head + 1 == size ? 0 : head + 1;
  }
  __device__ __forceinline__ void sample(const ConfLane& w) {
    if (w.b > 0) {
      tags()[ntags++] = make_int2(w.pix, w.b);
      fin += w.b;
    }
  }
  __device__ __forceinline__ void pixel(const ConfLane&) {}
  // Wait before a sample until the ring has room for all its bounces.
  __device__ __forceinline__ bool pause(int max_bounces) const {
    return fin + max_bounces > size;
  }
};

template <bool kPairs>
__global__ void __launch_bounds__(kBlock)
    megakernel_backward(const float* __restrict__ origins,
                        const float* __restrict__ directions,
                        const int64_t* __restrict__ seeds,
                        const float* __restrict__ tri,
                        const float* __restrict__ gbar,
                        double* __restrict__ partial,
                        float4* __restrict__ rings,
                        int* __restrict__ next_run, int n, int n_tris,
                        int spp, int max_bounces, int n_runs) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = n_tris * kAdj;
  constexpr int kSlices = kPairs ? 16 : 1;
  float* acc = smem + warp * kSlices * slice;
  float* stage = smem + kWarps * kSlices * slice + warp * 32 * kStage;
  // (the lane-pair slices add from registers and use no stage)
  for (int k = lane; k < kSlices * slice; k += 32) acc[k] = 0.0f;
  __syncwarp();

  const float inv = 1.0f / static_cast<float>(spp);
  const int size = ring_records(max_bounces);
  RecordLane rec{rings + static_cast<size_t>(blockIdx.x * kBlock +
                                             threadIdx.x) *
                             ring_float4(max_bounces),
                 size, 0, 0, 0};
  const spath::ConfArgs a{tri, n_tris, spp, max_bounces};
  ConfLane w;

  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next_run, 1);
    r = __shfl_sync(kFull, r, 0);
    if (r >= n_runs) break;
    double* row = partial + static_cast<size_t>(r) * slice;
    // the run's pixels r, r + n_runs, ...: PixelSource's sequence of runs
    // of one pixel for "warp" r of n_runs
    spath::PixelSource src{nullptr, n, 1, r, n_runs, 0};
    w.init();
    rec.head = rec.ntags = rec.fin = 0;
    int tail = 0;   // the ring's oldest record not yet reversed
    int since = 0;  // forward steps since the slices' last flush

    bool forward = true;
    while (forward) {
      // ---- forward epoch: K1's walk, recording ----
      for (int e = 0; e < kEpoch; ++e) {
        if (!w.step(a, src, origins, directions, seeds, rec)) {
          forward = false;
          break;
        }
        ++since;
      }

      // ---- reverse epoch: the finished samples, one bounce a step ----
      // The sample being reversed: its pixel, first record and bounce (rb
      // < 0 between samples; every reverse epoch ends between samples).
      int t = 0, rpix = 0, rfirst = 0, rb = -1;
      float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
      float bb_r = 0.0f, bb_g = 0.0f, bb_b = 0.0f;  // thr-bar after bounce rb
      const int depth = __reduce_max_sync(kFull, rec.fin);
      for (int k = 0; k < depth; ++k) {
        const bool live = k < rec.fin;
        int r9 = 0;         // the hit triangle's first adjoint column
        float v[kAdj];      // its 9 adjoints
        if (live) {
          if (rb < 0) {
            const int2 tag = rec.tags()[t++];
            rpix = tag.x;
            rb = tag.y - 1;
            rfirst = tail;
            tail = tail + tag.y >= size ? tail + tag.y - size
                                        : tail + tag.y;
            g_r = gbar[3 * rpix + 0] * inv;
            g_g = gbar[3 * rpix + 1] * inv;
            g_b = gbar[3 * rpix + 2] * inv;
            bb_r = bb_g = bb_b = 0.0f;
          }
          const int at = rfirst + rb >= size ? rfirst + rb - size
                                             : rfirst + rb;
          const float4 r0 = rec.ring[kRecord * at];
          const float4 r1 = rec.ring[kRecord * at + 1];
          const int code = __float_as_int(r0.x);
          const int idx = code < 0 ? ~code : code;
          const float fs = code < 0 ? -1.0f : 1.0f;
          const float w_ = r0.y;
          const float tr = r1.y, tg = r1.z, tb = r1.w;
          const float* row_t = tri + idx * kCols;
          const float ar = __ldg(row_t + 12), ag = __ldg(row_t + 13),
                      ab = __ldg(row_t + 14);
          const float er = __ldg(row_t + 15), eg = __ldg(row_t + 16),
                      eb = __ldg(row_t + 17);
          r9 = idx * kAdj;
          const float wbar = bb_r * tr * ar + bb_g * tg * ag + bb_b * tb * ab;
          v[0] = 2.0f * wbar * fs * r0.z;
          v[1] = 2.0f * wbar * fs * r0.w;
          v[2] = 2.0f * wbar * fs * r1.x;
          v[3] = bb_r * tr * w_;
          v[4] = bb_g * tg * w_;
          v[5] = bb_b * tb * w_;
          v[6] = g_r * tr;
          v[7] = g_g * tg;
          v[8] = g_b * tb;
          bb_r = g_r * er + bb_r * ar * w_;
          bb_g = g_g * eg + bb_g * ag * w_;
          bb_b = g_b * eb + bb_b * ab * w_;
          --rb;
        }
        if (kPairs) {
          // each pair of lanes adds into its own slice, the even lane's
          // record before the odd lane's
          float* mine = acc + (lane >> 1) * slice;
          for (int half = 0; half < 2; ++half) {
            if (live && (lane & 1) == half) {
              for (int c = 0; c < kAdj; ++c) {
                mine[r9 + c] = mine[r9 + c] + v[c];
              }
            }
            __syncwarp();
          }
        } else {
          // the warp's lanes stage their adjoints, then lanes 0-8 add them
          if (live) {
            float* e = stage + lane * kStage;
            e[0] = __int_as_float(r9);
            for (int c = 0; c < kAdj; ++c) e[1 + c] = v[c];
          }
          const unsigned staged = __ballot_sync(kFull, live);
          __syncwarp();
          if (lane < kAdj) {
            // lane c owns column c: the staged values in lane order; a
            // run of adds to one row is summed in a register
            int row9 = -1;
            float sum = 0.0f;
            for (unsigned m = staged; m != 0u; m &= m - 1u) {
              const float* x = stage + (__ffs(m) - 1) * kStage;
              const int r = __float_as_int(x[0]);
              if (r != row9) {
                if (row9 >= 0) acc[row9 + lane] = sum;
                row9 = r;
                sum = acc[r + lane];
              }
              sum = sum + x[1 + lane];
            }
            if (row9 >= 0) acc[row9 + lane] = sum;
          }
          __syncwarp();
        }
      }
      rec.fin = 0;
      rec.ntags = 0;
      // the slices into the run's float64 row, pair by pair, every
      // kFlushSteps forward steps and at the run's end
      if (since >= kFlushSteps || !forward) {
        since = 0;
        for (int k = lane; k < slice; k += 32) {
          float sum = acc[k];
          acc[k] = 0.0f;
          for (int q = 1; q < kSlices; ++q) {
            sum = sum + acc[q * slice + k];
            acc[q * slice + k] = 0.0f;
          }
          row[k] = row[k] + static_cast<double>(sum);
        }
        __syncwarp();
      }
    }
  }
}

// K2's instance for T triangles and its shared memory, with the dynamic
// shared memory it needs allowed; or a cudaError_t.
template <class Launch>
int with_instance(int n_tris, Launch launch) {
  const bool pairs = n_tris <= kPairMaxTris;
  const int smem = shared_bytes(n_tris, pairs);
  auto kernel = pairs ? megakernel_backward<true> : megakernel_backward<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch(kernel, smem);
}

}  // namespace

// Floats of one lane's ring at max_bounces.
extern "C" int spath_megakernel_backward_ring(int max_bounces) {
  return 4 * ring_float4(max_bounces);
}

// K2's resident CTAs an SM for T triangles (its grid is sized from them;
// its shared memory grows with T), or minus a cudaError_t.
extern "C" int spath_megakernel_backward_occupancy(int n_tris) {
  int per_sm = 0;
  const int err = with_instance(n_tris, [&](auto kernel, int smem) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kBlock, smem));
  });
  return err == cudaSuccess ? per_sm : -err;
}

// n_runs: the runs (rows of partial), at most n; next_run: the queue's
// zeroed counter; grid: CTAs of 128 threads.
extern "C" int spath_megakernel_backward(
    const float* origins, const float* directions, const int64_t* seeds,
    const float* tri, const float* gbar, double* partial, float* rings,
    int* next_run, int n, int n_tris, int spp, int max_bounces, int n_runs,
    int grid, void* stream) {
  if (n < 1 || n_tris < 1 || spp < 1 || max_bounces < 0 ||
      max_bounces > kMaxBounces || n_runs < 1 || n_runs > n || grid < 1 ||
      next_run == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_instance(n_tris, [&](auto kernel, int smem) {
    kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
        origins, directions, seeds, tri, gbar, partial,
        reinterpret_cast<float4*>(rings), next_run, n, n_tris, spp,
        max_bounces, n_runs);
    return static_cast<int>(cudaGetLastError());
  });
}
