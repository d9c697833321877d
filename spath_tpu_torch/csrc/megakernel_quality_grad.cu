// Reverse sweep of the whole-frame quality path tracer (K4).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_quality_grad.py::_qbwd_kernel (launched
// there by quality_bwd_call), whose per-tile body is _bwd_tile_quality and
// per-bounce body _reverse_bounce. A lane owns a pixel, as in K3, and
// alternates two warp-wide epochs:
//   - forward: E = kMaxBounces (64) steps of quality_lanes.cuh's walk,
//     each one sweep a lane, replaying K3's walk (the same
//     source, so the same hits, draws and lights) with regeneration across
//     the pixel's samples and then its next pixels; each bounce that hit
//     appends its record to the lane's ring in global memory: only what
//     cannot be recomputed, the ray before the bounce, the hit distance
//     and index, the throughput, the two MIS weights, the light whose term
//     counted (-1 if none) and the roulette's q. The hash draws are
//     stateless and recomputed from (key, sample, bounce, draw); the
//     table's columns are read again by index. A sample that ends leaves
//     a tag (pixel, sample, bounces) for the reverse epoch.
//   - reverse: every lane runs the records of its finished samples, in
//     sample order and last bounce first within a sample, one reverse
//     bounce a step through quality_reverse.cuh (reverse_bounce, shared
//     with K10): the roulette's 1/q, the emitter term, the albedo, the NEE
//     term with its live position chain to the light and the hit point,
//     and the Moller-Trumbore distance chain to the hit triangle and the
//     ray's origin. A sample still in flight stays in the ring for the
//     next epochs; the ring holds E + max_bounces - 1 records. Each
//     lane's ring is its own contiguous run of 64-byte records (four
//     float4) and tags (one int4): lanes of a warp read and write at
//     different places of their rings, and a record read or written whole
//     by one lane fills its sectors, where local memory, interleaved word
//     by word across the warp's lanes, would take a sector a word.
// Interleaving forward and reverse bounces in one step would make the
// warp pay for both branches at each step; the epochs keep each step one
// or the other (counted against the lockstep loop, PERF.md). E is the
// most bounces a path has, so a sample's records always fit the ring. On
// an H100, of E = 8 to 64, 64 timed fastest, and the epochs beat the
// lockstep loop with the same accumulation and a CTA a chunk of rays by
// 4-5% (PERF.md).
//
// Outputs: the table adjoint, 19 columns per triangle (v0, e1, e2,
// normal, albedo, emission, area), scattered at the hit triangle (18
// columns) and at the light on the lanes whose NEE term counted (16
// columns); and per ray the camera-ray adjoint (origin, direction), summed
// over samples in sample order into grays by the lane that ran the pixel,
// with no reduction, so it is the same bits whichever lane that is.
//
// Accumulation is deterministic: no float atomics. At every step of a
// reverse epoch the lanes with a record stage their triangle, their light
// and 34 adjoints in shared memory. Up to T = 8 each pair of lanes owns a
// (T, 19) slice of shared memory (16 a warp, 57 KB a block, so that four
// blocks fit an SM), and the even lane adds its staged values into it,
// then the odd lane: the adds of a step run in parallel across pairs.
// Above, each warp owns one slice, and lanes 0-18, one per column, add
// the staged values in lane order, the surface term before the light
// term, keeping a running sum in a register while consecutive adds hit
// one row (loaded once, stored once, the same additions in the same
// order); this serial walk took 16 of K4's 51 ms at the quality headline
// against the pairs' 6 (PERF.md). After each reverse epoch the warp adds
// its slices, in order, into its own float64 row of `partial` (grid *
// warps, T * 19) and zeroes them, so a float32 sum takes one epoch's
// terms (a warp's runs of pixels add ~10^4-10^5 to a row and column), and
// the wrapper sums the rows in float64 (torch.sum, a fixed-order
// reduction) and rounds once. The warps take their pixels from a fixed
// assignment of runs (quality_lanes.cuh's PixelSource: warp w of the
// grid's W owns runs w, w + W, ...), so which pixels a warp adds, and in
// which order, is fixed by the sizes and the data: two launches with the
// same grid give the same bits. The grid is persistent, K4's resident
// CTAs (ops/kernels/megakernel_quality_grad.py). Four warp slices need
// 76 KB of shared memory at T = 256 and 304 KB at T = 1024, above the
// 227 KB a Hopper block can have, so the block has 128 threads (4 slices)
// up to T = 704 and 64 threads (2 slices, 2 warps) above.
//
// Bound: compute, as K3. The replay repeats K3's sweeps; the reverse
// sweep adds ~155 float operations per hit and ~206 more where the NEE
// term counted, the accumulation up to 34 shared-memory adds per hit.
// Rays, keys and gbar are read once; the outputs are grid * T * 19 and
// n * 6 floats.
//
// Layouts (checked by the Python wrapper
// ops/kernels/megakernel_quality_grad.py), all row-major and contiguous:
//   origins, directions, keys, tri, rows   as K3 (megakernel_quality.cu)
//   gbar                 float32 (n, 3): the cotangent of K3's output
//   partial              float64 (grid * warps, T * 19): per-warp table
//                        adjoints
//   grays                float32 (n, 6), zero: d(loss)/d(origin,
//                        direction), each sample's added in sample order
//                        (the pixels whose camera ray missed stay zero)
//   rings                float32 (grid * threads * R * 20): each lane's
//                        ring, R = kMaxBounces + max_bounces - 1
//                        records of 16 floats, then R tags of 4 ints
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_lanes.cuh"
#include "quality_walk.cuh"
#include "quality_reverse.cuh"

namespace {

using spath::Bounce;
using spath::LaneWalk;
using spath::PixelSource;
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
// Forward steps an epoch (E): at least any path's bounces.
constexpr int kEpoch = kMaxBounces;
// Shared memory a Hopper block may use.
constexpr int kMaxShared = 232448;

// Accumulators of a warp: one (T, 19) slice (kPairs false), or one a pair
// of lanes, 16 slices (kPairs true), where that fits four CTAs of 128
// threads an SM (kPairMaxBytes); then the stage, 36 floats a lane.
constexpr int kPairMaxBytes = 57344;

__host__ __device__ int shared_bytes(int n_tris, int warps, bool pairs) {
  return static_cast<int>(sizeof(float)) * warps *
         ((pairs ? 16 : 1) * n_tris * kAdj + 32 * kStage);
}

bool use_pairs(int n_tris) {
  return shared_bytes(n_tris, 4, true) <= kPairMaxBytes;
}

int block_threads(int n_tris) {
  return shared_bytes(n_tris, 4, false) <= kMaxShared ? 128 : 64;
}

// A lane's ring in global memory (kRecord float4 a record, then one a
// finished sample's tag: pixel, sample, bounces).
constexpr int kRecord = 4;

__device__ __forceinline__ void put(float4* r, const Bounce& b) {
  r[0] = make_float4(b.ox, b.oy, b.oz, b.dx);
  r[1] = make_float4(b.dy, b.dz, b.dist, __int_as_float(b.idx));
  r[2] = make_float4(b.tr, b.tg, b.tb, b.w_b);
  r[3] = make_float4(b.misw, __int_as_float(b.li), b.rrq, 0.0f);
}

__device__ __forceinline__ Bounce get(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  return Bounce{a.x, a.y, a.z, a.w, b.x, b.y, b.z, __float_as_int(b.w),
                c.x, c.y, c.z, c.w, d.x, __float_as_int(d.y), d.z};
}

// K4's forward lane hooks: each bounce's record to the ring, each finished
// sample's tag.
struct RecordLane {
  float4* ring;  // size records, then size tags
  int size;      // records the ring holds
  int head;      // where the next record goes
  int ntags;
  int fin;  // records of finished samples not yet reversed

  __device__ __forceinline__ void take(const QualityArgs&, const LaneWalk&) {}
  __device__ __forceinline__ void end(const QualityArgs& a, int occ,
                                      LaneWalk& w) {
    spath::bounce_end(a, w.b, occ, w.p, w.x, spath::NoSave{});
    put(ring + kRecord * head, w.x.st);
    head = head + 1 == size ? 0 : head + 1;
  }
  __device__ __forceinline__ void sample(const QualityArgs&,
                                         const LaneWalk& w) {
    if (w.b > 0) {
      reinterpret_cast<int4*>(ring + kRecord * size)[ntags++] =
          make_int4(w.pix, w.s, w.b, 0);
      fin += w.b;
    }
  }
  __device__ __forceinline__ void pixel(const QualityArgs&, const LaneWalk&) {}
  // Wait before a sample until the ring has room for all its bounces.
  __device__ __forceinline__ bool pause(const QualityArgs& a) const {
    return fin + a.max_bounces > size;
  }
};

// At most 128 registers a thread: 4 resident CTAs an SM (PERF.md).
template <bool kPairs>
__global__ void __launch_bounds__(128, 4)
    quality_backward(const float* __restrict__ origins,
                     const float* __restrict__ directions,
                     const int64_t* __restrict__ keys,
                     const float* __restrict__ gbar,
                     double* __restrict__ partial,
                     float* __restrict__ grays,
                     float4* __restrict__ rings, int n, int run,
                     QualityArgs a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slice = a.n_tris * kAdj;
  constexpr int kSlices = kPairs ? 16 : 1;
  float* acc = smem + warp * kSlices * slice;
  float* stage = smem + warps * kSlices * slice + warp * 32 * kStage;
  double* row = partial + (static_cast<size_t>(blockIdx.x) * warps + warp) *
                              static_cast<size_t>(slice);
  for (int k = lane; k < kSlices * slice; k += 32) acc[k] = 0.0f;
  for (int k = lane; k < slice; k += 32) row[k] = 0.0;
  __syncwarp();

  const int size = kEpoch + a.max_bounces - 1;
  RecordLane rec{rings + static_cast<size_t>(blockIdx.x * blockDim.x +
                                             threadIdx.x) *
                             (kRecord + 1) * size,
                 size, 0, 0, 0};
  PixelSource src{nullptr, n, run,
                  static_cast<int>(blockIdx.x) * warps + warp,
                  static_cast<int>(gridDim.x) * warps, 0};
  LaneWalk w;
  w.init();
  const spath::TableQuality be = spath::table_quality(a);

  int tail = 0;  // the ring's oldest record not yet reversed

  bool forward = true;
  while (forward) {
    // ---- forward epoch: K3's walk, recording ----
    for (int e = 0; e < kEpoch; ++e) {
      if (!w.step(a, be, src, origins, directions, keys, rec)) {
        forward = false;
        break;
      }
    }

    // ---- reverse epoch: the finished samples, one bounce a step ----
    // The sample being reversed: its pixel, sample, first record and
    // bounce (rb < 0 between samples; every epoch ends between samples,
    // so none of this lives through a forward epoch).
    int t = 0, rpix = 0, rs = 0, rfirst = 0, rb = -1;
    uint32_t rh1 = 0u;
    float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
    float tb_r = 0.0f, tb_g = 0.0f, tb_b = 0.0f;  // thr-bar after bounce rb
    float ob_x = 0.0f, ob_y = 0.0f, ob_z = 0.0f;  // o-bar of bounce rb + 1
    const int depth = __reduce_max_sync(kFull, rec.fin);
    for (int k = 0; k < depth; ++k) {
      const bool live = k < rec.fin;
      float* e = stage + lane * kStage;
      if (live) {
        if (rb < 0) {
          const int4 tg =
              reinterpret_cast<const int4*>(rec.ring + kRecord * size)[t++];
          rpix = tg.x;
          rs = tg.y;
          rb = tg.z - 1;
          rfirst = tail;
          tail = tail + tg.z >= size ? tail + tg.z - size : tail + tg.z;
          rh1 = spath::fmix(static_cast<uint32_t>(keys[rpix]));
          g_r = gbar[3 * rpix + 0] * a.inv_spp;
          g_g = gbar[3 * rpix + 1] * a.inv_spp;
          g_b = gbar[3 * rpix + 2] * a.inv_spp;
          tb_r = tb_g = tb_b = 0.0f;
          ob_x = ob_y = ob_z = 0.0f;
        }
        const int at = rfirst + rb >= size ? rfirst + rb - size
                                           : rfirst + rb;
        const Bounce B = get(rec.ring + kRecord * at);
        spath::ReverseOut ro;
        const int li = spath::reverse_bounce(
            a, rh1, static_cast<uint32_t>(rs) * spath::kC1, rb, B, g_r, g_g,
            g_b, tb_r, tb_g, tb_b, ob_x, ob_y, ob_z, e + 2, e + 2 + kSurf,
            ro);
        e[0] = __int_as_float(B.idx);
        e[1] = __int_as_float(li);
        // the origin's adjoint goes to the bounce before, or at bounce 0
        // to the camera ray with the direction's: summed over the pixel's
        // samples in sample order, in grays (zeroed by the wrapper)
        if (rb == 0) {
          float* gr = grays + 6 * rpix;
          gr[0] = gr[0] + ro.on_x;
          gr[1] = gr[1] + ro.on_y;
          gr[2] = gr[2] + ro.on_z;
          gr[3] = gr[3] + ro.gd_x;
          gr[4] = gr[4] + ro.gd_y;
          gr[5] = gr[5] + ro.gd_z;
        } else {
          ob_x = ro.on_x;
          ob_y = ro.on_y;
          ob_z = ro.on_z;
        }
        --rb;
      }
      const unsigned staged = __ballot_sync(kFull, live);
      __syncwarp();
      if (kPairs) {
        // each pair of lanes adds into its own slice, the even lane's
        // record before the odd lane's: surface, then the light's
        float* mine = acc + (lane >> 1) * slice;
        for (int half = 0; half < 2; ++half) {
          if (live && (lane & 1) == half) {
            const int r = __float_as_int(e[0]) * kAdj;
            for (int c = 0; c < kSurf; ++c) {
              mine[r + c] = mine[r + c] + e[2 + c];
            }
            const int lrow = __float_as_int(e[1]);
            if (lrow >= 0) {
              const int l = lrow * kAdj;
              for (int c = 0; c < 12; ++c) {
                mine[l + c] = mine[l + c] + e[2 + kSurf + c];
              }
              for (int c = 15; c < kAdj; ++c) {
                mine[l + c] = mine[l + c] + e[2 + kSurf + c - 3];
              }
            }
          }
          __syncwarp();
        }
      } else if (lane < kAdj) {
        // lane c owns column c: surface adds, then the light's, in lane
        // order; a run of adds to one row is summed in a register
        const int lcol = lane < 12 ? lane : (lane >= 15 ? lane - 3 : -1);
        int row = -1;
        float sum = 0.0f;
        for (unsigned m = staged; m != 0u; m &= m - 1u) {
          const float* x = stage + (__ffs(m) - 1) * kStage;
          if (lane < kSurf) {
            const int r = __float_as_int(x[0]);
            if (r != row) {
              if (row >= 0) acc[row * kAdj + lane] = sum;
              row = r;
              sum = acc[r * kAdj + lane];
            }
            sum = sum + x[2 + lane];
          }
          const int lrow = __float_as_int(x[1]);
          if (lrow >= 0 && lcol >= 0) {
            if (lrow != row) {
              if (row >= 0) acc[row * kAdj + lane] = sum;
              row = lrow;
              sum = acc[lrow * kAdj + lane];
            }
            sum = sum + x[2 + kSurf + lcol];
          }
        }
        if (row >= 0) acc[row * kAdj + lane] = sum;
      }
      __syncwarp();
    }
    rec.fin = 0;
    rec.ntags = 0;
    // the epoch's slices into the warp's float64 row, pair by pair
    if (depth > 0) {
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

}  // namespace

// Threads of K4's block for T triangles (its warp slices' shared memory).
extern "C" int spath_quality_backward_threads(int n_tris) {
  return block_threads(n_tris);
}

// K4's instance for T triangles, its threads and shared memory, with the
// dynamic shared memory it needs allowed; or a cudaError_t.
template <class Launch>
int with_instance(int n_tris, Launch launch) {
  const int threads = block_threads(n_tris);
  const bool pairs = use_pairs(n_tris);
  const int smem = shared_bytes(n_tris, threads / 32, pairs);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pairs ? quality_backward<true> : quality_backward<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch(kernel, threads, smem);
}

// K4's resident CTAs an SM for T triangles (its grid is sized from them),
// or minus a cudaError_t.
extern "C" int spath_quality_backward_occupancy(int n_tris) {
  int per_sm = 0;
  const int err = with_instance(n_tris, [&](auto kernel, int threads,
                                            int smem) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem));
  });
  return err == cudaSuccess ? per_sm : -err;
}

// flags: as spath::make_args takes them. run: pixels a run of the fixed
// assignment; grid: CTAs of spath_quality_backward_threads(n_tris).
extern "C" int spath_quality_backward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* gbar, double* partial,
    float* grays, float* rings, int n, int n_tris, int n_rows, int spp,
    int max_bounces, int rr_start, int flags, float inv_spp, int run,
    int grid, void* stream) {
  if (n < 1 || n_tris < 1 || n_rows < 0 || spp < 1 || max_bounces < 0 ||
      max_bounces > kMaxBounces || rr_start < 0 || run < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  return with_instance(n_tris, [&](auto kernel, int threads, int smem) {
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        origins, directions, keys, gbar, partial, grays,
        reinterpret_cast<float4*>(rings), n, run, a);
    return static_cast<int>(cudaGetLastError());
  });
}
