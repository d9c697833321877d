// Deterministic scatter-add of adjoint events into a (T, C) adjoint (K7),
// C = 9 (K8's normal, albedo, emission) or 19 (K10's v0, e1, e2, normal,
// albedo, emission, area), a template parameter of the two kernels that
// read the columns.
//
// Replaces the TPU routine
// spath_tpu/ops/pallas/megakernel_bigscene.py::stream_scatter_rmw (with
// zero_hbm_blocks), which the streamed backward kernels K8 and K10 run:
// a read-modify-write pass over the HBM adjoint in blocks of 256
// triangles, adding every event while its block is resident in VMEM.
// Here the same idea, in five launches on the caller's stream:
//
//   1. histogram  each of G groups of consecutive events counts its
//                 events per triangle block (256 triangles) in shared
//                 memory; hist is block-major, (n_blocks, G);
//   2. scan       one CTA turns hist into exclusive offsets and writes
//                 each block's bucket start;
//   3. order      each group writes its events' ids to their bucket, in
//                 event order (warp peers by __match_any_sync, warps in
//                 turn): a stable counting sort by block;
//   4. accumulate one CTA per (block, part of its bucket; `splits` parts,
//                 so that a hot block is shared by several CTAs) adds its
//                 events into per-warp (256, C) float64 slices in shared
//                 memory in event order (K2's scheme: lanes stage, then
//                 lanes 0 to C - 1, a column each, add in lane order), sums
//                 the slices in warp order and writes the part's partial
//                 block. Four warps a CTA at both widths (the warp count
//                 fixes the order of the sums): 78,848 bytes of shared
//                 memory at 9 columns, two CTAs an SM; 165,888 at 19, one
//                 CTA (4 warps) an SM;
//   5. combine    adj[t] += the block's partials summed in part order, in
//                 float64, rounded once to float32.
//
// Every sum runs in an order fixed by the event order and the sizes, not
// by scheduling, so two launches on the same events give the same bits;
// no float atomics (the histogram counts with integer atomics, whose
// result does not depend on their order). The sums run in float64 (the
// plain version's precision; Hopper adds float64 at half the float32
// rate): a triangle of a large scene can take 10^5 events or more, and a
// float32 running sum of that many terms drifts by ~1e-5 of its size.
//
// Bound: memory, but below it by a lot at the sizes of the main path: each
// valid event is read twice as an index (4 B) and once whole (4 C + 4 B),
// its id written and read (8 B); the partials are n_blocks * splits *
// 2 C KB. A bucket's share of a CTA is added serially per warp (~30 cycles
// an event), so a frame whose events crowd onto few blocks is bound by
// that.
//
// Layouts (checked by the Python wrapper ops/kernels/stream_scatter.py):
//   idx     int32 (E): the event's triangle, or -1 for none
//   val     float32 (E, C)
//   adj     float32 (T, C), added into in place
//   hist    int32 (n_blocks * groups); starts int32 (n_blocks + 1);
//   order   int32 (E); partial float64 (n_blocks * splits * 256 * C)
// The launches allocate nothing and do not synchronise; the entry point
// returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;         // triangles a block
constexpr int kShift = 8;          // log2(kRows)
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kAccThreads = 128;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void group_range(int64_t n_events, int64_t per,
                                            int64_t& begin, int64_t& end) {
  begin = static_cast<int64_t>(blockIdx.x) * per;
  end = begin + per < n_events ? begin + per : n_events;
}

__global__ void __launch_bounds__(kSortThreads)
    scatter_histogram(const int* __restrict__ idx, int64_t n_events,
                      int64_t per, int n_blocks, int* __restrict__ hist) {
  extern __shared__ int counts[];
  for (int k = threadIdx.x; k < n_blocks; k += kSortThreads) counts[k] = 0;
  __syncthreads();
  int64_t begin, end;
  group_range(n_events, per, begin, end);
  for (int64_t e = begin + threadIdx.x; e < end; e += kSortThreads) {
    const int t = idx[e];
    if (t >= 0) atomicAdd(&counts[t >> kShift], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_blocks; k += kSortThreads) {
    hist[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = counts[k];
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scatter_scan(int* __restrict__ hist, int m, int n_blocks, int groups,
                 int* __restrict__ starts) {
  __shared__ int sums[kScanThreads];
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int lo = min(m, threadIdx.x * per), hi = min(m, lo + per);
  int s = 0;
  for (int k = lo; k < hi; ++k) s += hist[k];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = threadIdx.x > 0 ? sums[threadIdx.x - 1] : 0;
  for (int k = lo; k < hi; ++k) {
    const int c = hist[k];
    hist[k] = run;
    run += c;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_blocks; k += kScanThreads) {
    starts[k] = hist[static_cast<int64_t>(k) * groups];
  }
  if (threadIdx.x == 0) starts[n_blocks] = sums[kScanThreads - 1];
}

__global__ void __launch_bounds__(kSortThreads)
    scatter_order(const int* __restrict__ idx, int64_t n_events, int64_t per,
                  int n_blocks, const int* __restrict__ offsets,
                  int* __restrict__ order) {
  extern __shared__ int cursor[];
  for (int k = threadIdx.x; k < n_blocks; k += kSortThreads) {
    cursor[k] = offsets[static_cast<int64_t>(k) * gridDim.x + blockIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int64_t begin, end;
  group_range(n_events, per, begin, end);
  for (int64_t base = begin; base < end; base += kSortThreads) {
    const int64_t e = base + threadIdx.x;
    const int t = e < end ? idx[e] : -1;
    const int blk = t >= 0 ? t >> kShift : -1;
    const unsigned peers = __match_any_sync(kFull, blk);
    const int leader = __ffs(peers) - 1;
    // warps in turn, so that warp w's events follow warp w - 1's
    for (int w = 0; w < kSortWarps; ++w) {
      if (warp == w) {
        int pos = 0;
        if (blk >= 0 && lane == leader) {
          pos = cursor[blk];
          cursor[blk] = pos + __popc(peers);
        }
        pos = __shfl_sync(kFull, pos, leader);
        if (blk >= 0) order[pos + __popc(peers & below)] = static_cast<int>(e);
      }
      __syncthreads();
    }
  }
}

// Dynamic shared memory of the accumulation at kAdj columns: the float64
// slices, then the float32 staging rows.
template <int kAdj>
constexpr int acc_smem() {
  return kAccWarps * kRows * kAdj * static_cast<int>(sizeof(double)) +
         kAccWarps * 32 * (kAdj + 1) * static_cast<int>(sizeof(float));
}

template <int kAdj>
__global__ void __launch_bounds__(kAccThreads)
    scatter_accumulate(const int* __restrict__ idx,
                       const float* __restrict__ val,
                       const int* __restrict__ order,
                       const int* __restrict__ starts, int splits,
                       double* __restrict__ partial) {
  constexpr int kSlice = kRows * kAdj;
  constexpr int kStage = kAdj + 1;
  extern __shared__ double slices[];
  float* stage = reinterpret_cast<float*>(slices + kAccWarps * kSlice);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x / splits, part = blockIdx.x - blk * splits;
  double* acc = slices + warp * kSlice;
  float* st = stage + warp * 32 * kStage;
  for (int k = lane; k < kSlice; k += 32) acc[k] = 0.0;
  __syncwarp();

  // this CTA's part of the bucket, and this warp's part of that
  const int64_t start = starts[blk], count = starts[blk + 1] - start;
  const int64_t lo = start + count * part / splits;
  const int64_t hi = start + count * (part + 1) / splits;
  const int64_t wlo = lo + (hi - lo) * warp / kAccWarps;
  const int64_t whi = lo + (hi - lo) * (warp + 1) / kAccWarps;
  const int first_row = blk << kShift;
  for (int64_t j = wlo; j < whi; j += 32) {
    const bool has = j + lane < whi;
    if (has) {
      const int e = order[j + lane];
      float* s = st + lane * kStage;
      s[0] = __int_as_float(idx[e] - first_row);
      const float* v = val + static_cast<int64_t>(e) * kAdj;
      for (int c = 0; c < kAdj; ++c) s[1 + c] = v[c];
    }
    const unsigned m = __ballot_sync(kFull, has);
    __syncwarp();
    if (lane < kAdj) {
      for (unsigned left = m; left != 0u; left &= left - 1u) {
        const float* s = st + (__ffs(left) - 1) * kStage;
        double* a = acc + __float_as_int(s[0]) * kAdj + lane;
        *a = *a + static_cast<double>(s[1 + lane]);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  double* out = partial + static_cast<int64_t>(blockIdx.x) * kSlice;
  for (int k = threadIdx.x; k < kSlice; k += kAccThreads) {
    double sum = slices[k];
    for (int w = 1; w < kAccWarps; ++w) sum = sum + slices[w * kSlice + k];
    out[k] = sum;
  }
}

template <int kAdj>
__global__ void scatter_combine(const double* __restrict__ partial,
                                int splits, int n_tris,
                                float* __restrict__ adj) {
  constexpr int kSlice = kRows * kAdj;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= static_cast<int64_t>(n_tris) * kAdj) return;
  const int64_t blk = k / kSlice, local = k - blk * kSlice;
  const double* p = partial + blk * splits * kSlice + local;
  double sum = static_cast<double>(adj[k]);
  for (int s = 0; s < splits; ++s) sum = sum + p[s * kSlice];
  adj[k] = static_cast<float>(sum);
}

// The accumulation and the combination at kAdj columns.
template <int kAdj>
cudaError_t accumulate(const int* idx, const float* val, float* adj,
                       int n_tris, const int* starts, const int* order,
                       double* partial, int n_blocks, int splits,
                       cudaStream_t s) {
  constexpr int smem = acc_smem<kAdj>();
  const cudaError_t attr = cudaFuncSetAttribute(
      scatter_accumulate<kAdj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  scatter_accumulate<kAdj><<<n_blocks * splits, kAccThreads, smem, s>>>(
      idx, val, order, starts, splits, partial);
  const int64_t cells = static_cast<int64_t>(n_tris) * kAdj;
  scatter_combine<kAdj><<<static_cast<int>((cells + 255) / 256), 256, 0, s>>>(
      partial, splits, n_tris, adj);
  return cudaGetLastError();
}

}  // namespace

// cols: 9 or 19.
extern "C" int spath_stream_scatter(const int* idx, const float* val,
                                    int64_t n_events, float* adj, int n_tris,
                                    int cols, int* hist, int* starts,
                                    int* order, double* partial, int groups,
                                    int splits, void* stream) {
  const int n_blocks = (n_tris + kRows - 1) / kRows;
  if (n_events < 1 || n_events >= (int64_t{1} << 31) || n_tris < 1 ||
      (cols != 9 && cols != 19) || groups < 1 || splits < 1 ||
      static_cast<int64_t>(n_blocks) * groups >= (int64_t{1} << 31) ||
      n_blocks * static_cast<int>(sizeof(int)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per = (n_events + groups - 1) / groups;
  const int sort_smem = n_blocks * static_cast<int>(sizeof(int));
  scatter_histogram<<<groups, kSortThreads, sort_smem, s>>>(idx, n_events,
                                                            per, n_blocks,
                                                            hist);
  scatter_scan<<<1, kScanThreads, 0, s>>>(hist, n_blocks * groups, n_blocks,
                                          groups, starts);
  scatter_order<<<groups, kSortThreads, sort_smem, s>>>(idx, n_events, per,
                                                        n_blocks, hist,
                                                        order);
  const cudaError_t err =
      cols == 9 ? accumulate<9>(idx, val, adj, n_tris, starts, order,
                                partial, n_blocks, splits, s)
                : accumulate<19>(idx, val, adj, n_tris, starts, order,
                                 partial, n_blocks, splits, s);
  return static_cast<int>(err);
}
