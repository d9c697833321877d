// Deterministic scatter-add of adjoint events into a (T, C) adjoint (K7),
// C = 9 (K8's normal, albedo, emission) or 19 (K10's v0, e1, e2, normal,
// albedo, emission, area), a template parameter of the kernel that reads
// the columns.
//
// Replaces the TPU routine
// spath_tpu/ops/pallas/megakernel_bigscene.py::stream_scatter_rmw (with
// zero_hbm_blocks), which the streamed backward kernels K8 and K10 run:
// a read-modify-write pass over the HBM adjoint in blocks of 256
// triangles, adding every event while its block is resident in VMEM.
// Here the same idea, in two launches on the caller's stream:
//
//   1. bin         a persistent grid; each CTA takes units of kUnit
//                  consecutive event slots in turn, copying the next
//                  unit's indices in (cp.async) while it sorts the
//                  current one, so each index is read once, coalesced.
//                  It sorts the unit's valid events stably by triangle
//                  block (256 triangles) into the unit's own section of
//                  `order`: warp peers by __match_any_sync, running counts
//                  per warp, the warps' counts then scanned per block. It
//                  writes how many events of each block the unit holds
//                  and where they start (block-major tables, so no global
//                  scan is needed) and packs each event as its row in the
//                  block and its slot in the unit;
//   2. accumulate  one CTA per (block, part): a block's events in event
//                  order (the units in order, each unit's section of the
//                  block) are cut into `splits` parts of equal count. The
//                  CTA walks its part in windows of 1024 events (512 at
//                  19 columns), sorts each window stably by row (as the
//                  bin sorts by block), loads the window's values into
//                  shared memory in that order with every lane (all loads
//                  in flight), and then each (row, column) of the block,
//                  a task of its own thread, adds the row's run into a
//                  float64 register (four interleaved sums over the run's
//                  positions, then a fixed tree): no serial chain through
//                  global memory, no per-warp slices. The last CTA of a
//                  block to finish (an integer counter) adds the parts'
//                  sums into the adjoint in part order.
//
// Every sum runs in an order fixed by the event order and the sizes, not
// by scheduling, so two launches on the same events give the same bits;
// no float atomics (integer atomics only count). The sums run in float64
// (the plain version's precision; Hopper adds float64 at half the float32
// rate): a triangle of a large scene can take 10^5 events or more, and a
// float32 running sum of that many terms drifts by ~1e-5 of its size.
//
// Bound: memory in principle: each slot's index is read once (4 B), each
// valid event's values once (4 C B, gathered by id, so two or three
// 32-byte sectors) and its packed id written and read (8 B); the tables
// are 8 B per block a unit, the parts' sums 8 C B per row a part, and
// the adjoint is read and written once. In practice the accumulation is
// bound by its instructions (the window's search, ranks and sort, ~30
// cycles of CTA time an event on an H100): with its gather served from
// L2 instead of memory it took 8% less time. A row hit by many events of
// one window is added by its kAdj threads alone, so events crowding onto
// few rows lengthen that window.
//
// Layouts (checked by the Python wrapper ops/kernels/stream_scatter.py):
//   idx      int32 (E): the event's triangle, or -1 for none
//   val      float32 (E, C)
//   adj      float32 (T, C), added into in place
//   order    int32 (E); counts, starts int32 (n_blocks * units);
//   partial  float64 (n_blocks * splits * 256 * C) (unused if splits is
//            1); arrive int32 (n_blocks), zeroed by the bin launch
// The launches allocate nothing and do not synchronise; the entry point
// returns a cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;         // triangles a block
constexpr int kShift = 8;          // log2(kRows)
constexpr int kUnit = 4096;        // slots a unit of the bin
constexpr int kUnitShift = 12;     // log2(kUnit)
constexpr int kThreads = 256;      // both kernels; = kRows
constexpr int kWarps = kThreads / 32;
constexpr int kBinPerLane = kUnit / kThreads;
constexpr int kMaxWindow = 1024;   // events a window of the accumulation
constexpr int kMaxChunks = 2048;   // chunks of kThreads units, E < 2^31
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == kRows, "thread r owns row r");

// Exclusive prefix of v over the CTA's threads in thread order, and the
// total in *total; uses warp_sums (kWarps ints) and synchronises.
__device__ __forceinline__ int cta_exclusive_scan(int v, int* warp_sums,
                                                  int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  __syncthreads();
  return before + inc - v;
}

// Exclusive scan of a[0..m) in place over the CTA (each thread a run of
// consecutive entries); a[m] gets the total. Synchronises.
__device__ __forceinline__ void cta_scan_array(int* a, int m,
                                               int* warp_sums) {
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(m, static_cast<int>(threadIdx.x) * per);
  const int hi = min(m, lo + per);
  int s = 0;
  for (int k = lo; k < hi; ++k) s += a[k];
  int total;
  int run = cta_exclusive_scan(s, warp_sums, &total);
  for (int k = lo; k < hi; ++k) {
    const int c = a[k];
    a[k] = run;
    run += c;
  }
  if (threadIdx.x == 0) a[m] = total;
  __syncthreads();
}

// Events a window of the accumulation at kAdj columns: its values take
// 36,864 (9) or 38,912 (19) bytes of dynamic shared memory.
__host__ __device__ constexpr int acc_window(int cols) {
  return cols <= 9 ? kMaxWindow : kMaxWindow / 2;
}

// Dynamic shared memory of the bin: two buffers of a unit's indices,
// the warps' running counts per block, then the unit's counts per block
// and its total.
__host__ __device__ constexpr int bin_smem(int n_blocks) {
  return (2 * kUnit + kWarps * n_blocks + n_blocks + 1) *
         static_cast<int>(sizeof(int));
}

// Start the copies of unit u's indices into buf (cp.async: 16 bytes a
// copy where the unit is whole and idx 16-byte aligned, else 4), -1 past
// the last event, as one commit group.
__device__ __forceinline__ void stage_unit(int* buf,
                                           const int* __restrict__ idx,
                                           int64_t n_events, int u) {
  const int64_t begin = static_cast<int64_t>(u) << kUnitShift;
  if (begin + kUnit <= n_events &&
      (reinterpret_cast<uintptr_t>(idx) & 15u) == 0u) {
    for (int k = threadIdx.x; k < kUnit / 4; k += kThreads) {
      __pipeline_memcpy_async(buf + 4 * k, idx + begin + 4 * k, 16);
    }
  } else {
    for (int k = threadIdx.x; k < kUnit; k += kThreads) {
      if (begin + k < n_events) {
        __pipeline_memcpy_async(buf + k, idx + begin + k, sizeof(int));
      } else {
        buf[k] = -1;
      }
    }
  }
  __pipeline_commit();
}

// A persistent grid: each CTA bins units blockIdx.x, + gridDim.x, ...,
// the next unit's indices copied in while it sorts the current one.
__global__ void __launch_bounds__(kThreads)
    scatter_bin(const int* __restrict__ idx, int64_t n_events, int n_blocks,
                int units, int* __restrict__ order,
                int* __restrict__ counts, int* __restrict__ starts,
                int* __restrict__ arrive) {
  extern __shared__ __align__(16) int smem[];
  int* bufs = smem;                       // two units' indices
  int* wcnt = smem + 2 * kUnit;           // [warp][block]
  int* tot = wcnt + kWarps * n_blocks;    // [block], then the total
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < n_blocks; k += kThreads) arrive[k] = 0;
  }
  for (int k = threadIdx.x; k < kWarps * n_blocks; k += kThreads) {
    wcnt[k] = 0;
  }
  int* mine = wcnt + warp * n_blocks;
  if (blockIdx.x < units) stage_unit(bufs, idx, n_events, blockIdx.x);
  for (int unit = blockIdx.x, it = 0; unit < units;
       unit += gridDim.x, ++it) {
    const int* keys = bufs + (it & 1) * kUnit;
    const int next = unit + gridDim.x;
    if (next < units) {
      stage_unit(bufs + ((it + 1) & 1) * kUnit, idx, n_events, next);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();

    // Warp w sorts slots [w * kUnit / kWarps, (w + 1) * kUnit / kWarps)
    // of the unit, 32 at a time in slot order: rank = the warp's running
    // count of the block + the lane's peers below it.
    int rank[kBinPerLane];
#pragma unroll
    for (int j = 0; j < kBinPerLane; ++j) {
      const int t = keys[warp * (kUnit / kWarps) + j * 32 + lane];
      const int blk = t >= 0 ? t >> kShift : -1;
      rank[j] = 0;
      if (__ballot_sync(kFull, blk >= 0) == 0u) continue;  // no event here
      const unsigned peers = __match_any_sync(kFull, blk);
      const int leader = __ffs(peers) - 1;
      int run = 0;
      if (blk >= 0 && lane == leader) {
        run = mine[blk];
        mine[blk] = run + __popc(peers);
      }
      rank[j] = __shfl_sync(kFull, run, leader) + __popc(peers & below);
      __syncwarp();
    }
    __syncthreads();

    // Per block: the warps' exclusive prefix, and the unit's count.
    for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcnt[w * n_blocks + b];
        wcnt[w * n_blocks + b] = s;
        s += c;
      }
      tot[b] = s;
    }
    __syncthreads();
    cta_scan_array(tot, n_blocks, warp_sums);
    for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
      const int64_t k = static_cast<int64_t>(b) * units + unit;
      counts[k] = tot[b + 1] - tot[b];
      starts[k] = tot[b];
    }
    for (int k = threadIdx.x; k < kWarps * n_blocks; k += kThreads) {
      wcnt[k] += tot[k % n_blocks];
    }
    __syncthreads();

    const int64_t unit_begin = static_cast<int64_t>(unit) << kUnitShift;
#pragma unroll
    for (int j = 0; j < kBinPerLane; ++j) {
      const int local = warp * (kUnit / kWarps) + j * 32 + lane;
      const int t = keys[local];
      if (t >= 0) {
        order[unit_begin + mine[t >> kShift] + rank[j]] =
            ((t & (kRows - 1)) << kUnitShift) | local;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kWarps * n_blocks; k += kThreads) {
      wcnt[k] = 0;
    }
  }
}

// CTAs of the accumulation resident on an SM: its shared memory allows 3,
// which bounds the registers to 85 (the float64 sums take 2 kAdj).
constexpr int kAccCtas = 3;

template <int kAdj>
__global__ void __launch_bounds__(kThreads, kAccCtas)
    scatter_accumulate(const float* __restrict__ val,
                       const int* __restrict__ order,
                       const int* __restrict__ counts,
                       const int* __restrict__ starts, int units, int n_tris,
                       int splits, double* __restrict__ partial,
                       int* __restrict__ arrive, float* __restrict__ adj) {
  __shared__ int chunk_events[kMaxChunks];  // the block's events a chunk
  __shared__ int unit_pre[kThreads];        // a chunk's units: prefix
  __shared__ int unit_src[kThreads];        //   and section in `order`
  __shared__ int wcnt[kWarps][kRows];       // a window's counts by row
  __shared__ int run_start[kRows + 1];      // a window's rows, sorted
  __shared__ int sorted[kMaxWindow];        // a window's event ids
  extern __shared__ float vals[];           // its values, sorted
  constexpr int kWindow = acc_window(kAdj);
  constexpr int kWinPerLane = kWindow / kThreads;
  __shared__ int warp_sums[kWarps];
  __shared__ long long range[2];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int blk = blockIdx.x / splits, part = blockIdx.x - blk * splits;
  const int* cnt = counts + static_cast<int64_t>(blk) * units;
  const int* src = starts + static_cast<int64_t>(blk) * units;
  const int n_chunks = (units + kThreads - 1) / kThreads;

  // The block's events in each chunk of units, and this part's range.
  for (int c = warp; c < n_chunks; c += kWarps) {
    int s = 0;
    for (int k = lane; k < kThreads; k += 32) {
      const int u = c * kThreads + k;
      s += u < units ? cnt[u] : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) chunk_events[c] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int c = 0; c < n_chunks; ++c) total += chunk_events[c];
    range[0] = total * part / splits;
    range[1] = total * (part + 1) / splits;
  }
  __syncthreads();
  const long long lo = range[0], hi = range[1];
  // acc[i]: this thread's task i, entry threadIdx.x + i * kThreads of the
  // block's (kRows, kAdj) adjoint, in float64.
  double acc[kAdj];
#pragma unroll
  for (int c = 0; c < kAdj; ++c) acc[c] = 0.0;
  long long base = 0;  // the block's events before chunk c
  for (int c = 0; c < n_chunks && base < hi; ++c) {
    const int in_chunk = chunk_events[c];
    if (base + in_chunk <= lo) {
      base += in_chunk;
      continue;
    }
    const int u = c * kThreads + threadIdx.x;
    const int n_u = u < units ? cnt[u] : 0;
    int total;
    unit_pre[threadIdx.x] = cta_exclusive_scan(n_u, warp_sums, &total);
    unit_src[threadIdx.x] = u < units ? (u << kUnitShift) + src[u] : 0;
    __syncthreads();
    const int a = static_cast<int>((lo > base ? lo : base) - base);
    const int z = static_cast<int>(
        (hi < base + in_chunk ? hi : base + in_chunk) - base);
    for (int w0 = a; w0 < z; w0 += kWindow) {
      const int n_w = min(kWindow, z - w0);
      for (int k = threadIdx.x; k < kWarps * kRows; k += kThreads) {
        (&wcnt[0][0])[k] = 0;
      }
      __syncthreads();
      // Warp w stages window positions [w * kWindow / kWarps, ...) in
      // order: each position's unit by binary search over the chunk's
      // prefix, then its code (row in the block, slot in the unit) from
      // `order`, every load in flight at once.
      int row[kWinPerLane], id[kWinPerLane], rank[kWinPerLane];
      int code[kWinPerLane];
#pragma unroll
      for (int j = 0; j < kWinPerLane; ++j) {
        const int k = warp * (kWindow / kWarps) + j * 32 + lane;
        id[j] = -1;
        code[j] = 0;
        if (k < n_w) {
          const int pos = w0 + k;
          int l = 0, h = kThreads;  // the last unit starting at or before pos
#pragma unroll
          for (int step = 0; step < 8; ++step) {  // log2(kThreads)
            const int m = (l + h) >> 1;
            if (unit_pre[m] <= pos) l = m; else h = m;
          }
          code[j] = order[unit_src[l] + pos - unit_pre[l]];
          id[j] = c * kThreads + l;
        }
      }
      // rank = the warp's running count of the row + the lane's peers
      // below it: the sort by row is stable.
#pragma unroll
      for (int j = 0; j < kWinPerLane; ++j) {
        row[j] = -1;
        if (id[j] >= 0) {
          row[j] = code[j] >> kUnitShift;
          id[j] = (id[j] << kUnitShift) | (code[j] & (kUnit - 1));
        }
        const unsigned peers = __match_any_sync(kFull, row[j]);
        const int leader = __ffs(peers) - 1;
        int run = 0;
        if (row[j] >= 0 && lane == leader) {
          run = wcnt[warp][row[j]];
          wcnt[warp][row[j]] = run + __popc(peers);
        }
        rank[j] = __shfl_sync(kFull, run, leader) + __popc(peers & below);
        __syncwarp();
      }
      __syncthreads();
      // Row t (thread t): the warps' prefix, then the rows' starts.
      const int t = threadIdx.x;
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = wcnt[w][t];
        wcnt[w][t] = s;
        s += cw;
      }
      int in_window;
      const int start = cta_exclusive_scan(s, warp_sums, &in_window);
      run_start[t] = start;
      if (t == 0) run_start[kRows] = in_window;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) wcnt[w][t] += start;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWinPerLane; ++j) {
        if (row[j] >= 0) sorted[wcnt[warp][row[j]] + rank[j]] = id[j];
      }
      __syncthreads();
      // The window's values in sorted order, every lane copying (cp.async,
      // no registers): an event's columns from neighbouring lanes, every
      // copy in flight at once.
      for (int k = threadIdx.x; k < n_w * kAdj; k += kThreads) {
        const int p = k / kAdj;
        __pipeline_memcpy_async(
            vals + k, val + static_cast<int64_t>(sorted[p]) * kAdj +
                          (k - p * kAdj), sizeof(float));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      // Task (row, column) adds the row's run of the window; a row's kAdj
      // columns are kAdj neighbouring threads. Four float64 sums over the
      // run's positions modulo 4, then added in a fixed tree: the order is
      // fixed by the run, and the four chains overlap.
#pragma unroll
      for (int i = 0; i < kAdj; ++i) {
        const int task = threadIdx.x + i * kThreads;
        const int r = task / kAdj, col = task - r * kAdj;
        const int begin = run_start[r], end = run_start[r + 1];
        if (begin == end) continue;
        double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
        int p = begin;
        for (; p + 3 < end; p += 4) {
          s0 = s0 + static_cast<double>(vals[p * kAdj + col]);
          s1 = s1 + static_cast<double>(vals[(p + 1) * kAdj + col]);
          s2 = s2 + static_cast<double>(vals[(p + 2) * kAdj + col]);
          s3 = s3 + static_cast<double>(vals[(p + 3) * kAdj + col]);
        }
        if (p < end) s0 = s0 + static_cast<double>(vals[p * kAdj + col]);
        if (p + 1 < end) {
          s1 = s1 + static_cast<double>(vals[(p + 1) * kAdj + col]);
        }
        if (p + 2 < end) {
          s2 = s2 + static_cast<double>(vals[(p + 2) * kAdj + col]);
        }
        acc[i] = acc[i] + ((s0 + s1) + (s2 + s3));
      }
      __syncthreads();
    }
    base += in_chunk;
    __syncthreads();
  }

  // Task (row, column) k of the block is adj's entry blk * 256 * kAdj + k.
  float* out = adj + static_cast<int64_t>(blk) * kRows * kAdj;
  const int cells = min(kRows, n_tris - blk * kRows) * kAdj;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < kAdj; ++i) {
      const int k = threadIdx.x + i * kThreads;
      if (k < cells) {
        out[k] = static_cast<float>(static_cast<double>(out[k]) + acc[i]);
      }
    }
    return;
  }
  // The parts' sums, then the block's last CTA adds them in part order.
  double* mine = partial + static_cast<int64_t>(blockIdx.x) * kRows * kAdj;
#pragma unroll
  for (int i = 0; i < kAdj; ++i) mine[threadIdx.x + i * kThreads] = acc[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&arrive[blk], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* parts = partial + static_cast<int64_t>(blk) * splits *
                                      kRows * kAdj;
#pragma unroll
  for (int i = 0; i < kAdj; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k >= cells) continue;
    double sum = static_cast<double>(out[k]);
    for (int p = 0; p < splits; ++p) {
      sum = sum + __ldcg(parts + static_cast<int64_t>(p) * kRows * kAdj + k);
    }
    out[k] = static_cast<float>(sum);
  }
}

template <int kAdj>
cudaError_t accumulate(const float* val, const int* order, const int* counts,
                       const int* starts, int units, int n_tris, int n_blocks,
                       int splits, double* partial, int* arrive, float* adj,
                       cudaStream_t s) {
  constexpr int smem = acc_window(kAdj) * kAdj * sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      scatter_accumulate<kAdj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  scatter_accumulate<kAdj><<<n_blocks * splits, kThreads, smem, s>>>(
      val, order, counts, starts, units, n_tris, splits, partial, arrive,
      adj);
  return cudaGetLastError();
}

}  // namespace

// cols: 9 or 19; units = ceil(E / 4096).
extern "C" int spath_stream_scatter(const int* idx, const float* val,
                                    int64_t n_events, float* adj, int n_tris,
                                    int cols, int* order, int* counts,
                                    int* starts, double* partial,
                                    int* arrive, int units, int splits,
                                    void* stream) {
  const int n_blocks = (n_tris + kRows - 1) / kRows;
  if (n_events < 1 || n_events >= (int64_t{1} << 31) || n_tris < 1 ||
      n_tris > (1 << 20) || (cols != 9 && cols != 19) || splits < 1 ||
      units != static_cast<int>((n_events + kUnit - 1) / kUnit) ||
      units > kMaxChunks * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = bin_smem(n_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_bin, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_bin,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = max(1, min(units, per_sm * sms));
  scatter_bin<<<grid, kThreads, smem, s>>>(idx, n_events, n_blocks, units,
                                           order, counts, starts, arrive);
  err = cols == 9 ? accumulate<9>(val, order, counts, starts, units, n_tris,
                                   n_blocks, splits, partial, arrive, adj, s)
                   : accumulate<19>(val, order, counts, starts, units,
                                    n_tris, n_blocks, splits, partial,
                                    arrive, adj, s);
  return static_cast<int>(err);
}
