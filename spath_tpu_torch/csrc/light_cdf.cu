// The light choice's distribution on the card: the prob and cdf columns
// of the quality table that K3 and K4 read (megakernel_quality.py's
// quality_table), so that a CUDA scene's table is built without a trip
// through the host.
//
// The JAX package builds these columns with XLA, not with a Pallas kernel
// (spath_tpu/ops/nee.py::light_cdf, called by
// spath_tpu/ops/pallas/megakernel_quality.py::quality_table). The choice
// they feed is discrete: a last-bit difference in the cdf picks another
// light. So this kernel computes in the order of operations of the plain
// version (ops/kernels/light_cdf.py::light_cdf_plain), which is XLA's on
// the CPU:
//
//   w_i   = ((e_i.r + e_i.g) + e_i.b) * area_i
//   total = XLA's CPU reduction of w: windows of 32 (the level zero-padded
//           to whole windows, half the padding, rounded down, in front),
//           each summed in order from 0, level by level until at most 32
//           values remain, which are summed in order from 0 (the
//           reduce-window ops of jnp.sum's HLO)
//   prob  = w / total
//   cdf   = XLA's CPU scan of prob: sequential within blocks of 16
//           (zero-padded at the end), the block totals scanned the same way
//           (recursively, one level each), then the scanned total of the
//           block before added to each block, +0 to the first
//
// and, for an all-dark scene (total not > 0), prob 0 and cdf_i =
// (i + 1) / T. Built with -fmad=false and IEEE division, so every add,
// multiply and divide rounds as the plain version's does. Both trees are
// fixed, so any schedule that evaluates their nodes with the same operands
// in the same order gives the same bits; no chain of dependent adds is
// longer than 32, and no float atomic is used.
//
// The work is ~7 T float operations and 24 T bytes: the bound is the
// memory's rate. A small table is bound by the chains and the launch.
//
// The one-CTA route (grid = 0, T <= kCtaMaxTris): one launch of one block
// (a thread a block of 16, at most kCtaThreads), every level in shared
// memory: the weights, the total's windows (a thread a window), the
// probabilities, the scan's blocks (a thread a block) down and up.
//
// The grid route (grid = 1, kChunk < T <= kMaxTris, 2^20, the streamed
// kernels' cap), three launches, each level's nodes spread over blocks:
//   windows: a block per window of the total's second level (1024
//            weights): the weights (also to scratch), its 32 windows of 32,
//            their sum
//   prob:    a block per chunk of kChunk = 16^3 probabilities: every block
//            sums the total from the windows' sums (at most 1024 values,
//            two levels); prob; the chunk's blocks of 16 and of 16^2 summed
//            (its 16 level-2 values and its level-3 value to scratch)
//   scan:    a block per chunk: the chunk's scan levels 0 and 1 down, in
//            shared memory; the scanned values it needs from above (level
//            2's at the end of the chunk before and in its own, level 3's
//            and 4's) from the prob pass's values; the up-sweep into cdf.
// The levels above a block's share are summed again by every block that
// needs them (at most 1024 values), so no block waits for another and no
// counter is needed. Which route a call takes is the caller's choice
// (light_cdf.py's SHARED_TRIS, measured on the card).
//
// Layouts, all contiguous: emission float32 (T, 3), area float32 (T), cdf
// and prob float32 (T) out, scratch float32 (spath_light_cdf_scratch(T,
// grid)) or null on the one-CTA route. The launches go on the caller's
// stream, allocate nothing and do not synchronise; the entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;              // the total's windows
constexpr int kBlk = 16;              // the scan's blocks
constexpr int kCtaThreads = 512;      // the one-CTA route's block
constexpr int kCtaMaxTris = 10240;    // its largest table (< 48 KB)
constexpr int kThreads = 256;         // the grid route's blocks
constexpr int kWinTris = kWin * kWin; // weights a windows block
constexpr int kChunk = kBlk * kBlk * kBlk;  // probabilities a scan block
constexpr int kPer = kChunk / kThreads;     // ... a thread
constexpr int kMaxTris = 1 << 20;
constexpr int kMaxLevels = 6;  // 16^5 >= kMaxTris

long long g_launches = 0;  // kernels launched, for the caller's count

// Shared-memory index of value i of a level: one float of padding every
// 32, so that the threads of a warp, each walking its own window of 32 or
// block of 16, read 32 banks.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5) + 1; }

__device__ __forceinline__ float weight(const float* __restrict__ emission,
                                        const float* __restrict__ area,
                                        int i) {
  return ((emission[3 * i + 0] + emission[3 * i + 1]) + emission[3 * i + 2]) *
         area[i];
}

// Window k of a level of n values (x padded), in order from 0; the window
// covers [32 k - lo, 32 k - lo + 32), zeros outside [0, n).
__device__ __forceinline__ float window_sum(const float* x, int n, int k,
                                            int lo) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int i = kWin * k - lo + j;
    s = s + ((i >= 0 && i < n) ? x[pad(i)] : 0.0f);
  }
  return s;
}

// Windows of level n, and half their padding, rounded down: the front's.
__host__ __device__ __forceinline__ int windows(int n) {
  return (n + kWin - 1) / kWin;
}
__host__ __device__ __forceinline__ int front(int n) {
  return (windows(n) * kWin - n) / 2;
}

// XLA's total of n values (src, padded) by every thread of the block: a
// level of windows at a time into a and b in turn (a holds windows(n)
// padded values, b windows(windows(n))), then the last <= 32 in order from
// 0. src is not written.
__device__ __forceinline__ float block_total(const float* src, int n,
                                            float* a, float* b,
                                            float* total_s) {
  const float* x = src;
  float* out = a;
  while (n > kWin) {
    const int nw = windows(n), lo = front(n);
    for (int k = threadIdx.x; k < nw; k += blockDim.x) {
      out[pad(k)] = window_sum(x, n, k, lo);
    }
    __syncthreads();
    x = out;
    out = out == a ? b : a;
    n = nw;
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s = s + x[pad(j)];
    *total_s = s;
  }
  __syncthreads();
  return *total_s;
}

// ---- the one-CTA route ----

// The scan's levels: level 0 holds the T probabilities, level k + 1 the
// totals of level k's blocks of 16. Each level but the last is padded with
// zeros to whole blocks; the last has at most 16 values. The kernel keeps
// it in shared memory, where its loops index it.
struct Levels {
  int n[kMaxLevels];     // values of each level
  int size[kMaxLevels];  // ... padded to whole blocks (the last: n)
  int off[kMaxLevels];   // its first float in shared memory
  int count;             // levels
  int floats;            // shared floats of the levels
};

__host__ __device__ void levels(int t, Levels& L) {
  int n = t, off = 0, k = 0;
  while (true) {
    L.n[k] = n;
    L.off[k] = off;
    L.size[k] = n <= kBlk ? n : (n + kBlk - 1) / kBlk * kBlk;
    off += padded(L.size[k]);
    ++k;
    if (n <= kBlk) break;
    n = (n + kBlk - 1) / kBlk;
  }
  L.count = k;
  L.floats = off;
}

// Shared floats of the one-CTA route: the levels, then the total's two
// window levels.
int cta_floats(int t) {
  Levels L;
  levels(t, L);
  return L.floats + padded(windows(t)) + padded(windows(windows(t)));
}

// Threads of the one-CTA route's block: a block of 16 a thread at the
// first level, whole warps, at most kCtaThreads.
int cta_threads(int t) {
  const int warps = ((t + kBlk - 1) / kBlk + 31) / 32;
  return warps < 1 ? 32 : (32 * warps < kCtaThreads ? 32 * warps
                                                    : kCtaThreads);
}

__global__ void __launch_bounds__(kCtaThreads)
    light_cdf(const float* __restrict__ emission,
              const float* __restrict__ area, float* __restrict__ cdf,
              float* __restrict__ prob, int t) {
  extern __shared__ float sm[];
  __shared__ float total_s;
  __shared__ Levels L;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int size0 = t <= kBlk ? t : (t + kBlk - 1) / kBlk * kBlk;
  float* x0 = sm;  // level 0
  if (tid == 0) levels(t, L);

  // the weights, zero past T, loaded four a thread at a time
  for (int base = 0; base < size0; base += 4 * nt) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * nt + tid;
      w[u] = i < t ? weight(emission, area, i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * nt + tid;
      if (i < size0) x0[pad(i)] = w[u];
    }
  }
  __syncthreads();
  float* a = sm + L.floats;
  const float total =
      block_total(x0, t, a, a + padded(windows(t)), &total_s);
  if (!(total > 0.0f)) {
    for (int i = tid; i < t; i += nt) {
      prob[i] = 0.0f;
      cdf[i] = static_cast<float>(i + 1) / static_cast<float>(t);
    }
    return;
  }
  for (int i = tid; i < t; i += nt) {
    const float p = x0[pad(i)] / total;
    x0[pad(i)] = p;
    prob[i] = p;
  }
  __syncthreads();

  // down: scan each block of 16 in place; its total goes up a level
  for (int k = 0; k + 1 < L.count; ++k) {
    float* x = sm + L.off[k];
    float* up = sm + L.off[k + 1];
    for (int b = tid; b < L.size[k + 1]; b += nt) {
      float s = 0.0f;
      if (b < L.n[k + 1]) {
        s = x[pad(b * kBlk)];
#pragma unroll
        for (int j = 1; j < kBlk; ++j) {
          s = s + x[pad(b * kBlk + j)];
          x[pad(b * kBlk + j)] = s;
        }
      }
      up[pad(b)] = s;
    }
    __syncthreads();
  }
  // the last level (at most 16 values), sequential
  if (tid == 0) {
    float* x = sm + L.off[L.count - 1];
    float s = x[0];
    for (int j = 1; j < L.n[L.count - 1]; ++j) {
      s = s + x[pad(j)];
      x[pad(j)] = s;
    }
  }
  __syncthreads();
  // up: add the scanned total of the block before
  for (int k = L.count - 2; k >= 0; --k) {
    float* x = sm + L.off[k];
    const float* up = sm + L.off[k + 1];
    for (int i = tid; i < L.size[k]; i += nt) {
      const int b = i / kBlk;
      x[pad(i)] = x[pad(i)] + (b == 0 ? 0.0f : up[pad(b - 1)]);
    }
    __syncthreads();
  }
  for (int i = tid; i < t; i += nt) cdf[i] = x0[pad(i)];
}

// ---- the grid route ----
//
// The total's levels: n0 = T weights, n1 = windows(n0) window sums, n2 =
// windows(n1) (<= 1024), then one more level of windows at most and the
// last sum, inside a block. The
// scan's: level 0 the T probabilities, level k + 1 = ceil(n_k / 16) block
// totals; T > kChunk makes levels 0-2 whole blocks, so chunk c holds
// level-2 block c, and level 3 (a total a chunk, n3 <= 256) is the last
// (n3 <= 16) or has a last level 4 above it (n4 <= 16).
//
// Scratch floats: the T weights; the n2 window sums; the total; 16 level-2
// values a chunk; a level-3 value a chunk.

struct GridScratch {
  float *w, *r2, *total, *v2, *v3;
};

__host__ __device__ GridScratch grid_scratch(float* s, int t) {
  const int n2 = windows(windows(t)), chunks = (t + kChunk - 1) / kChunk;
  GridScratch g;
  g.w = s;
  g.r2 = g.w + t;
  g.total = g.r2 + n2;
  g.v2 = g.total + 1;
  g.v3 = g.v2 + kBlk * chunks;
  return g;
}

int grid_scratch_floats(int t) {
  const int chunks = (t + kChunk - 1) / kChunk;
  return t + windows(windows(t)) + 1 + kBlk * chunks + chunks;
}

// Block c: the total's second-level window c, i.e. its 32 first-level
// windows of 32 weights. Writes the weights in [0, T) and the window's sum.
__global__ void __launch_bounds__(kThreads)
    light_cdf_windows(const float* __restrict__ emission,
                      const float* __restrict__ area, float* __restrict__ w,
                      float* __restrict__ r2, int t) {
  __shared__ float x[padded(kWinTris)];
  const int tid = threadIdx.x, c = blockIdx.x;
  const int n1 = windows(t);
  const int base = kWin * (kWin * c - front(n1)) - front(t);
  float v[kWinTris / kThreads];
#pragma unroll
  for (int u = 0; u < kWinTris / kThreads; ++u) {
    const int g = base + u * kThreads + tid;
    v[u] = (g >= 0 && g < t) ? weight(emission, area, g) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kWinTris / kThreads; ++u) {
    const int e = u * kThreads + tid, g = base + e;
    if (g >= 0 && g < t) w[g] = v[u];
    x[pad(e)] = v[u];
  }
  __syncthreads();
  if (tid < kWin) {
    // lane k: first-level window k of this block, all inside [0, 1024)
    const float s = window_sum(x, kWinTris, tid, 0);
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) r = r + __shfl_sync(0xffffffffu, s, k);
    if (tid == 0) r2[c] = r;
  }
}

// Block c: chunk c. The total (every block; block 0 stores it), prob, and
// the chunk's level-2 values and level-3 value.
__global__ void __launch_bounds__(kThreads)
    light_cdf_prob(float* __restrict__ scratch, float* __restrict__ cdf,
                   float* __restrict__ prob, int t) {
  __shared__ float x[padded(kChunk)];
  __shared__ float v1[padded(kChunk / kBlk)];
  __shared__ float ra[padded(kWinTris)], rb[padded(kWin)], rc[padded(1)];
  __shared__ float v2[kBlk];
  __shared__ float total_s;
  const GridScratch g = grid_scratch(scratch, t);
  const int tid = threadIdx.x, c = blockIdx.x, base = kChunk * c;
  const int n2 = windows(windows(t));

  float w[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = base + u * kThreads + tid;
    w[u] = i < t ? g.w[i] : 0.0f;
  }
  for (int i = tid; i < n2; i += kThreads) ra[pad(i)] = g.r2[i];
  __syncthreads();
  const float total = block_total(ra, n2, rb, rc, &total_s);
  if (c == 0 && tid == 0) *g.total = total;
  if (!(total > 0.0f)) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < t) {
        prob[i] = 0.0f;
        cdf[i] = static_cast<float>(i + 1) / static_cast<float>(t);
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = u * kThreads + tid, i = base + e;
    const float p = w[u] / total;  // 0 past T
    if (i < t) prob[i] = p;
    x[pad(e)] = p;
  }
  __syncthreads();
  {  // level 0: thread b sums block b
    float s = x[pad(kBlk * tid)];
#pragma unroll
    for (int j = 1; j < kBlk; ++j) s = s + x[pad(kBlk * tid + j)];
    v1[pad(tid)] = s;
  }
  __syncthreads();
  if (tid < kBlk) {  // level 1: 16 blocks
    float s = v1[pad(kBlk * tid)];
#pragma unroll
    for (int j = 1; j < kBlk; ++j) s = s + v1[pad(kBlk * tid + j)];
    v2[tid] = s;
    g.v2[kBlk * c + tid] = s;
  }
  __syncwarp();
  if (tid == 0) {  // level 2: the chunk's block
    float s = v2[0];
#pragma unroll
    for (int j = 1; j < kBlk; ++j) s = s + v2[j];
    g.v3[c] = s;
  }
}

// Inclusive scan, in order from x[0], of x[0..j] (j < 16), x in shared.
__device__ __forceinline__ float prefix16(const float* x, int j) {
  float s = x[0];
#pragma unroll
  for (int p = 1; p < kBlk; ++p) {
    if (p <= j) s = s + x[p];
  }
  return s;
}

// Block c: chunk c's cdf.
__global__ void __launch_bounds__(kThreads)
    light_cdf_scan(const float* __restrict__ scratch,
                   const float* __restrict__ prob, float* __restrict__ cdf,
                   int t) {
  __shared__ float x[padded(kChunk)];
  __shared__ float x1[padded(kChunk / kBlk)];
  __shared__ float f1[padded(kChunk / kBlk + 1)];
  __shared__ float v3[kChunk / kBlk + kBlk];  // level 3, zero-padded
  __shared__ float v2[2 * kBlk];  // level 2 of chunks c - 1 and c
  __shared__ float v4[kBlk], s4[kBlk], s3[2], top[kBlk + 1];
  const GridScratch g =
      grid_scratch(const_cast<float*>(scratch), t);
  if (!(*g.total > 0.0f)) return;
  const int tid = threadIdx.x, c = blockIdx.x, base = kChunk * c;
  const int n3 = (t + kChunk - 1) / kChunk;

#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = u * kThreads + tid, i = base + e;
    x[pad(e)] = i < t ? prob[i] : 0.0f;
  }
  for (int i = tid; i < kChunk / kBlk + kBlk; i += kThreads) {
    v3[i] = i < n3 ? g.v3[i] : 0.0f;
  }
  if (tid < 2 * kBlk) {
    const int k = kBlk * (c - 1) + tid;
    v2[tid] = k >= 0 ? g.v2[k] : 0.0f;
  }
  __syncthreads();

  // level 0 down: thread b scans block b in place; its total to x1
  {
    float s = x[pad(kBlk * tid)];
#pragma unroll
    for (int j = 1; j < kBlk; ++j) {
      s = s + x[pad(kBlk * tid + j)];
      x[pad(kBlk * tid + j)] = s;
    }
    x1[pad(tid)] = s;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  if (warp == 0) {
    // level 1 down: 16 blocks of the chunk, in place
    if (lane < kBlk) {
      float s = x1[pad(kBlk * lane)];
#pragma unroll
      for (int j = 1; j < kBlk; ++j) {
        s = s + x1[pad(kBlk * lane + j)];
        x1[pad(kBlk * lane + j)] = s;
      }
    }
  } else if (warp == 1) {
    // the scanned level-3 values of chunks c - 2 and c - 1
    if (n3 <= kBlk) {
      // level 3 is the last: in order from its first value
      if (lane < 2 && c - 2 + lane >= 0) s3[lane] = prefix16(v3, c - 2 + lane);
    } else {
      // level 4 (n4 <= 16 blocks of level 3) is the last
      if (lane < kBlk) v4[lane] = prefix16(v3 + kBlk * lane, kBlk - 1);
      __syncwarp();
      if (lane == 0) {
        float s = v4[0];
        s4[0] = s;
        for (int q = 1; q < kBlk; ++q) {
          s = s + v4[q];
          s4[q] = s;
        }
      }
      __syncwarp();
      const int j = c - 2 + lane;
      if (lane < 2 && j >= 0) {
        const int q = j / kBlk;
        s3[lane] = prefix16(v3 + kBlk * q, j % kBlk) +
                   (q == 0 ? 0.0f : s4[q - 1]);
      }
    }
    __syncwarp();
    // the scanned level-2 values 16 c - 2 .. 16 c + 14: top[k - 16 c + 2]
    const int k = kBlk * c - 2 + lane;
    if (lane <= kBlk && k >= 0) {
      const int blk = k / kBlk;  // c - 1 or c
      top[lane] = prefix16(v2 + kBlk * (blk - c + 1), k % kBlk) +
                  (blk == 0 ? 0.0f : s3[blk - c + 1]);
    }
  }
  __syncthreads();
  // level 1 up: f1[j + 1] = the scanned level-1 value 256 c + j, j >= -1
  {
    const int blk = kBlk * c + tid / kBlk;
    f1[pad(tid + 1)] = x1[pad(tid)] + (blk == 0 ? 0.0f : top[tid / kBlk + 1]);
    // 256 c - 1 closes the chunk before: its block's total plus top[0]
    if (tid == 0 && c > 0) f1[pad(0)] = v2[kBlk - 1] + top[0];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = u * kThreads + tid, i = base + e;
    if (i < t) {
      cdf[i] = x[pad(e)] + (i < kBlk ? 0.0f : f1[pad(e / kBlk)]);
    }
  }
}

}  // namespace

// Floats of the scratch buffer a call for t triangles on the route needs:
// 0 on the one-CTA route.
extern "C" int spath_light_cdf_scratch(int t, int grid) {
  return grid ? grid_scratch_floats(t) : 0;
}

// Kernels spath_light_cdf has launched since the library was loaded.
extern "C" long long spath_light_cdf_kernel_launches() { return g_launches; }

extern "C" int spath_light_cdf(const float* emission, const float* area,
                               float* cdf, float* prob, float* scratch,
                               int t, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!grid) {
    if (t < 1 || t > kCtaMaxTris) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int smem = cta_floats(t) * static_cast<int>(sizeof(float));
    light_cdf<<<1, cta_threads(t), smem, s>>>(emission, area, cdf, prob,
                                               t);
    ++g_launches;
    return static_cast<int>(cudaGetLastError());
  }
  if (t <= kChunk || t > kMaxTris || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GridScratch g = grid_scratch(scratch, t);
  const int chunks = (t + kChunk - 1) / kChunk;
  light_cdf_windows<<<windows(windows(t)), kThreads, 0, s>>>(
      emission, area, g.w, g.r2, t);
  light_cdf_prob<<<chunks, kThreads, 0, s>>>(scratch, cdf, prob, t);
  light_cdf_scan<<<chunks, kThreads, 0, s>>>(scratch, prob, cdf, t);
  g_launches += 3;
  return static_cast<int>(cudaGetLastError());
}
