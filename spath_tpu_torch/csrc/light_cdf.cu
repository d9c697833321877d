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
//   total = w_0 + w_1 + ... + w_{T-1}, left to right
//   prob  = w / total
//   cdf   = XLA's CPU scan of prob: sequential within blocks of 16
//           (zero-padded), the block totals scanned the same way
//           (recursively, one level each), then the scanned totals of the
//           blocks before added to each block, +0 to the first
//
// and, for an all-dark scene (total not > 0), prob 0 and cdf_i =
// (i + 1) / T. Built with -fmad=false and IEEE division, so every add,
// multiply and divide rounds as the plain version's does.
//
// Up to kSharedTris triangles: one launch of one block of kThreads
// threads. The threads compute the weights and the probabilities and
// each scans one block of 16; thread 0 sums the total and scans the last
// level. Every level lives in shared memory.
//
// Above that, up to kMaxTris (2^20, the streamed kernels' cap): the same
// steps, each a launch on as many blocks as its level needs, with the
// levels in a global scratch buffer the caller allocates
// (spath_light_cdf_scratch floats): the weights; the total (one thread,
// left to right: it is a chain of T dependent adds, ~2.5 ms at 2^20, the
// longest step); the probabilities; one down-sweep launch per level; the
// last level (one thread); one up-sweep launch per level, the last
// writing the cdf. The total sits behind the levels in the scratch
// buffer; every launch after the probabilities' returns at once for an
// all-dark scene.
//
// The work is ~7 T float operations and 24 T bytes.
//
// Layouts, all contiguous: emission float32 (T, 3), area float32 (T), cdf
// and prob float32 (T) out, scratch float32 (spath_light_cdf_scratch(T))
// or null up to kSharedTris; 1 <= T <= kMaxTris. The launches go on the
// caller's stream, allocate nothing and do not synchronise; the entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 16;
constexpr int kSharedTris = 8192;  // every level in one block's shared memory
constexpr int kMaxTris = 1 << 20;
constexpr int kMaxLevels = 6;  // 16^5 >= kMaxTris

// The scan's levels: level 0 holds the T probabilities, level k + 1 the
// totals of level k's blocks of 16. Each level but the last is padded with
// zeros to whole blocks; the last has at most 16 values.
struct Levels {
  int n[kMaxLevels];    // values of each level
  int off[kMaxLevels];  // its first float in shared memory
  int count;            // levels
  int floats;           // shared floats in all
};

__host__ __device__ Levels levels(int t) {
  Levels L;
  int n = t, off = 0, k = 0;
  while (true) {
    L.n[k] = n;
    L.off[k] = off;
    ++k;
    if (n <= kBlk) {
      off += n;
      break;
    }
    off += (n + kBlk - 1) / kBlk * kBlk;
    n = (n + kBlk - 1) / kBlk;
  }
  L.count = k;
  L.floats = off;
  return L;
}

// Floats level k occupies: whole blocks, or the last level's values.
__device__ int level_size(const Levels& L, int k) {
  return k + 1 < L.count ? L.off[k + 1] - L.off[k] : L.n[k];
}

__global__ void __launch_bounds__(kThreads)
    light_cdf(const float* __restrict__ emission,
              const float* __restrict__ area, float* __restrict__ cdf,
              float* __restrict__ prob, int t) {
  extern __shared__ float sm[];
  __shared__ float total_s;
  const Levels L = levels(t);
  const int tid = threadIdx.x;

  // the weights, zero past T
  for (int i = tid; i < level_size(L, 0); i += kThreads) {
    float w = 0.0f;
    if (i < t) {
      w = ((emission[3 * i + 0] + emission[3 * i + 1]) +
           emission[3 * i + 2]) *
          area[i];
    }
    sm[i] = w;
  }
  __syncthreads();
  if (tid == 0) {
    float s = sm[0];
    for (int i = 1; i < t; ++i) s = s + sm[i];
    total_s = s;
  }
  __syncthreads();
  const float total = total_s;
  if (!(total > 0.0f)) {
    for (int i = tid; i < t; i += kThreads) {
      prob[i] = 0.0f;
      cdf[i] = static_cast<float>(i + 1) / static_cast<float>(t);
    }
    return;
  }
  for (int i = tid; i < t; i += kThreads) {
    const float p = sm[i] / total;
    sm[i] = p;
    prob[i] = p;
  }
  __syncthreads();

  // down: scan each block of 16 in place; its total goes up a level
  for (int k = 0; k + 1 < L.count; ++k) {
    float* x = sm + L.off[k];
    float* up = sm + L.off[k + 1];
    for (int b = tid; b < level_size(L, k + 1); b += kThreads) {
      float s = 0.0f;
      if (b < L.n[k + 1]) {
        s = x[b * kBlk];
        for (int j = 1; j < kBlk; ++j) {
          s = s + x[b * kBlk + j];
          x[b * kBlk + j] = s;
        }
      }
      up[b] = s;
    }
    __syncthreads();
  }
  // the last level, sequential
  if (tid == 0) {
    float* x = sm + L.off[L.count - 1];
    float s = x[0];
    for (int j = 1; j < L.n[L.count - 1]; ++j) {
      s = s + x[j];
      x[j] = s;
    }
  }
  __syncthreads();
  // up: add the scanned totals of the blocks before
  for (int k = L.count - 2; k >= 0; --k) {
    float* x = sm + L.off[k];
    const float* up = sm + L.off[k + 1];
    for (int i = tid; i < level_size(L, k); i += kThreads) {
      const int b = i / kBlk;
      x[i] = x[i] + (b == 0 ? 0.0f : up[b - 1]);
    }
    __syncthreads();
  }
  for (int i = tid; i < t; i += kThreads) cdf[i] = sm[i];
}

// ---- above kSharedTris: the same steps, levels in global memory ----

__device__ __forceinline__ bool lit(const float* total) {
  return *total > 0.0f;
}

// lv[i] = w_i for i < t, 0 up to the padded size n.
__global__ void cdf_weights(const float* __restrict__ emission,
                            const float* __restrict__ area,
                            float* __restrict__ lv, int t, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w = 0.0f;
  if (i < t) {
    w = ((emission[3 * i + 0] + emission[3 * i + 1]) + emission[3 * i + 2]) *
        area[i];
  }
  lv[i] = w;
}

// The total, left to right: one thread.
__global__ void cdf_total(const float* __restrict__ lv, int t,
                          float* __restrict__ total) {
  float s = lv[0];
#pragma unroll 16
  for (int i = 1; i < t; ++i) s = s + lv[i];
  *total = s;
}

__global__ void cdf_prob(float* __restrict__ lv, const float* total,
                         float* __restrict__ cdf, float* __restrict__ prob,
                         int t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  const float tot = *total;
  if (!(tot > 0.0f)) {
    prob[i] = 0.0f;
    cdf[i] = static_cast<float>(i + 1) / static_cast<float>(t);
    return;
  }
  const float p = lv[i] / tot;
  lv[i] = p;
  prob[i] = p;
}

// Scan each block of 16 of x in place; block b's total to up[b], zero for
// the padding b >= n_up of up's level.
__global__ void cdf_down(float* __restrict__ x, float* __restrict__ up,
                         int n_up, int size_up, const float* total) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= size_up || !lit(total)) return;
  float s = 0.0f;
  if (b < n_up) {
    s = x[b * kBlk];
    for (int j = 1; j < kBlk; ++j) {
      s = s + x[b * kBlk + j];
      x[b * kBlk + j] = s;
    }
  }
  up[b] = s;
}

// The last level (at most 16 values), sequential: one thread.
__global__ void cdf_last(float* __restrict__ x, int n, const float* total) {
  if (!lit(total)) return;
  float s = x[0];
  for (int j = 1; j < n; ++j) {
    s = s + x[j];
    x[j] = s;
  }
}

// x[i] += the scanned total of the blocks before i's; to out[i] (i < t)
// when out is given (level 0), else in place.
__global__ void cdf_up(float* __restrict__ x, const float* __restrict__ up,
                       int size, float* __restrict__ out, int t,
                       const float* total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size || !lit(total)) return;
  const int b = i / kBlk;
  const float v = x[i] + (b == 0 ? 0.0f : up[b - 1]);
  if (out == nullptr) {
    x[i] = v;
  } else if (i < t) {
    out[i] = v;
  }
}

int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Floats of the scratch buffer a launch for t triangles needs: 0 up to
// kSharedTris, else the levels and the total.
extern "C" int spath_light_cdf_scratch(int t) {
  if (t <= kSharedTris) return 0;
  return levels(t).floats + 1;
}

extern "C" int spath_light_cdf(const float* emission, const float* area,
                               float* cdf, float* prob, float* scratch,
                               int t, void* stream) {
  if (t < 1 || t > kMaxTris || (t > kSharedTris && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Levels L = levels(t);
  if (t <= kSharedTris) {
    const int smem = L.floats * static_cast<int>(sizeof(float));
    light_cdf<<<1, kThreads, smem, s>>>(emission, area, cdf, prob, t);
    return static_cast<int>(cudaGetLastError());
  }
  float* total = scratch + L.floats;
  const int n0 = L.off[1] - L.off[0];
  cdf_weights<<<grid_for(n0), kThreads, 0, s>>>(emission, area, scratch, t,
                                                  n0);
  cdf_total<<<1, 1, 0, s>>>(scratch, t, total);
  cdf_prob<<<grid_for(t), kThreads, 0, s>>>(scratch, total, cdf, prob, t);
  for (int k = 0; k + 1 < L.count; ++k) {
    const int size_up = k + 2 < L.count ? L.off[k + 2] - L.off[k + 1]
                                        : L.n[k + 1];
    cdf_down<<<grid_for(size_up), kThreads, 0, s>>>(
        scratch + L.off[k], scratch + L.off[k + 1], L.n[k + 1], size_up,
        total);
  }
  cdf_last<<<1, 1, 0, s>>>(scratch + L.off[L.count - 1], L.n[L.count - 1],
                           total);
  for (int k = L.count - 2; k >= 0; --k) {
    const int size = L.off[k + 1] - L.off[k];
    cdf_up<<<grid_for(size), kThreads, 0, s>>>(
        scratch + L.off[k], scratch + L.off[k + 1], size,
        k == 0 ? cdf : nullptr, t, total);
  }
  return static_cast<int>(cudaGetLastError());
}
