// The matmul-only intersection sweep (T1): N rays against T triangles as
// one bf16 tensor-core product with a bare-min epilogue.
//
// Replaces the two TPU kernels of tools/sweep_microbench.py,
// _mm_only_kernel (K = 128) and _mm_sub64_kernel (K = 64). With G the
// (4T, K) bf16 triangle table (pack_tri_blocks: blocks of 1024 rows, the
// a, u*a, v*a and d*a rows of 256 triangles) and R the (K, N) bf16 ray
// table (pack_lhs of the Plucker ray rows), it computes for every ray n
//   out[n] = sum over blocks b, in block order, of
//            min over the rows r of b of  sum_k G[r][k] * R[k][n]
// with the dot products summed in float32 by the tensor cores (the bf16
// products are exact) and the block sum a float32 running sum. It is a
// measurement: the nearest-hit sweep's Plucker product without its
// epilogue, which separates the matrix unit's time from the epilogue's.
//
// Why tensor cores: on Hopper the matrix unit is the bf16 mma, and T1
// exists to time it. Bound: operations, the 60 live bf16 products of
// each (ray, row) pair at the dense bf16 tensor-core rate (989 TFLOP/s on
// an H100 SXM); K = 128 runs 128 of them, K = 64 runs 64 (4 zero columns).
// Device memory sees the operands once (127 MB at K = 128 and 64 MB at
// K = 64 for 230,400 rays x 65,536 triangles) and 4 bytes a ray out.
//
// Design: one CTA owns 256 rays (8 warps of 32) and walks every block of
// G in order, as the TPU kernel's revisited accumulator walks its grid's
// triangle axis. Each warp keeps its 32 rays' R columns in registers as
// mma B fragments for the whole launch, and streams G through shared
// memory in chunks of 128 rows (cp.async, kStages deep, rows padded by 16
// bytes so ldmatrix reads hit 8 distinct bank groups), multiplying each
// chunk with mma.sync.m16n8k16 (bf16 in, float32 accumulate). A warp
// covers every row of a chunk for its 32 rays, so each lane folds its
// accumulators into a running min in registers; at a block's end the min
// is finished across the 8 lanes that share a ray (shuffles) and added to
// the ray's running sum. No product or quad reaches device memory, no
// atomics: the sums run in a fixed order, so two launches give the same
// bits. The price is that every CTA rereads G through L2 (900 CTAs at
// 230,400 rays), about 256 FLOP a byte of G read. The other design, CTAs
// splitting the blocks and a second launch adding per-block minima, would
// write and read 236 MB more and needs two launches; this one is simpler.
// No wgmma or TMA yet.
//
// Layouts (checked by the Python wrapper ops/kernels/sweep_mm.py), all
// row-major and contiguous:
//   gfeat  bf16 (4T, K), 4T = 1024 * n_blocks
//   rfeat  bf16 (K, N)
//   out    float32 (N)
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry points return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Rays a warp owns (4 mma n-tiles of 8) and a CTA owns.
constexpr int kNTiles = 4;
constexpr int kWarpRays = 8 * kNTiles;
constexpr int kCtaRays = kWarps * kWarpRays;
// Rows of G a block (4 x 256 triangles), a staged chunk, and the m16
// tiles a warp multiplies at once.
constexpr int kBlockRows = 1024;
constexpr int kChunkRows = 128;
constexpr int kChunksPerBlock = kBlockRows / kChunkRows;
constexpr int kGroupTiles = 4;
constexpr int kStages = 4;

template <int K>
struct Shape {
  static_assert(K == 64 || K == 128, "K is 64 or 128");
  // A staged row: K values and 8 of padding (16 bytes), so the 8 rows an
  // ldmatrix phase reads start in distinct 16-byte bank groups.
  static constexpr int kStride = K + 8;
  static constexpr int kStageElems = kChunkRows * kStride;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static constexpr int kKSteps = K / 16;
  // 16-byte pieces of a row and of a chunk.
  static constexpr int kRowPieces = K / 8;
  static constexpr int kChunkPieces = kChunkRows * kRowPieces;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// The A fragment of one m16k16 tile from row-major shared memory: lane l
// points at row (l % 16), column 8 * (l / 16) of the tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 of R's column n, rows k and k + 1, as one B fragment register
// (the lower row in the low half); zero past the last ray.
__device__ __forceinline__ uint32_t r_pair(const uint16_t* __restrict__ r,
                                           int k, int n, int n_rays) {
  if (n >= n_rays) return 0u;
  const size_t at = static_cast<size_t>(k) * n_rays + n;
  return static_cast<uint32_t>(r[at]) |
         (static_cast<uint32_t>(r[at + n_rays]) << 16);
}

// Chunk c of G (rows 128c .. 128c + 127) into a stage, 16 bytes a copy.
template <int K>
__device__ __forceinline__ void load_chunk(__nv_bfloat16* stage,
                                           const __nv_bfloat16* __restrict__ g,
                                           int c) {
  using S = Shape<K>;
  const __nv_bfloat16* src = g + static_cast<size_t>(c) * kChunkRows * K;
#pragma unroll
  for (int i = 0; i < S::kChunkPieces / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int row = p / S::kRowPieces;
    const int col = (p % S::kRowPieces) * 8;
    cp_async16(stage + row * S::kStride + col, src + row * K + col);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_mm(const __nv_bfloat16* __restrict__ gfeat,
             const uint16_t* __restrict__ rfeat, float* __restrict__ out,
             int n_rays, int n_blocks) {
  using S = Shape<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ray0 = blockIdx.x * kCtaRays + warp * kWarpRays;
  const int n_chunks = n_blocks * kChunksPerBlock;

  // Start the pipeline, then load this warp's B fragments while it fills.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk<K>(smem + s * S::kStageElems, gfeat, s);
    cp_async_commit();
  }
  // mma B fragment (16x8, col): lane l holds column l / 4, rows
  // 2 * (l % 4) + {0, 1} and + 8.
  uint32_t b[S::kKSteps][kNTiles][2];
#pragma unroll
  for (int ks = 0; ks < S::kKSteps; ++ks) {
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) {
      const int k = ks * 16 + 2 * (lane & 3);
      const int n = ray0 + ni * 8 + (lane >> 2);
      b[ks][ni][0] = r_pair(rfeat, k, n, n_rays);
      b[ks][ni][1] = r_pair(rfeat, k + 8, n, n_rays);
    }
  }

  // Accumulator (16x8) fragment: lane l holds rows l / 4 and l / 4 + 8 of
  // columns 2 * (l % 4) + {0, 1}; lo[ni][j] is the running min of column
  // j of n-tile ni over the rows this lane has seen in the block.
  float lo[kNTiles][2], sum[kNTiles][2];
#pragma unroll
  for (int ni = 0; ni < kNTiles; ++ni) {
    lo[ni][0] = lo[ni][1] = CUDART_INF_F;
    sum[ni][0] = sum[ni][1] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    // Chunk c is in place for every thread, and chunk c - 1's stage is
    // free to refill.
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < n_chunks)
      load_chunk<K>(smem + (next % kStages) * S::kStageElems, gfeat, next);
    cp_async_commit();

    const __nv_bfloat16* stage = smem + (c % kStages) * S::kStageElems;
#pragma unroll 1
    for (int m0 = 0; m0 < kChunkRows; m0 += 16 * kGroupTiles) {
      float acc[kGroupTiles][kNTiles][4];
#pragma unroll
      for (int mi = 0; mi < kGroupTiles; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < S::kKSteps; ++ks) {
        uint32_t a[kGroupTiles][4];
#pragma unroll
        for (int mi = 0; mi < kGroupTiles; ++mi)
          ldmatrix_x4(a[mi], stage + (m0 + mi * 16 + (lane & 15)) * S::kStride +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < kGroupTiles; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNTiles; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ks][ni][0], b[ks][ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kGroupTiles; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni) {
          lo[ni][0] = fminf(lo[ni][0], fminf(acc[mi][ni][0], acc[mi][ni][2]));
          lo[ni][1] = fminf(lo[ni][1], fminf(acc[mi][ni][1], acc[mi][ni][3]));
        }
    }

    if ((c + 1) % kChunksPerBlock == 0) {
      // The block's min of each column over the 8 lanes that hold it (same
      // l % 4), then the running sum, in block order.
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = lo[ni][j];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          sum[ni][j] += v;
          lo[ni][j] = CUDART_INF_F;
        }
    }
  }
  cp_async_wait<0>();

  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = ray0 + ni * 8 + 2 * lane + j;
        if (n < n_rays) out[n] = sum[ni][j];
      }
  }
}

template <int K>
int launch(const void* gfeat, const void* rfeat, float* out, int n_rays,
           int n_blocks, void* stream) {
  if (n_rays < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      sweep_mm<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<K>::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (n_rays + kCtaRays - 1) / kCtaRays;
  sweep_mm<K><<<grid, kThreads, Shape<K>::kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gfeat),
      static_cast<const uint16_t*>(rfeat), out, n_rays, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spath_sweep_mm_k128(const void* gfeat, const void* rfeat,
                                   float* out, int n_rays, int n_blocks,
                                   void* stream) {
  return launch<128>(gfeat, rfeat, out, n_rays, n_blocks, stream);
}

extern "C" int spath_sweep_mm_k64(const void* gfeat, const void* rfeat,
                                  float* out, int n_rays, int n_blocks,
                                  void* stream) {
  return launch<64>(gfeat, rfeat, out, n_rays, n_blocks, stream);
}
