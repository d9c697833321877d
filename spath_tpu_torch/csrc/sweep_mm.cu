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
// Bound: operations, the 60 live bf16 products of each (ray, row) pair at
// the dense bf16 tensor-core rate (989 TFLOP/s on an H100 SXM): 7.33 ms
// at 230,400 rays x 65,536 triangles. K = 128 executes 128 columns for
// those 60, so its own ceiling is 15.63 ms, above twice the bound; K = 64
// executes 64 (4 zero columns), 7.82 ms. Device memory sees the operands
// once (127 MB at K = 128, 64 MB at K = 64) and 4 bytes a ray out.
//
// Design (Hopper, sm_90a): a CTA owns kCtaRays = 448 rays and walks every
// block of G in order, as the TPU kernel's revisited accumulator walks its
// grid's triangle axis. Five warpgroups:
// - the producer: one thread streams G through a ring of kStages stages
//   of 64 rows with TMA (128-byte swizzle; a K = 128 row is two 64-column
//   swizzle atoms, two boxes a stage), each stage completed on its full
//   mbarrier and refilled once the 16 consumer warps have arrived on its
//   empty one. setmaxnreg gives its registers to the consumers.
// - four consumers, each owning 112 rays: their R columns sit in shared
//   memory for the whole launch, K-major in the same swizzled layout
//   (written once at the start, zero past the last ray). Per stage a
//   consumer issues K/16 wgmma.mma_async m64n112k16 (G's 64 rows as A,
//   its rays as B, both from shared memory through descriptors; float32
//   accumulators, 56 a thread), waits for them, releases the stage, and
//   folds each thread's two rows into 28 running minima. At a block's end
//   the minima are finished across the 8 lanes that share a column
//   (shuffles) and the 4 warps (shared memory), and added to the ray's
//   float32 sum, in block order.
// The fold is one fminf a (row, ray) product, 6.0e10 at the tool's shape,
// on the CUDA cores: while one consumer folds, the other three keep the
// tensor cores fed. At K = 64 it is still the limit: on an H100 SXM at
// 700 W the kernel takes ~11.0 ms at 230,400 rays x 65,536 triangles
// with it and ~8.3 without it (tools/kernel_variants.py t1_no_fold),
// against the 7.8 ms ceiling. No __syncthreads in the loop, no atomics;
// the sums run in a fixed order, so two launches give the same bits.
//
// What it buys against the mma.sync kernel it replaces: wgmma is Hopper's
// full tensor-core rate; shared memory serves ~24 bytes a 1,000 FLOP
// (a 2 KB A tile and a 3.5 KB B tile per 229,376 FLOP; ~98 bytes a clock
// at the dense rate) where every warp's ldmatrix of the whole chunk took
// ~31; TMA copies without registers or instructions; and 448 rays a CTA
// (515 CTAs, 3.90 waves of one CTA an SM at 230,400 rays) read G through
// L2 515 times, 34.6 GB at K = 128 and 17.3 GB at K = 64, where 900 CTAs
// of 256 read 60.4 and 30.2.
//
// Layouts (checked by the Python wrapper ops/kernels/sweep_mm.py, whose
// launch_plan mirrors the constants below), all row-major and contiguous:
//   gfeat  bf16 (4T, K), 4T = 1024 * n_blocks
//   rfeat  bf16 (K, N)
//   out    float32 (N)
// The entry point encodes G's tensor map (cuTensorMapEncodeTiled, from
// the driver through cudaGetDriverEntryPoint) and launches on the
// caller's stream; it allocates nothing and does not synchronise, and
// returns a cudaError_t (cudaErrorNotSupported without the encoder,
// cudaErrorInvalidValue if the map cannot be encoded).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 4;
constexpr int kThreads = 128 * (1 + kConsumers);
// wgmma's N: the rays of a consumer warpgroup, and of a CTA.
constexpr int kWgRays = 112;
constexpr int kCtaRays = kConsumers * kWgRays;
// A thread's accumulators (2 rows x kWgRays / 4 columns) and minima.
constexpr int kAccRegs = kWgRays / 2;
constexpr int kLoRegs = kWgRays / 4;
// wgmma's M: rows of G a stage; a block of 4 x 256 triangles.
constexpr int kTileRows = 64;
constexpr int kBlockRows = 1024;
constexpr int kTilesPerBlock = kBlockRows / kTileRows;
// A 128-byte swizzle atom's row: 64 bf16 columns. 8 rows make 1024 bytes.
constexpr int kAtomK = 64;
constexpr int kAtomBytes = 2 * kAtomK;
constexpr int kAlign = 1024;
constexpr int kSmemLimit = 232448;
// Registers a thread: at launch (the most for one CTA of kThreads on an
// SM, in whole 256-register warp units), and after setmaxnreg; what the
// consumers take, the producer must have given back to the CTA.
constexpr int kLaunchRegs = 65536 / (kThreads / 32) / 256 * 256 / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 112;
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  128 * kConsumers * (kConsumerRegs - kLaunchRegs),
              "setmaxnreg");

template <int K>
struct Plan {
  static_assert(K == 64 || K == 128, "K is 64 or 128");
  static constexpr int kAtoms = K / kAtomK;
  static constexpr int kKSteps = K / 16;
  static constexpr int kStages = K == 64 ? 8 : 6;
  static constexpr int kAtomStageBytes = kTileRows * kAtomBytes;
  static constexpr int kStageBytes = kAtoms * kAtomStageBytes;
  static constexpr int kRayAtomBytes = kCtaRays * kAtomBytes;
  static constexpr int kRayBytes = kAtoms * kRayAtomBytes;
  static constexpr int kXchBytes = kConsumers * 4 * kWgRays * 4;
  static constexpr int kBarBytes = 2 * kStages * 8;
  // Offsets from the 1024-aligned base: R, the ring, the block-end
  // exchange, the full and empty barriers.
  static constexpr int kRingAt = kRayBytes;
  static constexpr int kXchAt = kRingAt + kStages * kStageBytes;
  static constexpr int kBarAt = kXchAt + kXchBytes;
  static constexpr int kSmemBytes = kAlign + kBarAt + kBarBytes;
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 64-column box of G's tensor map at (column c0, row c1) into shared
// memory, completing bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The wgmma descriptor of a K-major operand in 128-byte swizzle atoms
// (8 rows of 128 bytes, 1024 bytes apart); the leading offset is unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving reads of an accumulator across the
// wgmma fence and wait around them.
__device__ __forceinline__ void fence_acc(float (&d)[kAccRegs]) {
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 112, float32) = A (64 x 16, bf16) * B (16 x 112, bf16) + (acc ?
// d : 0), both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n112k16(float (&d)[kAccRegs],
                                                 uint64_t a, uint64_t b,
                                                 int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(a), "l"(b), "r"(acc));
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_mm(const __grid_constant__ CUtensorMap gmap,
             const uint16_t* __restrict__ rfeat, float* __restrict__ out,
             int n_rays, int n_tiles) {
  using P = Plan<K>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (kAlign - (raw & (kAlign - 1))) & (kAlign - 1);
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t ring = base + P::kRingAt;
  const uint32_t full = base + P::kBarAt;
  const uint32_t empty = full + 8 * P::kStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray0 = blockIdx.x * kCtaRays;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The CTA's rays, K-major in 128-byte swizzle atoms: column k of ray n
  // at atom k / 64, row n, 16-byte chunk (k % 64) / 8 XOR n % 8. Two
  // columns a store; zero past the last ray.
  for (int p = threadIdx.x; p < kCtaRays * (K / 2); p += kThreads) {
    const int n = p % kCtaRays;
    const int k = 2 * (p / kCtaRays);
    uint32_t v = 0u;
    if (ray0 + n < n_rays) {
      const size_t at = static_cast<size_t>(k) * n_rays + ray0 + n;
      v = static_cast<uint32_t>(rfeat[at]) |
          (static_cast<uint32_t>(rfeat[at + n_rays]) << 16);
    }
    const int kk = k % kAtomK;
    const int off = (k / kAtomK) * P::kRayAtomBytes + n * kAtomBytes +
                    ((((kk >> 3) ^ (n & 7)) << 4) | ((kk & 7) << 1));
    *reinterpret_cast<uint32_t*>(smem + off) = v;
  }
  // The rays were written by threads and are read by wgmma (the async
  // proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp < 4) {
    // The producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(empty + 8 * s, phase ^ 1u);
        mbar_expect_tx(full + 8 * s, P::kStageBytes);
#pragma unroll
        for (int a = 0; a < P::kAtoms; ++a)
          tma_load(ring + s * P::kStageBytes + a * P::kAtomStageBytes, &gmap,
                   full + 8 * s, a * kAtomK, i * kTileRows);
        if (++s == P::kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = warp / 4 - 1;
    const int t = threadIdx.x & 127;
    const uint32_t rays = base + g * kWgRays * kAtomBytes;
    float* xch = reinterpret_cast<float*>(smem + P::kXchAt) + g * 4 * kWgRays;
    // Accumulator fragment: the thread holds rows (warp % 4) * 16 + lane / 4
    // and + 8 of columns 8j + 2 (lane % 4) + {0, 1}, as d[4j + {0, 1}] and
    // d[4j + {2, 3}]; lo[2j + c] is the running min of column
    // 8j + 2 (lane % 4) + c over the rows it has seen in the block.
    float acc[kAccRegs], lo[kLoRegs];
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kLoRegs; ++i) lo[i] = CUDART_INF_F;
    float sum = 0.0f;
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(full + 8 * s, phase);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t stage = ring + s * P::kStageBytes;
#pragma unroll
      for (int ks = 0; ks < P::kKSteps; ++ks) {
        const int within = (ks % 4) * 32;
        wgmma_m64n112k16(
            acc,
            sw128_desc(stage + (ks / 4) * P::kAtomStageBytes + within),
            sw128_desc(rays + (ks / 4) * P::kRayAtomBytes + within), ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int j = 0; j < kWgRays / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          lo[2 * j + c] = fminf(lo[2 * j + c],
                                fminf(acc[4 * j + c], acc[4 * j + 2 + c]));

      if ((i + 1) % kTilesPerBlock == 0) {
        // The block's min of each column: over the 8 lanes that hold it
        // (same lane % 4), then over the 4 warps; then the running sum,
        // in block order.
#pragma unroll
        for (int q = 0; q < kLoRegs; ++q) {
          float v = lo[q];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          lo[q] = CUDART_INF_F;
          if (lane < 4)
            xch[(warp & 3) * kWgRays + 8 * (q / 2) + 2 * lane + (q % 2)] = v;
        }
        named_sync(1 + g, 128);
        if (t < kWgRays)
          sum += fminf(fminf(xch[t], xch[kWgRays + t]),
                       fminf(xch[2 * kWgRays + t], xch[3 * kWgRays + t]));
        named_sync(1 + g, 128);
      }
      if (++s == P::kStages) {
        s = 0;
        phase ^= 1u;
      }
    }
    const int n = ray0 + g * kWgRays + t;
    if (t < kWgRays && n < n_rays) out[n] = sum;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library links nothing but the runtime; null if the driver has none.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int K>
int launch(const void* gfeat, const void* rfeat, float* out, int n_rays,
           int n_blocks, void* stream) {
  using P = Plan<K>;
  if (n_rays < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // G as a 2-D tensor (columns innermost), boxes of 64 columns x 64 rows.
  CUtensorMap gmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(n_blocks) * kBlockRows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kAtomK, kTileRows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult enc = encode(
      &gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(gfeat),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      sweep_mm<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (n_rays + kCtaRays - 1) / kCtaRays;
  sweep_mm<K><<<grid, kThreads, P::kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      gmap, static_cast<const uint16_t*>(rfeat), out, n_rays,
      n_blocks * kTilesPerBlock);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
void plan(int* out) {
  using P = Plan<K>;
  out[0] = kCtaRays;
  out[1] = kThreads;
  out[2] = P::kStages;
  out[3] = P::kSmemBytes;
  out[4] = kWgRays;
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

// The launch as compiled, for the wrapper's launch_plan to be held to:
// out[0..4] = rays a CTA, threads, stages, dynamic shared bytes, rays a
// consumer warpgroup. Returns 0, or cudaErrorInvalidValue for another K.
extern "C" int spath_sweep_mm_plan(int k, int* out) {
  if (k == 64) {
    plan<64>(out);
  } else if (k == 128) {
    plan<128>(out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
