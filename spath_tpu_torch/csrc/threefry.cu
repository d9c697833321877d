// The threefry stream's draws for one (sample, bounce) step of the
// wavefront: each pixel's key is fold_in(step key, pixel id) and its
// n_draws uniforms are jax.random.uniform(pixel key, (n_draws,)), float32,
// as jax 0.9.0 computes them with its default jax_threefry_partitionable
// (ops/rng.py::per_pixel_uniforms is the plain version, and the CPU tests hold
// it to jax.random bit for bit).
//
// It replaces no Pallas kernel: the JAX package draws these with XLA
// (spath_tpu/ops/rng.py:220, per_pixel_uniforms), and no Pallas kernel
// takes the threefry stream (K1 and K6 take the LCG, K3 and K9 the hash
// stream). It was added because PyTorch has no unsigned 32-bit arithmetic
// on the card: the plain version keeps the words in int64 and masks every
// step, ~165 elementwise launches over the frame's pixels a step.
//
// Per pixel: one Threefry-2x32 block for fold_in (key (k0, k1), counter
// (0, id)), then one block a draw d (key the pixel's, counter (0, d)), the
// bits y0 ^ y1, the float (bits >> 9 | 0x3F800000) - 1. A block is 20
// rounds of add, rotate (one funnel shift) and xor and five key
// injections, ~73 integer instructions; a draw ~3 more. So the work is
// ~(n_draws + 1) * 73 integer instructions a pixel against 8 + 4 * n_draws
// bytes (the id read, the draws written): the kernel is bound by the
// SMs' instruction issue, not by memory (nvcc spreads the adds over the
// integer and FP32 pipes as IADD3 and IMAD). A thread a pixel, no shared
// memory, the pixel's key schedule kept in registers across its draws;
// each draw's row is written coalesced.
//
// Layouts, all contiguous: ids int64 (n), out float32 (n_draws, n). Each id
// is taken mod 2^32. The launch goes on the caller's stream, allocates
// nothing and does not synchronise; the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with the given rotations.
#define SPATH_ROUNDS(r0, r1, r2, r3)                \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;                 \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;                 \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;                 \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  SPATH_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  SPATH_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  SPATH_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  SPATH_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  SPATH_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
}

#undef SPATH_ROUNDS

__global__ void __launch_bounds__(kThreads)
    threefry_draws(uint32_t k0, uint32_t k1, const long long* __restrict__ ids,
                   float* __restrict__ out, int n, int n_draws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    // fold_in(step key, id): counter (0, id)
    uint32_t p0 = 0u, p1 = static_cast<uint32_t>(ids[i]);
    threefry2x32(k0, k1, p0, p1);
    for (int d = 0; d < n_draws; ++d) {
      uint32_t y0 = 0u, y1 = static_cast<uint32_t>(d);
      threefry2x32(p0, p1, y0, y1);
      const uint32_t bits = y0 ^ y1;
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      // jax.random.uniform's "* (maxval - minval) + minval" and
      // "max(minval, .)" at [0, 1): exact, kept as jax writes them
      out[static_cast<long long>(d) * n + i] = fmaxf(f * 1.0f + 0.0f, 0.0f);
    }
  }
}

}  // namespace

// The draws of one step: key words (k0, k1), ids, out, n, n_draws (1-8),
// the stream. A thread a pixel.
extern "C" int spath_threefry(unsigned int k0, unsigned int k1,
                              const void* ids, void* out, int n, int n_draws,
                              void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  threefry_draws<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<const long long*>(ids), static_cast<float*>(out),
      n, n_draws);
  return static_cast<int>(cudaGetLastError());
}
