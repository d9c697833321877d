// Reverse sweep of the whole-frame quality path tracer (K4).
//
// Replaces the TPU kernel
// spath_tpu/ops/pallas/megakernel_quality_grad.py::_qbwd_kernel (launched
// there by quality_bwd_call), whose per-tile body is _bwd_tile_quality and
// per-bounce body _reverse_bounce. One thread owns one ray, as in K3.
//
// For each sample a thread replays K3's walk through quality_walk.cuh
// (the same source, so the same hits, draws and lights), saving per bounce
// only what cannot be recomputed: the ray before the bounce, the hit
// distance and index, the throughput, the two MIS weights, the light
// whose term counted (-1 if none) and the roulette's q. The hash draws
// are stateless and recomputed from (key, sample, bounce, draw); the
// table's columns are read again by index. The reverse sweep then runs
// from the last hit back to the camera, in the JAX kernel's order of
// operations, with g = gbar / spp, tb the adjoint of the throughput after
// the bounce and ob the adjoint of the next bounce's origin:
//
//   - the roulette's 1/q on tb;
//   - the emitter term (emission, and the throughput through w_b);
//   - the albedo of the continuation;
//   - the NEE term, whose position chain is live: through g, the weight
//     A/q, both cosines, r^2 and omega to the light point
//     y = v0 + b1 e1 + b2 e2 (light vertices, normal, area, emission) and
//     to the hit point p;
//   - p's adjoint through the Moller-Trumbore distance to the hit
//     triangle's vertices and edges and to the ray's origin, which carries
//     it to the bounce before, or at bounce 0 to the camera ray (origin and
//     direction).
//
// Outputs: the table adjoint, 19 columns per triangle (v0, e1, e2,
// normal, albedo, emission, area), scattered at the hit triangle (18
// columns) and at the light on the lanes whose NEE term counted (16
// columns); and per ray the camera-ray adjoint (origin, direction), summed
// over samples by its own thread, with no reduction.
//
// Accumulation is deterministic: no float atomics. Each warp owns a
// (T, 19) slice of shared memory. At every (sample, bounce) step of the
// reverse sweep the lanes that hit stage their triangle, their light and
// 34 adjoints; then lanes 0-18, one per column, add the staged values into
// the slice in lane order, the surface term before the light term. At the
// end the block sums its warps' slices in warp order into its row of
// `partial` (grid, T * 19), and the wrapper sums the rows (torch.sum, a
// fixed-order reduction). Four warp slices need 76 KB of shared memory at
// T = 256 and 304 KB at T = 1024, above the 227 KB a Hopper block can
// have, so the block has 128 threads (4 slices) up to T = 704 and 64
// threads (2 slices, 2 warps) above: one 64-thread block per SM at
// T = 1024. The grid has a fixed size for a given (n, T) (blocks walk the
// rays in a grid-stride loop), so two launches on the same inputs give
// the same bits.
//
// Bound: compute, as K3. The replay repeats K3's sweeps; the reverse
// sweep adds ~155 float operations per hit and ~206 more where the NEE
// term counted, the accumulation up to 34 shared-memory adds per hit,
// serialised over the warp's hitting lanes.
// Rays, keys and gbar are read once; the outputs are grid * T * 19 and
// n * 6 floats. The saved per-bounce state sits in local memory (an array
// indexed by bounce), backed by the L1 cache.
//
// Layouts (checked by the Python wrapper
// ops/kernels/megakernel_quality_grad.py), all row-major and contiguous:
//   origins, directions, keys, tri, rows   as K3 (megakernel_quality.cu)
//   gbar                 float32 (n, 3): the cotangent of K3's output
//   partial              float32 (grid, T * 19): per-block table adjoints,
//                        grid = spath_quality_backward_grid(n, T)
//   grays                float32 (n, 6): d(loss)/d(origin, direction)
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.

#include "quality_walk.cuh"

namespace {

using spath::Bounce;
using spath::Hit;
using spath::kQCols;
using spath::QualityArgs;

constexpr unsigned kFull = 0xffffffffu;
// Adjoint columns per triangle: v0, e1, e2, normal, albedo, emission, area.
constexpr int kAdj = 19;
// A staged contribution: triangle and light (as float bits), 18 surface
// adjoints (columns 0-17), 16 light adjoints (columns 0-11, 15-18).
constexpr int kSurf = 18;
constexpr int kLight = 16;
constexpr int kStage = 2 + kSurf + kLight;
// Longest path the saved per-bounce state holds.
constexpr int kMaxBounces = 16;
// Most blocks a launch uses; larger frames loop (grid-stride).
constexpr int kMaxGrid = 2048;
// Shared memory a Hopper block may use.
constexpr int kMaxShared = 232448;

__host__ __device__ int shared_bytes(int n_tris, int warps) {
  return static_cast<int>(sizeof(float)) * warps *
         (n_tris * kAdj + 32 * kStage);
}

int block_threads(int n_tris) {
  return shared_bytes(n_tris, 4) <= kMaxShared ? 128 : 64;
}

// Records the walk's bounces for the reverse sweep.
struct Saver {
  Bounce* st;
  __device__ __forceinline__ void operator()(int b, const Bounce& x) const {
    st[b] = x;
  }
};

__device__ __forceinline__ void cross(float ax, float ay, float az, float bx,
                                      float by, float bz, float& cx,
                                      float& cy, float& cz) {
  cx = ay * bz - az * by;
  cy = az * bx - ax * bz;
  cz = ax * by - ay * bx;
}

__global__ void __launch_bounds__(128)
    quality_backward(const float* __restrict__ origins,
                     const float* __restrict__ directions,
                     const int64_t* __restrict__ keys,
                     const float* __restrict__ gbar,
                     float* __restrict__ partial, float* __restrict__ grays,
                     int n, QualityArgs a) {
  extern __shared__ float smem[];
  const float* __restrict__ tri = a.tri;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slice = a.n_tris * kAdj;
  float* acc = smem + warp * slice;
  float* stage = smem + warps * slice + warp * 32 * kStage;
  for (int k = lane; k < slice; k += 32) acc[k] = 0.0f;
  __syncwarp();

  Bounce st[kMaxBounces];

  // Every lane of a warp runs the same chunks, samples and reverse steps,
  // so the warp-wide exchanges below see all 32 lanes.
  for (int base = blockIdx.x * blockDim.x; base < n;
       base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    const bool live = i < n;
    float ox0 = 0.0f, oy0 = 0.0f, oz0 = 0.0f;
    float dx0 = 0.0f, dy0 = 0.0f, dz0 = 0.0f;
    float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
    uint32_t h1 = 0u;
    Hit first{spath::kBig, -1};
    if (live) {
      ox0 = origins[3 * i + 0];
      oy0 = origins[3 * i + 1];
      oz0 = origins[3 * i + 2];
      dx0 = directions[3 * i + 0];
      dy0 = directions[3 * i + 1];
      dz0 = directions[3 * i + 2];
      g_r = gbar[3 * i + 0] * a.inv_spp;
      g_g = gbar[3 * i + 1] * a.inv_spp;
      g_b = gbar[3 * i + 2] * a.inv_spp;
      h1 = spath::fmix(static_cast<uint32_t>(keys[i]));
      // Camera rays are the same for every sample.
      first = spath::nearest<kQCols>(tri, a.n_tris, ox0, oy0, oz0, dx0, dy0,
                                     dz0, -1);
    }
    // the camera ray's adjoint, summed over samples
    float go_x = 0.0f, go_y = 0.0f, go_z = 0.0f;
    float gd_x = 0.0f, gd_y = 0.0f, gd_z = 0.0f;

    for (int s = 0; s < a.spp; ++s) {
      // ---- forward replay of K3's walk ----
      int len = 0;
      if (live) {
        float rr = 0.0f, rg = 0.0f, rb = 0.0f;
        len = spath::quality_sample(a, ox0, oy0, oz0, dx0, dy0, dz0, first,
                                    h1, s, rr, rg, rb, Saver{st});
      }
      const uint32_t sc = static_cast<uint32_t>(s) * spath::kC1;

      // ---- reverse sweep, the warp's longest path first ----
      const int depth = __reduce_max_sync(kFull, len);
      float tb_r = 0.0f, tb_g = 0.0f, tb_b = 0.0f;  // thr-bar after bounce b
      float ob_x = 0.0f, ob_y = 0.0f, ob_z = 0.0f;  // o-bar of bounce b + 1
      for (int b = depth - 1; b >= 0; --b) {
        const bool hit = b < len;
        int li = -1;
        if (hit) {
          const Bounce& B = st[b];
          const float* r = tri + B.idx * kQCols;
          const float nx = __ldg(r + 9), ny = __ldg(r + 10),
                      nz = __ldg(r + 11);
          const float ar = __ldg(r + 12), ag = __ldg(r + 13),
                      ab = __ldg(r + 14);
          const float er = __ldg(r + 15), eg = __ldg(r + 16),
                      eb = __ldg(r + 17);
          const float ox = B.ox, oy = B.oy, oz = B.oz;
          const float dx = B.dx, dy = B.dy, dz = B.dz;
          const float dist = B.dist;
          const bool flip = nx * dx + ny * dy + nz * dz > 0.0f;
          const float fs = flip ? -1.0f : 1.0f;
          const float anx = flip ? -nx : nx;
          const float any_ = flip ? -ny : ny;
          const float anz = flip ? -nz : nz;

          // Russian roulette: the continuation carries a detached 1/q
          if (B.rrq > 0.0f) {
            tb_r = tb_r / B.rrq;
            tb_g = tb_g / B.rrq;
            tb_b = tb_b / B.rrq;
          }
          // emitter-hit term and the continuation's albedo
          const float ew = a.nee ? B.w_b : 1.0f;
          const float eb_r = g_r * B.tr * ew;
          const float eb_g = g_g * B.tg * ew;
          const float eb_b = g_b * B.tb * ew;
          float tn_r = tb_r * ar + g_r * er * ew;
          float tn_g = tb_g * ag + g_g * eg * ew;
          float tn_b = tb_b * ab + g_b * eb * ew;
          float alb_r = tb_r * B.tr;
          float alb_g = tb_g * B.tg;
          float alb_b = tb_b * B.tb;
          float nr_x = 0.0f, nr_y = 0.0f, nr_z = 0.0f;
          float pb_x = ob_x, pb_y = ob_y, pb_z = ob_z;
          float* e = stage + lane * kStage;
          float* lt = e + 2 + kSurf;

          if (a.nee && B.li >= 0) {
            li = B.li;
            const float* l = tri + li * kQCols;
            const float su1 = sqrtf(spath::draw(h1, sc, b, 3));
            const float b1 = 1.0f - su1;
            const float b2 = spath::draw(h1, sc, b, 4) * su1;
            const float lv0x = __ldg(l + 0), lv0y = __ldg(l + 1),
                        lv0z = __ldg(l + 2);
            const float le1x = __ldg(l + 3), le1y = __ldg(l + 4),
                        le1z = __ldg(l + 5);
            const float le2x = __ldg(l + 6), le2y = __ldg(l + 7),
                        le2z = __ldg(l + 8);
            const float lnx = __ldg(l + 9), lny = __ldg(l + 10),
                        lnz = __ldg(l + 11);
            const float lem_r = __ldg(l + 15), lem_g = __ldg(l + 16),
                        lem_b = __ldg(l + 17);
            const float lprob = __ldg(l + spath::kColProb);
            const float larea = __ldg(l + spath::kColArea);
            const float misw = B.misw;
            // recompute the NEE geometry
            const float px = ox + dist * dx;
            const float py = oy + dist * dy;
            const float pz = oz + dist * dz;
            const float yx = lv0x + b1 * le1x + b2 * le2x;
            const float yy = lv0y + b1 * le1y + b2 * le2y;
            const float yz = lv0z + b1 * le1z + b2 * le2z;
            const float dlx = yx - px, dly = yy - py, dlz = yz - pz;
            const float r2 = dlx * dlx + dly * dly + dlz * dlz;
            const float rl = sqrtf(fmaxf(r2, spath::kTiny20));
            const float omx = dlx / rl, omy = dly / rl, omz = dlz / rl;
            const float cos_s = anx * omx + any_ * omy + anz * omz;
            const float q = lnx * omx + lny * omy + lnz * omz;
            const float cos_l = fabsf(q);
            const float r2m = fmaxf(r2, spath::kTiny12);
            const float g = cos_s * cos_l / r2m;
            const float wden = fmaxf(lprob, spath::kTiny20);
            const float wgt = larea / wden;
            const float scale = g * wgt * spath::kInvPi * misw;

            // rad_c += tr_c * alb_c * lem_c * scale
            tn_r = tn_r + g_r * ar * lem_r * scale;
            tn_g = tn_g + g_g * ag * lem_g * scale;
            tn_b = tn_b + g_b * ab * lem_b * scale;
            alb_r = alb_r + g_r * B.tr * lem_r * scale;
            alb_g = alb_g + g_g * B.tg * lem_g * scale;
            alb_b = alb_b + g_b * B.tb * lem_b * scale;
            const float lemb_r = g_r * B.tr * ar * scale;
            const float lemb_g = g_g * B.tg * ag * scale;
            const float lemb_b = g_b * B.tb * ab * scale;
            float sbar = 0.0f;
            sbar = sbar + g_r * B.tr * ar * lem_r;
            sbar = sbar + g_g * B.tg * ag * lem_g;
            sbar = sbar + g_b * B.tb * ab * lem_b;
            const float gbar_g = sbar * wgt * spath::kInvPi * misw;
            const float wgtbar = sbar * g * spath::kInvPi * misw;
            const float areabar = wgtbar / wden;
            const float cosbar_s = gbar_g * cos_l / r2m;
            const float cosbar_l = gbar_g * cos_s / r2m;
            float r2bar = r2 >= spath::kTiny12
                              ? -gbar_g * cos_s * cos_l / (r2m * r2m)
                              : 0.0f;
            const float sign_q = q > 0.0f ? 1.0f : (q < 0.0f ? -1.0f : 0.0f);
            const float qbar = sign_q * cosbar_l;
            nr_x = 0.0f + fs * (cosbar_s * omx);
            nr_y = 0.0f + fs * (cosbar_s * omy);
            nr_z = 0.0f + fs * (cosbar_s * omz);
            const float omb_x = cosbar_s * anx + qbar * lnx;
            const float omb_y = cosbar_s * any_ + qbar * lny;
            const float omb_z = cosbar_s * anz + qbar * lnz;
            float dlb_x = omb_x / rl, dlb_y = omb_y / rl, dlb_z = omb_z / rl;
            const float rlbar =
                -(omb_x * dlx + omb_y * dly + omb_z * dlz) / (rl * rl);
            r2bar = r2bar + (r2 >= spath::kTiny20 ? rlbar / (rl + rl) : 0.0f);
            dlb_x = dlb_x + 2.0f * r2bar * dlx;
            dlb_y = dlb_y + 2.0f * r2bar * dly;
            dlb_z = dlb_z + 2.0f * r2bar * dlz;
            pb_x = pb_x - dlb_x;
            pb_y = pb_y - dlb_y;
            pb_z = pb_z - dlb_z;
            // light columns 0-11 (v0, e1, e2, normal), 15-17, 18
            lt[0] = dlb_x;
            lt[1] = dlb_y;
            lt[2] = dlb_z;
            lt[3] = b1 * dlb_x;
            lt[4] = b1 * dlb_y;
            lt[5] = b1 * dlb_z;
            lt[6] = b2 * dlb_x;
            lt[7] = b2 * dlb_y;
            lt[8] = b2 * dlb_z;
            lt[9] = qbar * omx;
            lt[10] = qbar * omy;
            lt[11] = qbar * omz;
            lt[12] = lemb_r;
            lt[13] = lemb_g;
            lt[14] = lemb_b;
            lt[15] = areabar;
          }

          // Moller-Trumbore distance chain
          const float distbar = pb_x * dx + pb_y * dy + pb_z * dz;
          const float v0x = __ldg(r + 0), v0y = __ldg(r + 1),
                      v0z = __ldg(r + 2);
          const float e1x = __ldg(r + 3), e1y = __ldg(r + 4),
                      e1z = __ldg(r + 5);
          const float e2x = __ldg(r + 6), e2y = __ldg(r + 7),
                      e2z = __ldg(r + 8);
          const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
          float hx, hy, hz, tnx, tny, tnz, c1x, c1y, c1z, c2x, c2y, c2z;
          float c3x, c3y, c3z;
          cross(dx, dy, dz, e2x, e2y, e2z, hx, hy, hz);
          const float am = e1x * hx + e1y * hy + e1z * hz;
          const float fa = 1.0f / am;
          const float g1 = distbar * fa;
          cross(e1x, e1y, e1z, e2x, e2y, e2z, tnx, tny, tnz);
          cross(e2x, e2y, e2z, sx, sy, sz, c1x, c1y, c1z);
          cross(sx, sy, sz, e1x, e1y, e1z, c2x, c2y, c2z);
          cross(e1x, e1y, e1z, dx, dy, dz, c3x, c3y, c3z);

          e[0] = __int_as_float(B.idx);
          e[1] = __int_as_float(li);
          float* sf = e + 2;
          sf[0] = -g1 * tnx;
          sf[1] = -g1 * tny;
          sf[2] = -g1 * tnz;
          sf[3] = g1 * (c1x - dist * hx);
          sf[4] = g1 * (c1y - dist * hy);
          sf[5] = g1 * (c1z - dist * hz);
          sf[6] = g1 * (c2x - dist * c3x);
          sf[7] = g1 * (c2y - dist * c3y);
          sf[8] = g1 * (c2z - dist * c3z);
          sf[9] = nr_x;
          sf[10] = nr_y;
          sf[11] = nr_z;
          sf[12] = alb_r;
          sf[13] = alb_g;
          sf[14] = alb_b;
          sf[15] = eb_r;
          sf[16] = eb_g;
          sf[17] = eb_b;

          // the origin's adjoint goes to the bounce before, or at bounce
          // 0 to the camera ray with the direction's
          const float on_x = (0.0f + pb_x) + g1 * tnx;
          const float on_y = (0.0f + pb_y) + g1 * tny;
          const float on_z = (0.0f + pb_z) + g1 * tnz;
          if (b == 0) {
            go_x = go_x + on_x;
            go_y = go_y + on_y;
            go_z = go_z + on_z;
            gd_x = gd_x + (dist * pb_x + g1 * dist * tnx);
            gd_y = gd_y + (dist * pb_y + g1 * dist * tny);
            gd_z = gd_z + (dist * pb_z + g1 * dist * tnz);
          } else {
            ob_x = on_x;
            ob_y = on_y;
            ob_z = on_z;
          }
          tb_r = tn_r;
          tb_g = tn_g;
          tb_b = tn_b;
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        __syncwarp();
        if (lane < kAdj) {
          // lane c owns column c: surface adds, then the light's
          const int lcol = lane < 12 ? lane : (lane >= 15 ? lane - 3 : -1);
          for (unsigned m = hits; m != 0u; m &= m - 1u) {
            const float* x = stage + (__ffs(m) - 1) * kStage;
            if (lane < kSurf) {
              float* p = acc + __float_as_int(x[0]) * kAdj + lane;
              *p = *p + x[2 + lane];
            }
            const int lrow = __float_as_int(x[1]);
            if (lrow >= 0 && lcol >= 0) {
              float* p = acc + lrow * kAdj + lane;
              *p = *p + x[2 + kSurf + lcol];
            }
          }
        }
        __syncwarp();
      }
    }
    if (live) {
      grays[6 * i + 0] = go_x;
      grays[6 * i + 1] = go_y;
      grays[6 * i + 2] = go_z;
      grays[6 * i + 3] = gd_x;
      grays[6 * i + 4] = gd_y;
      grays[6 * i + 5] = gd_z;
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < slice; k += blockDim.x) {
    float sum = smem[k];
    for (int w = 1; w < warps; ++w) sum = sum + smem[w * slice + k];
    partial[blockIdx.x * slice + k] = sum;
  }
}

}  // namespace

extern "C" int spath_quality_backward_grid(int n, int n_tris) {
  const int threads = block_threads(n_tris);
  const int blocks = (n + threads - 1) / threads;
  return blocks < kMaxGrid ? blocks : kMaxGrid;
}

// flags: as spath::make_args takes them.
extern "C" int spath_quality_backward(
    const float* origins, const float* directions, const int64_t* keys,
    const float* tri, const int* rows, const float* gbar, float* partial,
    float* grays, int n, int n_tris, int n_rows, int spp, int max_bounces,
    int rr_start, int flags, float inv_spp, void* stream) {
  const int threads = block_threads(n_tris);
  if (n < 1 || n_tris < 1 || n_rows < 0 || spp < 1 || max_bounces < 0 ||
      max_bounces > kMaxBounces || rr_start < 0 ||
      shared_bytes(n_tris, threads / 32) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QualityArgs a = spath::make_args(tri, rows, n_tris, n_rows, spp,
                                         max_bounces, rr_start, flags,
                                         inv_spp);
  const int smem = shared_bytes(n_tris, threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quality_backward, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  quality_backward<<<spath_quality_backward_grid(n, n_tris), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      origins, directions, keys, gbar, partial, grays, n, a);
  return static_cast<int>(cudaGetLastError());
}
