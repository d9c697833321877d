// The quality estimator's walk, shared by the forward kernels K3
// (megakernel_quality.cu) and K9 (bigscene_quality.cu) and their backward
// kernels K4 (megakernel_quality_grad.cu) and K10
// (bigscene_quality_grad.cu): each backward kernel replays its forward's
// walk from this one source, so it takes the same hits, draws, lights and
// directions bit for bit. A bounce is two halves around its sweep,
// bounce_begin and bounce_end; quality_sample runs a sample's bounces in
// order (K3, K4), K9, K11 and K10 their queue of paths
// (quality_queue.cuh). The halves are templates over the backend, which
// sweeps for nearest hits and reads the cdf for the light choice
// (search_light, a binary search): TableQuality for K3 and K4 (each
// thread reads the whole table through the cache), StreamQuality for K9,
// K10 and K11 (the CTA stages the table through shared memory,
// stream_sweep.cuh). With the same arithmetic, K9 equals K3 to the bit at
// T <= 1024.
//
// It is the port of spath_tpu/ops/pallas/megakernel_quality.py::
// _sample_walk for one ray: the counter-based hash draws (_hash_draws),
// the emitter term with the MIS partner weight, the cosine-weighted
// direction in the Duff et al. frame, next-event estimation (the light
// choice over the cdf, the barycentric light point, the shadow ray swept
// together with the next bounce's ray from their shared origin, the
// power-heuristic weight), Russian roulette and the MIS pdf of the next
// bounce. Every expression keeps the JAX kernel's order of operations;
// the files that include this header are built with -fmad=false and
// without --use_fast_math.
//
// A masked TPU lane becomes a thread that leaves its loop: once a path
// misses or loses the roulette, every later term of the masked walk is
// zero, so stopping is exact. Under the streamed kernels' CTA-wide sweeps
// the lane starts the next sample or pixel instead.

#pragma once

#include "stream_sweep.cuh"

namespace spath {

// Columns of the (T, 21) quality table: v0, e1, e2, normal, albedo,
// emission, prob (18), area (19), cdf (20).
constexpr int kQCols = 21;
constexpr int kColProb = 18;
constexpr int kColArea = 19;
constexpr int kColCdf = 20;

// float32 values equal to the JAX package's np.float32 constants.
constexpr float kInvPi = 0x1.45f306p-2f;  // float32(1 / pi)
constexpr float kTiny20 = 0x1.79ca10p-67f;  // float32(1e-20)
constexpr float kTiny12 = 0x1.197998p-40f;  // float32(1e-12)
constexpr float kTiny30 = 0x1.4484c0p-100f;  // float32(1e-30)
constexpr float kTiny6 = 0x1.0c6f7ap-20f;  // float32(1e-6)
constexpr float kMillion = 0x1.e84800p+19f;  // float32(1e6)
constexpr float kRrMin = 0x1.99999ap-5f;  // float32(0.05)

// The hash stream's constants (spath_tpu/ops/rng.py).
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kC1 = 0x27D4EB2Fu;
constexpr uint32_t kC2 = 0x165667B1u;
constexpr uint32_t kC3 = 0xD3A2646Cu;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return h ^ (h >> 16);
}

// Draw `d` of bounce `b` for a ray whose first-round hash is h1 = fmix(key)
// and whose sample counter is folded in as sc = sample * C1.
__device__ __forceinline__ float draw(uint32_t h1, uint32_t sc, int b, int d) {
  const uint32_t c = kC2 * static_cast<uint32_t>(b) +
                     kC3 * static_cast<uint32_t>(d);
  const uint32_t h = fmix(h1 + (sc + c));
  return static_cast<float>(static_cast<int>(h >> 8)) * 0x1p-24f;
}

// What the walk reads besides the ray.
struct QualityArgs {
  const float* tri;  // (T, 21)
  const int* rows;   // the rows the light choice searches, ascending
  int n_tris, n_rows, spp, max_bounces, rr_start, n_draws;
  bool nee, mis, stratify;  // mis here means nee && mis
  float inv_spp;            // float32(1 / spp)
};

// The arguments of a launch; flags: bit 0 nee, bit 1 mis (with nee),
// bit 2 stratify.
inline QualityArgs make_args(const float* tri, const int* rows, int n_tris,
                             int n_rows, int spp, int max_bounces,
                             int rr_start, int flags, float inv_spp) {
  QualityArgs a;
  a.tri = tri;
  a.rows = rows;
  a.n_tris = n_tris;
  a.n_rows = n_rows;
  a.spp = spp;
  a.max_bounces = max_bounces;
  a.rr_start = rr_start;
  a.nee = (flags & 1) != 0;
  a.mis = a.nee && (flags & 2) != 0;
  a.stratify = (flags & 4) != 0;
  a.n_draws = (a.nee ? 5 : 2) + (rr_start ? 1 : 0);
  a.inv_spp = inv_spp;
  return a;
}

// The light choice of every quality kernel: the count of light rows whose
// cdf is at or below u, by binary search with PyTorch's upper-bound loop
// (torch.searchsorted(right=True)), over the cdf at the ascending light
// rows, read through cdf_at(k); the light is rows[count], or the last row
// T - 1 when the count is L (u at or above every value). Where the cdf
// does not decrease this is searchsorted(cdf, u, 'right') clipped to
// T - 1 (spath_tpu/ops/nee.py), the walk of the JAX kernels'
// _select_gather_light_static and the count of their _select_light_vmem
// (but for the clip, which there goes to the last light). XLA's CPU
// blocked scan, which the cdf reproduces, can step down by an ulp at a
// block boundary once it has three levels (T > 256); there those three
// can disagree for u inside the step, and this loop is the plain
// version's (megakernel_quality.py: _select_light), so the kernels equal
// it bit for bit at every T. O(log L) loads.
template <class CdfAt>
__device__ __forceinline__ int search_light(CdfAt cdf_at,
                                            const int* __restrict__ rows,
                                            int n_rows, int n_tris, float u) {
  int lo = 0, hi = n_rows;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cdf_at(mid) > u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n_rows ? __ldg(rows + lo) : n_tris - 1;
}

// K3's and K4's backend. Each thread sweeps the whole table through the
// read-only cache on its own (so a path that ended leaves its loop at
// once), and reads the cdf at a light row from the table.
struct TableQuality {
  const float* __restrict__ tri;
  int n_tris;
  const int* __restrict__ rows;
  int n_rows;

  __device__ __forceinline__ Hit one(float ox, float oy, float oz,
                                     float dx, float dy, float dz,
                                     int src) const {
    return nearest<kQCols>(tri, n_tris, ox, oy, oz, dx, dy, dz, src);
  }
  __device__ __forceinline__ void two(float ox, float oy, float oz,
                                      float d1x, float d1y, float d1z,
                                      float d2x, float d2y, float d2z,
                                      int src, Hit& h1, Hit& h2) const {
    nearest2<kQCols>(tri, n_tris, ox, oy, oz, d1x, d1y, d1z, d2x, d2y, d2z,
                     src, h1, h2);
  }
  __device__ __forceinline__ int light(float u) const {
    const float* __restrict__ t = tri;
    const int* __restrict__ r = rows;
    return search_light(
        [t, r](int k) { return __ldg(t + __ldg(r + k) * kQCols + kColCdf); },
        rows, n_rows, n_tris, u);
  }
};

inline __device__ __host__ TableQuality table_quality(const QualityArgs& a) {
  return TableQuality{a.tri, a.n_tris, a.rows, a.n_rows};
}

// K9's, K10's and K11's backend: the streamed sweeps of stream_sweep.cuh
// through the CTA's `tiles` (every thread of the CTA calls them; a thread
// without a live ray only helps stage), and the light choice over `lcdf`,
// the cdf at the light rows gathered into one array.
struct StreamQuality {
  const float* __restrict__ tri;
  int n_tris;
  float* tiles;
  const int* __restrict__ rows;
  const float* __restrict__ lcdf;
  int n_rows;

  // The queue's sweep, whose lanes carry one ray (d1) or, where `two`
  // is set, two from one origin (d1 and d2): two() for every lane if any
  // lane of the CTA carries two, else one(); h2 is a miss for a lane
  // without a second ray. Measured against skipping the second ray's
  // tests lane by lane (8.8% slower on K9's 10k serving frame) and two
  // rays for every lane (7.4% slower), on an H100 (PERF.md).
  __device__ __forceinline__ void mixed(bool live, bool two, float ox,
                                        float oy, float oz, float d1x,
                                        float d1y, float d1z, float d2x,
                                        float d2y, float d2z, int src,
                                        Hit& h1, Hit& h2) const {
    if (__syncthreads_or(live && two)) {
      stream_nearest2<kQCols>(tri, n_tris, tiles, live, ox, oy, oz, d1x, d1y,
                              d1z, d2x, d2y, d2z, src, h1, h2);
      if (!two) h2 = Hit{kBig, -1};
    } else {
      h1 = stream_nearest<kQCols>(tri, n_tris, tiles, live, ox, oy, oz, d1x,
                                  d1y, d1z, src);
      h2 = Hit{kBig, -1};
    }
  }
  __device__ __forceinline__ int light(float u) const {
    const float* __restrict__ c = lcdf;
    return search_light([c](int k) { return __ldg(c + k); }, rows, n_rows,
                        n_tris, u);
  }
};

// One bounce as the reverse sweeps (K4, K10) need it: the ray before the
// bounce, the hit, the throughput before the bounce, the emitter term's
// MIS weight, the light (-1 unless its term counted) with its MIS weight,
// and the roulette's survival probability q when a 1/q reweight followed
// the bounce (0 otherwise).
struct Bounce {
  float ox, oy, oz, dx, dy, dz, dist;
  int idx;
  float tr, tg, tb;
  float w_b, misw;
  int li;
  float rrq;
};

// Does nothing: the forward kernels keep no state.
struct NoSave {
  __device__ __forceinline__ void operator()(int, const Bounce&) const {}
};

// Records the walk's bounces for a reverse sweep (K4, K10).
struct Saver {
  Bounce* st;
  __device__ __forceinline__ void operator()(int b, const Bounce& x) const {
    st[b] = x;
  }
};

// Exports each bounce's nearest hit for the visibility residual (K11:
// bigscene_quality.cu with its export): the hit of bounce b of sample s of
// ray i goes to dist[(s * B + b) * n + i] and idx[...], B = max_bounces.
// The walk hands a bounce to its recorder exactly when the path was alive
// entering it and hit (b < the walk's returned length), so the kernel
// writes the bounces from that length on, where the path had missed or
// ended, as a miss, (kBig, -1): the residual reads a hit only through
// alive & idx >= 0, for which those hold the same as its own sweep's.
// dist and idx point at the sample's bounce 0 of the ray, entries a
// bounce apart are n apart.
struct HitSaver {
  float* dist;
  int* idx;
  size_t n;
  __device__ __forceinline__ void operator()(int b, const Bounce& x) const {
    dist[static_cast<size_t>(b) * n] = x.dist;
    idx[static_cast<size_t>(b) * n] = x.idx;
  }
};

// One sample's walk between its sweeps: the ray into the next hit (origin
// o, direction d, and src, the triangle it leaves, -1 for a camera ray),
// the throughput, the MIS pdf of the direction d (with mis) and the
// radiance gathered so far.
struct QualityPath {
  float ox, oy, oz, dx, dy, dz;
  int src;
  float tr, tg, tb;
  float prev_pdf;
  float rad_r, rad_g, rad_b;

  // A new sample along the camera ray o0 + t d0.
  __device__ __forceinline__ void start(float ox0, float oy0, float oz0,
                                        float dx0, float dy0, float dz0) {
    ox = ox0;
    oy = oy0;
    oz = oz0;
    dx = dx0;
    dy = dy0;
    dz = dz0;
    src = -1;
    tr = 1.0f;
    tg = 1.0f;
    tb = 1.0f;
    prev_pdf = 0.0f;
    rad_r = 0.0f;
    rad_g = 0.0f;
    rad_b = 0.0f;
  }
};

// What a bounce leaves between its two halves: the shadow ray's direction
// om from the hit point (the path's new origin), the light li, whether
// its NEE term counts if the shadow ray reaches the light (lit) and that
// term (c), whether the path goes on after the bounce (more: not its last
// bounce, and not lost to the roulette) and the bounce's record.
struct QualityStep {
  float omx, omy, omz;
  int li;
  bool lit;
  float cr, cg, cb;
  bool more;
  Bounce st;
};

// The first half of bounce b at the hit h of the path's ray, everything
// before the bounce's sweep: the emitter term with its MIS weight, the
// cosine-weighted direction, the light choice with the shadow ray and its
// NEE term, the throughput and the roulette. Moves the path to the hit
// point along the sampled direction (its ray for the next bounce) and
// fills x.
template <class Backend>
__device__ __forceinline__ void bounce_begin(const QualityArgs& a,
                                             const Backend& be, const Hit& h,
                                             int b, uint32_t h1, int s,
                                             QualityPath& p,
                                             QualityStep& x) {
  const float* __restrict__ tri = a.tri;
  const uint32_t sc = static_cast<uint32_t>(s) * kC1;
  const bool last = b == a.max_bounces - 1;
  const float* r = tri + h.idx * kQCols;
  const float nx = __ldg(r + 9), ny = __ldg(r + 10), nz = __ldg(r + 11);
  const float ar = __ldg(r + 12), ag = __ldg(r + 13), ab = __ldg(r + 14);
  const float er = __ldg(r + 15), eg = __ldg(r + 16), eb = __ldg(r + 17);
  const float px = p.ox + h.dist * p.dx;
  const float py = p.oy + h.dist * p.dy;
  const float pz = p.oz + h.dist * p.dz;
  const bool flip = nx * p.dx + ny * p.dy + nz * p.dz > 0.0f;
  const float anx = flip ? -nx : nx;
  const float any_ = flip ? -ny : ny;
  const float anz = flip ? -nz : nz;

  // emitter-hit term (BSDF strategy)
  float w_b = 1.0f;
  if (a.nee) {
    if (b > 0) {
      if (a.mis) {
        const float cos_l_hit = fabsf(nx * p.dx + ny * p.dy + nz * p.dz);
        const float dmin = fminf(h.dist, kMillion);
        const float p_here =
            __ldg(r + kColProb) / fmaxf(__ldg(r + kColArea), kTiny20) *
            dmin * dmin / fmaxf(cos_l_hit, kTiny6);
        w_b = p.prev_pdf * p.prev_pdf /
              fmaxf(p.prev_pdf * p.prev_pdf + p_here * p_here, kTiny30);
      } else {
        w_b = 0.0f;  // pure NEE drops BSDF-sampled emitter hits
      }
    }
    p.rad_r = p.rad_r + p.tr * er * w_b;
    p.rad_g = p.rad_g + p.tg * eg * w_b;
    p.rad_b = p.rad_b + p.tb * eb * w_b;
  } else {
    p.rad_r = p.rad_r + p.tr * er;
    p.rad_g = p.rad_g + p.tg * eg;
    p.rad_b = p.rad_b + p.tb * eb;
  }

  // cosine-weighted direction (ops/sampling.py)
  float u0 = draw(h1, sc, b, 0);
  const float u1 = draw(h1, sc, b, 1);
  if (a.stratify && b == 0) {
    u0 = (static_cast<float>(s) + u0) * a.inv_spp;
  }
  const float phi = u0 * kTwoPi;
  const float rr = sqrtf(fmaxf(1.0f - u1, 0.0f));
  const float z = sqrtf(u1);
  const float sgn = anz >= 0.0f ? 1.0f : -1.0f;
  const float fa = -1.0f / (sgn + anz);
  const float fb = anx * any_ * fa;
  const float tx = 1.0f + sgn * anx * anx * fa;
  const float ty = sgn * fb;
  const float tz = -sgn * anx;
  const float btx = fb;
  const float bty = sgn + any_ * any_ * fa;
  const float btz = -any_;
  const float cp = cosf(phi) * rr;
  const float sp = sinf(phi) * rr;
  const float ndx = tx * cp + btx * sp + anx * z;
  const float ndy = ty * cp + bty * sp + any_ * z;
  const float ndz = tz * cp + btz * sp + anz * z;

  // next-event estimation (ops/nee.py::direct_light): everything but the
  // shadow ray's occlusion, which the sweep gives
  float misw = 1.0f;
  x.li = -1;
  x.lit = false;
  x.omx = 0.0f;
  x.omy = 0.0f;
  x.omz = 0.0f;
  x.cr = 0.0f;
  x.cg = 0.0f;
  x.cb = 0.0f;
  if (a.nee) {
    const int li = be.light(draw(h1, sc, b, 2));
    const float* l = tri + li * kQCols;
    const float su1 = sqrtf(draw(h1, sc, b, 3));
    const float b1 = 1.0f - su1;
    const float b2 = draw(h1, sc, b, 4) * su1;
    const float yx = __ldg(l + 0) + b1 * __ldg(l + 3) + b2 * __ldg(l + 6);
    const float yy = __ldg(l + 1) + b1 * __ldg(l + 4) + b2 * __ldg(l + 7);
    const float yz = __ldg(l + 2) + b1 * __ldg(l + 5) + b2 * __ldg(l + 8);
    const float delx = yx - px, dely = yy - py, delz = yz - pz;
    const float r2 = delx * delx + dely * dely + delz * delz;
    const float rl = sqrtf(fmaxf(r2, kTiny20));
    const float omx = delx / rl, omy = dely / rl, omz = delz / rl;
    const float cos_s = anx * omx + any_ * omy + anz * omz;
    const float cos_l =
        fabsf(__ldg(l + 9) * omx + __ldg(l + 10) * omy + __ldg(l + 11) * omz);
    const float lprob = __ldg(l + kColProb);
    const float larea = __ldg(l + kColArea);
    const float g = cos_s * cos_l / fmaxf(r2, kTiny12);
    const float wgt = larea / fmaxf(lprob, kTiny20);
    float scale = g * wgt * kInvPi;
    if (a.mis) {
      const float p_nee = lprob / fmaxf(larea, kTiny20) * fminf(r2, kBig) /
                          fmaxf(cos_l, kTiny6);
      const float p_bsdf = fmaxf(cos_s, 0.0f) * kInvPi;
      misw = p_nee * p_nee / fmaxf(p_nee * p_nee + p_bsdf * p_bsdf, kTiny30);
    }
    scale = scale * misw;
    x.omx = omx;
    x.omy = omy;
    x.omz = omz;
    x.li = li;
    x.lit = lprob > 0.0f && cos_s > 0.0f && li != h.idx;
    x.cr = p.tr * ar * __ldg(l + 15) * scale;
    x.cg = p.tg * ag * __ldg(l + 16) * scale;
    x.cb = p.tb * ab * __ldg(l + 17) * scale;
  }

  x.st = Bounce{p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, h.dist, h.idx,
                p.tr, p.tg, p.tb, w_b, misw, -1, 0.0f};

  // advance (cosine weight 1: the pdf cancels BRDF * cos)
  p.tr = p.tr * ar;
  p.tg = p.tg * ag;
  p.tb = p.tb * ab;
  p.ox = px;
  p.oy = py;
  p.oz = pz;
  p.dx = ndx;
  p.dy = ndy;
  p.dz = ndz;
  p.src = h.idx;
  x.more = !last;
  if (a.rr_start && b >= a.rr_start && !last) {
    // Russian roulette on the continuation: survive with probability
    // q = max throughput component, reweight by 1/q
    const float q = fminf(fmaxf(fmaxf(fmaxf(p.tr, p.tg), p.tb), kRrMin),
                          1.0f);
    if (!(draw(h1, sc, b, a.n_draws - 1) < q)) {
      x.more = false;
    } else {
      p.tr = p.tr / q;
      p.tg = p.tg / q;
      p.tb = p.tb / q;
      x.st.rrq = q;
    }
  }
  if (a.mis) {
    p.prev_pdf = fmaxf(ndx * anx + ndy * any_ + ndz * anz, 0.0f) * kInvPi;
  }
}

// The second half of bounce b, after its sweep: the NEE term where the
// shadow ray's nearest hit `occ` is the chosen light, then the bounce's
// record to `save`.
template <class Save>
__device__ __forceinline__ void bounce_end(const QualityArgs& a, int b,
                                           int occ, QualityPath& p,
                                           QualityStep& x, Save save) {
  if (a.nee && x.lit && occ == x.li) {
    p.rad_r = p.rad_r + x.cr;
    p.rad_g = p.rad_g + x.cg;
    p.rad_b = p.rad_b + x.cb;
    x.st.li = x.li;
  }
  save(b, x.st);
}

// One sample's walk for one ray through the backend `be` (TableQuality: a
// thread sweeps on its own) from the camera ray's hit h: adds its radiance
// to (rad_r, rad_g, rad_b) and hands each bounce that hit to `save`.
// Returns the number of bounces that hit. Each bounce is bounce_begin, the bounce's sweep, bounce_end (K9,
// K11 and K10 run the same halves in their queue, a lane per path:
// quality_queue.cuh).
//
// The sweeps: with NEE, at each bounce the shadow ray and the next
// bounce's ray together (two), the shadow ray alone (one) at the last;
// without NEE the next bounce's ray (one) from bounce 1 on.
template <class Backend, class Save>
__device__ __forceinline__ int quality_sample(
    const QualityArgs& a, const Backend& be, float ox, float oy, float oz,
    float dx, float dy, float dz, Hit h, uint32_t h1, int s,
    float& rad_r, float& rad_g, float& rad_b, Save save) {
  QualityPath p;
  p.start(ox, oy, oz, dx, dy, dz);
  p.rad_r = rad_r;
  p.rad_g = rad_g;
  p.rad_b = rad_b;
  int len = 0;
  for (int b = 0; b < a.max_bounces; ++b) {
    const bool last = b == a.max_bounces - 1;
    if (b > 0 && !a.nee) {
      h = be.one(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.src);
    }
    if (h.idx < 0) break;
    QualityStep x;
    bounce_begin(a, be, h, b, h1, s, p, x);
    // the shadow ray and, pipelined, the next bounce's nearest hit
    Hit next = h;
    int occ = -1;
    if (a.nee) {
      if (last) {
        occ = be.one(p.ox, p.oy, p.oz, x.omx, x.omy, x.omz, p.src).idx;
      } else {
        Hit shadow;
        be.two(p.ox, p.oy, p.oz, x.omx, x.omy, x.omz, p.dx, p.dy, p.dz,
               p.src, shadow, next);
        occ = shadow.idx;
      }
    }
    bounce_end(a, b, occ, p, x, save);
    len = b + 1;
    if (!x.more && !last) break;  // lost to the roulette
    h = next;
  }
  rad_r = p.rad_r;
  rad_g = p.rad_g;
  rad_b = p.rad_b;
  return len;
}

}  // namespace spath
