// One bounce of the quality estimator's reverse sweep, shared by the
// backward kernels K4 (megakernel_quality_grad.cu), which adds its
// adjoints into per-warp shared-memory slices, and K10
// (bigscene_quality_grad.cu), which writes them as events for the stream
// scatter K7. The port of spath_tpu/ops/pallas/megakernel_quality_grad.py::
// _reverse_bounce for one ray, in the JAX kernel's order of operations,
// with g = gbar / spp, tb the adjoint of the throughput after the bounce
// and ob the adjoint of the next bounce's origin:
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
// Built, as the walk, with -fmad=false and without fast math.

#pragma once

#include "quality_walk.cuh"

namespace spath {

// Adjoint columns per triangle: v0, e1, e2, normal, albedo, emission, area.
constexpr int kAdj19 = 19;
// Adjoints a bounce scatters: 18 at the hit triangle (columns 0-17), 16 at
// the light whose term counted (columns 0-11 and 15-18).
constexpr int kSurf = 18;
constexpr int kLight = 16;

__device__ __forceinline__ void cross(float ax, float ay, float az, float bx,
                                      float by, float bz, float& cx,
                                      float& cy, float& cz) {
  cx = ay * bz - az * by;
  cy = az * bx - ax * bz;
  cz = ax * by - ay * bx;
}

// What a bounce hands the bounce before: the adjoint of its origin, and
// (read at bounce 0 only) the camera-ray direction's.
struct ReverseOut {
  float on_x, on_y, on_z;
  float gd_x, gd_y, gd_z;
};

// The reverse step of bounce b, which hit (B, saved by the walk), of the
// sample whose draws are (h1, sc): writes the surface adjoints to
// sf[0..17] and, where the NEE term counted, the light adjoints to
// lt[0..15]; updates tb to the adjoint of the throughput before the
// bounce; fills `out`. Returns the light's row, or -1 when its term did
// not count (lt is then untouched).
__device__ __forceinline__ int reverse_bounce(
    const QualityArgs& a, uint32_t h1, uint32_t sc, int b, const Bounce& B,
    float g_r, float g_g, float g_b, float& tb_r, float& tb_g, float& tb_b,
    float ob_x, float ob_y, float ob_z, float* sf, float* lt,
    ReverseOut& out) {
  const float* __restrict__ tri = a.tri;
  int li = -1;
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

  if (a.nee && B.li >= 0) {
    li = B.li;
    const float* l = tri + li * kQCols;
    const float su1 = sqrtf(draw(h1, sc, b, 3));
    const float b1 = 1.0f - su1;
    const float b2 = draw(h1, sc, b, 4) * su1;
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
    const float lprob = __ldg(l + kColProb);
    const float larea = __ldg(l + kColArea);
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
    const float rl = sqrtf(fmaxf(r2, kTiny20));
    const float omx = dlx / rl, omy = dly / rl, omz = dlz / rl;
    const float cos_s = anx * omx + any_ * omy + anz * omz;
    const float q = lnx * omx + lny * omy + lnz * omz;
    const float cos_l = fabsf(q);
    const float r2m = fmaxf(r2, kTiny12);
    const float g = cos_s * cos_l / r2m;
    const float wden = fmaxf(lprob, kTiny20);
    const float wgt = larea / wden;
    const float scale = g * wgt * kInvPi * misw;

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
    const float gbar_g = sbar * wgt * kInvPi * misw;
    const float wgtbar = sbar * g * kInvPi * misw;
    const float areabar = wgtbar / wden;
    const float cosbar_s = gbar_g * cos_l / r2m;
    const float cosbar_l = gbar_g * cos_s / r2m;
    float r2bar = r2 >= kTiny12
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
    r2bar = r2bar + (r2 >= kTiny20 ? rlbar / (rl + rl) : 0.0f);
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
  out.on_x = on_x;
  out.on_y = on_y;
  out.on_z = on_z;
  out.gd_x = dist * pb_x + g1 * dist * tnx;
  out.gd_y = dist * pb_y + g1 * dist * tny;
  out.gd_z = dist * pb_z + g1 * dist * tnz;
  tb_r = tn_r;
  tb_g = tn_g;
  tb_b = tn_b;
  return li;
}

}  // namespace spath
