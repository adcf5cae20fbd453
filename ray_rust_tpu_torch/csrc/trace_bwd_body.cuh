// Per-pixel body of the trace-mode backward (K2), shared by the CUDA kernel
// (trace_bwd.cu) and a host build (trace_bwd_host.cpp) that the CPU tests
// hold against torch autograd of the plain PyTorch version.
//
// It computes what ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_grads_site
// computes for one pixel: the pixel's cotangent g pulled back to the packed
// scene tables (the 19 f32 columns of every object, the camera and the
// light), for trace-mode scenes, textured or not. The gradient contract is the
// plain version's (ops/trace.py under autograd): the nearest hit's t is a
// function of the winner's own fields, hit/shadow/pattern decisions are
// constants, and a hit at t >= grad_distance_cutoff passes no gradient
// through its point (ops/trace.py, the detach of pt).
//
// Two passes per pixel:
//
// 1. Record: the forward kernel's own traversal (trace_body.cuh:trace_pixel
//    with a SiteRecorder), the same raycasts, shadow tests and task order,
//    saving for every raycast site its ray, its throughput, its flags, its
//    winner, hit and lit, and for every trace task (the camera ray, each
//    refraction sub-trace) its weight in the pixel. It also gives the
//    pixel's colour, the forward kernel's bit for bit.
// 2. Reverse sweep over the sites, last to first. A refraction sub-trace
//    runs after the whole trace that pushed it, and so do all its own
//    sub-traces, so walking the sites backwards finishes every sub-trace
//    before the site that spawned it: that site then finds the sub-trace's
//    colour and the cotangents of its start ray in the sub-trace's record.
//    Each site recomputes its forward values from its record (t from the
//    winner's fields alone, as the JAX replay does: the raycast computed
//    the same expression, so it is the same float) and runs the hand-written
//    adjoint of each step: the bounce, the refraction bend and blend, the
//    accumulation with its IGNORE masks, Lambert and Phong (powf), the uv map
//    and the pattern or the texture (only its bilinear weights depend on uv:
//    the u8 texels are constants, re-read from the atlas rather than
//    recorded, and a textured hit passes no cotangent to the material's
//    diffuse colour), the normal, pt = vi + eye*t and the sphere or floor t;
//    a miss runs the sky's adjoint. The camera ray's adjoint (quaternion
//    rotation, normalize) ends the sweep. The part from the hit point on
//    (shade_adj) is shared with the march backward (march_bwd_body.cuh).
//
// The body hands its cotangents to an accumulator ``acc`` a whole row at a
// time: each hit's 19 field cotangents to its winner's row through
// ``acc.add_row(row, g_row)``, and at the end the pixel's camera and light
// cotangents (CAM_GRADS of them, kept in registers through the sweep)
// through ``acc.add_cam(n, g_cam)``. The host build (trace_bwd_host.cpp)
// adds each nonzero entry as it comes; the kernel (trace_bwd.cu) sums each
// row over the lanes of a warp that add to it before one lane adds to the
// block. ``acc.add(row, col, v)`` adds one entry (the overflow's poison).
//
// The records are sized from the config: trace_pixel_grad<CAP> keeps CAP
// sites and CAP tasks (a task holds at least one site) in two local arrays,
// 56 and 48 bytes a record, and the kernel is built for each cap of
// SITE_CAPS; ops/kernel_trace_bwd.py launches the smallest cap at or above
// the config's site count (count_sites: 11 at the default config, 191 at 6
// reflections and refraction_unroll=None, the most the forward kernel
// takes). A record that would overflow turns the pixel and the block to NaN
// rather than drop a site.
//
// A build with -DRT_COUNT_OPS also counts each pixel's sites into
// SceneView::ops[4] and keeps the most sites of one pixel in ops[5]
// (trace_bwd_host.cpp counts the accumulator's adds into ops[2..3]).
//
// Every function is forced inline (RT_AD), so the kernel is one straight
// program: real device calls between the march kernel's levels faulted on
// the card (ROADMAP queue 3), and chip_smoke.py fails when ptxas reports a
// function of trace_bwd.cu besides the kernel.
#pragma once

#include <type_traits>

#include "trace_body.cuh"

#ifdef __CUDACC__
#define RT_AD __host__ __device__ __forceinline__
#else
#define RT_AD inline
#endif

namespace rt {

// Row width of the cotangent block: rows 0..n-1 hold the objects' 19
// columns, row n the camera position xyz and rotation xyzw, then the light
// xyz (CAM_GRADS columns).
constexpr int GRAD_COLS = 20;
constexpr int CAM_GRADS = 10;

// Call ``f(std::integral_constant<int, CAP>{})`` for the record cap ``cap``,
// one of the caps the kernel is built for (ops/kernel_trace_bwd.py:
// SITE_CAPS); returns f's result, or -1 for another cap.
template <class F>
inline int with_site_cap(int cap, F&& f) {
  switch (cap) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 192:
      return f(std::integral_constant<int, 192>{});
  }
  return -1;
}

RT_AD void acc3(V3* a, V3 b) {
  a->x += b.x;
  a->y += b.y;
  a->z += b.z;
}

// Cotangent of v under y = normalized(v) (vec3.rs:36-39): y_i = v_i / ln,
// ln = sqrt(v.v); 0 where v = 0, as the plain version's guard gives.
RT_AD V3 normalized_adj(V3 v, V3 gy) {
  float sq = dot(v, v);
  if (!(sq > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  float ln = sqrtf(sq);
  float gln = -dot(gy, v) / (ln * ln);
  float gsq = gln / (2.0f * ln);
  return v3(gy.x / ln + 2.0f * v.x * gsq, gy.y / ln + 2.0f * v.y * gsq,
            gy.z / ln + 2.0f * v.z * gsq);
}

// Cotangents of both factors of the Hamilton product q = a * b.
RT_AD void qmul_adj(Q4 a, Q4 b, Q4 g, Q4* ga, Q4* gb) {
  ga->x = g.x * b.w - g.y * b.z + g.z * b.y - g.w * b.x;
  ga->y = g.x * b.z + g.y * b.w - g.z * b.x - g.w * b.y;
  ga->z = -g.x * b.y + g.y * b.x + g.z * b.w - g.w * b.z;
  ga->w = g.x * b.x + g.y * b.y + g.z * b.z + g.w * b.w;
  gb->x = g.x * a.w + g.y * a.z - g.z * a.y - g.w * a.x;
  gb->y = -g.x * a.z + g.y * a.w + g.z * a.x - g.w * a.y;
  gb->z = g.x * a.y - g.y * a.x + g.z * a.w - g.w * a.z;
  gb->w = g.x * a.x + g.y * a.y + g.z * a.z + g.w * a.w;
}

// d/dx of the Cephes atan polynomial (cephes_atan), times g. |x| has slope
// 0 at x = 0, as torch.abs's gradient.
RT_AD float cephes_atan_adj(float x, float g) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  float a = fabsf(x);
  float xr;
  int branch;
  if (a > TAN3PIO8_F) {
    xr = -1.0f / a;
    branch = 2;
  } else if (a > TANPIO8_F) {
    xr = (a - 1.0f) / (a + 1.0f);
    branch = 1;
  } else {
    xr = a;
    branch = 0;
  }
  float z = xr * xr;
  float q3 = 8.05374449538e-2f * z - 1.38776856032e-1f;
  float q2 = q3 * z + 1.99777106478e-1f;
  float q1 = q2 * z - 3.33329491539e-1f;
  float pz = q1 * z;  // p = pz * xr + xr
  float gp = g * sign;
  float gxr = gp * pz + gp;
  float gpz = gp * xr;
  float gz = gpz * q1;
  float gq1 = gpz * z;
  gz += gq1 * q2;
  float gq2 = gq1 * z;
  gz += gq2 * q3;
  float gq3 = gq2 * z;
  gz += gq3 * 8.05374449538e-2f;
  gxr += 2.0f * xr * gz;
  float ga;
  if (branch == 2) {
    ga = gxr / (a * a);
  } else if (branch == 1) {
    ga = gxr / (a + 1.0f) - gxr * (a - 1.0f) / ((a + 1.0f) * (a + 1.0f));
  } else {
    ga = gxr;
  }
  return x > 0.0f ? ga : (x < 0.0f ? -ga : 0.0f);
}

// Adds the cotangents of y and x under cephes_atan2(y, x), times g; none on
// the x = 0 axis, where the forward is a constant.
RT_AD void cephes_atan2_adj(float y, float x, float g, float* gy, float* gx) {
  if (x == 0.0f) return;
  float gq = cephes_atan_adj(y / x, g);
  *gy += gq / x;
  *gx += -gq * y / (x * x);
}

// d/dx of the Cephes asin polynomial (cephes_asin), times g; 0 where
// |x| > 1 (its clamp).
RT_AD float cephes_asin_adj(float x, float g) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  float ax = fabsf(x);
  float a = fminf(ax, 1.0f);
  bool big = a > 0.5f;
  float z = big ? 0.5f * (1.0f - a) : a * a;
  float xr = big ? sqrtf(z) : a;
  float r5 = 4.2163199048e-2f * z + 2.4181311049e-2f;
  float r4 = r5 * z + 4.5470025998e-2f;
  float r3 = r4 * z + 7.4953002686e-2f;
  float r2 = r3 * z + 1.6666752422e-1f;
  float rz = r2 * z;  // p = rz * xr + xr
  float gp = g * sign * (big ? -2.0f : 1.0f);
  float gxr = gp * rz + gp;
  float grz = gp * xr;
  float gz = grz * r2;
  float gr2 = grz * z;
  gz += gr2 * r3;
  float gr3 = gr2 * z;
  gz += gr3 * r4;
  float gr4 = gr3 * z;
  gz += gr4 * r5;
  float gr5 = gr4 * z;
  gz += gr5 * 4.2163199048e-2f;
  float ga;
  if (big) {
    gz += gxr / (2.0f * xr);
    ga = -0.5f * gz;
  } else {
    ga = gxr + 2.0f * a * gz;
  }
  if (!(ax <= 1.0f)) ga = 0.0f;
  return x > 0.0f ? ga : (x < 0.0f ? -ga : 0.0f);
}

// Adds the cotangents of the light and of the direction d under
// background(bg, light, d) (ops/sky.py:default_sky), for colour cotangent g.
RT_AD void background_adj(int bg, V3 light, V3 d, C3 g, V3* g_light, V3* g_d) {
  if (bg == BG_BLACK) return;
  float ld = dot(light, d);
  if (ld > 0.9995f) return;  // the sun: a constant
  float phi = cephes_atan2(d.z, d.x);
  float dyc = fminf(fmaxf(d.y, -1.0f), 1.0f);
  float the = cephes_asin(dyc);
  float dp = fmodf(SKY_A + phi * 10.0f * PI_F, TWO_PI_F) - PI_F;
  float dt = fmodf(SKY_A + the * 10.0f * PI_F, TWO_PI_F) - PI_F;
  float den = 15.0f * (dp * dp * dt * dt) + 1.0f;  // base_r = 0.5 / den
  float gprod = 15.0f * (-g.r * 0.5f / (den * den));
  float gphi = gprod * 2.0f * dp * dt * dt * 10.0f * PI_F;
  float gthe = gprod * 2.0f * dt * dp * dp * 10.0f * PI_F;
  cephes_atan2_adj(d.z, d.x, gphi, &g_d->z, &g_d->x);
  if (d.y >= -1.0f && d.y <= 1.0f) g_d->y += cephes_asin_adj(dyc, gthe);
  g_d->y += -(g.g + g.b) / 4.0f;  // base_gb = 0.25 - d.y / 4
  float gld = 0.0f;
  if (ld > 0.995f) gld += (g.r + g.g + g.b) * 150.0f;  // glare
  if (ld > 0.9f) gld += (g.r + g.g) * 5.0f;             // dot2
  acc3(g_light, scale(d, gld));
  acc3(g_d, scale(light, gld));
}

// Adds the cotangents of ri and pn under (pn != 0 && ri > 0) ? powf(ri, pn) : 0.
RT_AD void pow_adj(float ri, float pn, float g, float* g_ri, float* g_pn) {
  if (!(pn != 0.0f && ri > 0.0f)) return;
  *g_ri += g * pn * powf(ri, pn - 1.0f);
  *g_pn += g * powf(ri, pn) * logf(ri);
}

// The refraction bend (render.rs:1093-1110): ray = normalized(eye + n*bend),
// bend = sp*((sp > 0 ? fracn : 1/fracn) - 1), sp = eye.n, fracn = refraction
// (1 where |refraction| <= 1e-6). Adds the cotangents of eye, n and the
// refraction column for ray cotangent g_ray.
RT_AD void bend_adj(V3 eye, V3 n, float refr, V3 g_ray, V3* g_eye, V3* g_n, float* g_refr) {
  bool ok = fabsf(refr) > 1e-6f;
  float fracn = ok ? refr : 1.0f;
  float sp = dot(eye, n);
  float r = sp > 0.0f ? fracn : 1.0f / fracn;
  float bend = sp * (r - 1.0f);
  V3 a = add(eye, v3(n.x * bend, n.y * bend, n.z * bend));
  V3 ga = normalized_adj(a, g_ray);
  acc3(g_eye, ga);
  acc3(g_n, scale(ga, bend));
  float gbend = dot(ga, n);
  float gsp = gbend * (r - 1.0f);
  float gr = gbend * sp;
  if (ok) *g_refr += sp > 0.0f ? gr : -gr / (fracn * fracn);
  acc3(g_eye, scale(n, gsp));
  acc3(g_n, scale(eye, gsp));
}

// Cotangent of the camera quaternion under camera_ray, for eye cotangent g_eye.
RT_AD Q4 camera_ray_adj(int xres, int yres, float sx, float sy, const float* cam, int ix,
                        int iy, V3 g_eye) {
  float ey = (float)(ix - xres / 2) * sx / (float)xres;
  float ez = -(float)(iy - yres / 2) * sy / (float)yres;
  Q4 q = {cam[3], cam[4], cam[5], cam[6]};
  Q4 qc = {-q.x, -q.y, -q.z, q.w};
  Q4 e = {1.0f, ey, ez, 0.0f};
  Q4 qe = qmul(q, e);
  Q4 r = qmul(qe, qc);
  V3 gr3 = normalized_adj(v3(r.x, r.y, r.z), g_eye);
  Q4 gr = {gr3.x, gr3.y, gr3.z, 0.0f};
  Q4 gqe, gqc, gq, ge;
  qmul_adj(qe, qc, gr, &gqe, &gqc);
  qmul_adj(q, e, gqe, &gq, &ge);
  gq.x -= gqc.x;
  gq.y -= gqc.y;
  gq.z -= gqc.z;
  gq.w += gqc.w;
  return gq;
}

// Adds the cotangents of vi, eye and the winner's row ``g_row`` (org,
// normal, radius) under t = candidate_t(o, kind, vi, eye, +inf, flags), for
// t cotangent g_t.
RT_AD void candidate_t_adj(const float* o, int kind, V3 vi, V3 eye, int flags, float g_t,
                           V3* g_vi, V3* g_eye, float* g_row) {
  V3 wpt = sub(vi, v3(o[0], o[1], o[2]));
  V3 g_wpt;
  if (kind == KIND_SPHERE) {
    float r = o[17];
    float b = 2.0f * dot(eye, wpt);
    float c = dot(wpt, wpt) - r * r;
    float d = sqrtf(b * b - 4.0f * c);
    float t0 = (-b - d) / 2.0f;
    bool near = !(flags & OUTONLY) && t0 >= 0.0f;  // else the far root t0 + d
    float gd = (near ? 0.0f : g_t) - g_t / 2.0f;
    float gb = -g_t / 2.0f;
    float gd2 = gd / (2.0f * d);
    gb += 2.0f * b * gd2;
    float gc = -4.0f * gd2;
    g_wpt = add(scale(wpt, 2.0f * gc), scale(eye, 2.0f * gb));
    acc3(g_eye, scale(wpt, 2.0f * gb));
    g_row[17] += -2.0f * r * gc;
  } else {
    V3 nrm = v3(o[3], o[4], o[5]);
    float w = dot(nrm, eye);
    float num = -dot(nrm, wpt);
    float gnum = g_t / w;
    float gw = -g_t * num / (w * w);
    g_wpt = scale(nrm, -gnum);
    acc3(g_eye, scale(nrm, gw));
    g_row[3] += -gnum * wpt.x + gw * eye.x;
    g_row[4] += -gnum * wpt.y + gw * eye.y;
    g_row[5] += -gnum * wpt.z + gw * eye.z;
  }
  acc3(g_vi, g_wpt);
  g_row[0] -= g_wpt.x;
  g_row[1] -= g_wpt.y;
  g_row[2] -= g_wpt.z;
}

// Adds the cotangents of rel, pattern_scale and pattern_angle_scale under
// get_uv, for (u, v) cotangents (gu, gv). At a lat-long pole (rel.x = rel.z
// = 0) sqrt has no slope; the plain version's guard gives 0 there too.
RT_AD void get_uv_adj(V3 rel, int uvmap, float ps, float pas, float gu, float gv, V3* grel,
                      float* gps, float* gpas) {
  if (uvmap == UVMAP_LL) {
    float q = rel.x * rel.x + rel.z * rel.z;
    float sq = sqrtf(q);
    float au = cephes_atan2(rel.z, rel.x);
    float av = cephes_atan2(sq, rel.y);
    *gpas += -gu * au / (pas * pas) - gv * av / (pas * pas);
    cephes_atan2_adj(rel.z, rel.x, gu / pas, &grel->z, &grel->x);
    float gsq = 0.0f;
    cephes_atan2_adj(sq, rel.y, gv / pas, &gsq, &grel->y);
    if (q > 0.0f) {
      float gq = gsq / (2.0f * sq);
      grel->x += 2.0f * rel.x * gq;
      grel->z += 2.0f * rel.z * gq;
    }
    return;
  }
  // u = cu / ps, v = cv / ps for the two coordinates the map picks
  float* gcu;
  float* gcv;
  float cu, cv;
  if (uvmap == UVMAP_YZ) {
    cu = rel.y, cv = rel.z, gcu = &grel->y, gcv = &grel->z;
  } else if (uvmap == UVMAP_ZX) {
    cu = rel.z, cv = rel.x, gcu = &grel->z, gcv = &grel->x;
  } else {
    cu = rel.x, cv = rel.y, gcu = &grel->x, gcv = &grel->y;
  }
  *gcu += gu / ps;
  *gcv += gv / ps;
  *gps += -gu * cu / (ps * ps) - gv * cv / (ps * ps);
}

// Adds the cotangents of the diffuse colour (g_row[6..8]) and of (u, v)
// under pattern_diffuse, for colour cotangent g.
RT_AD void pattern_diffuse_adj(const float* o, int pattern, float u, float v, C3 g,
                               float* g_row, float* gu, float* gv) {
  if (pattern == PATTERN_GRADATION) {
    g_row[6] += g.r * floor_mod(u, 1.0f);
    g_row[7] += g.g * floor_mod(v, 1.0f);
    g_row[8] += g.b;
    *gu += g.r * o[6];
    *gv += g.g * o[7];
    return;
  }
  if (pattern == PATTERN_CHECKERBOARD && ((floor_to_int(u) ^ floor_to_int(v)) & 1) == 0) return;
  g_row[6] += g.r;
  g_row[7] += g.g;
  g_row[8] += g.b;
}

// Adds the cotangents of (u, v) under fetch_texture (trace_body.cuh), for
// colour cotangent g: Bilinear through its weights (d fu/du = w, d fv/dv =
// h, the floors' slopes being 0, as torch's), Nearest none.
RT_AD void fetch_texture_adj(const TexArgs& tx, int tid, float u, float v, C3 g, float* gu,
                             float* gv) {
  bool bilin;
  float fu = 0.0f, fv = 0.0f;
  const int k = texel_index(tx, tid, u, v, &bilin, &fu, &fv);
  if (!bilin) return;
  const Texel4 q = load_texel(tx.tex + k);
  const C3 p00 = unpack_tap(q.p00), p10 = unpack_tap(q.p10), p01 = unpack_tap(q.p01),
           p11 = unpack_tap(q.p11);
  const C3 gp = c3(g.r / 256.0f, g.g / 256.0f, g.b / 256.0f);
  // p = (1-fu)(1-fv) p00 + (1-fu) fv p01 + fu (1-fv) p10 + fu fv p11, per channel
  const float gfu = gp.r * ((1.0f - fv) * (p10.r - p00.r) + fv * (p11.r - p01.r)) +
                    gp.g * ((1.0f - fv) * (p10.g - p00.g) + fv * (p11.g - p01.g)) +
                    gp.b * ((1.0f - fv) * (p10.b - p00.b) + fv * (p11.b - p01.b));
  const float gfv = gp.r * ((1.0f - fu) * (p01.r - p00.r) + fu * (p11.r - p10.r)) +
                    gp.g * ((1.0f - fu) * (p01.g - p00.g) + fu * (p11.g - p10.g)) +
                    gp.b * ((1.0f - fu) * (p01.b - p00.b) + fu * (p11.b - p10.b));
  const int* m = tx.meta + TEX_META_COLS * (tid < tx.n_tex ? tid : tx.n_tex - 1);
  *gu += gfu * static_cast<float>(m[0]);
  *gv += gfv * static_cast<float>(m[1]);
}

// A raycast site's record.
struct Site {
  V3 vi, eye;  // its ray
  C3 fcs;      // the throughput before it
  int flags, idx;
  int task;    // the trace it belongs to
  int child;   // the refraction sub-trace it pushed, or -1
  bool hit, lit;
};

// A trace task's record: the camera ray's trace or a refraction sub-trace.
struct TaskRec {
  C3 w;            // weight of its colour in the pixel
  C3 col;          // its colour, summed by the reverse sweep
  V3 g_vi, g_eye;  // cotangents of its start ray, from the reverse sweep
};

// The recorder trace_task calls (trace_body.cuh): up to CAP sites and CAP
// tasks in execution order, the traversal's task stack holding STACK_.
template <int CAP, int STACK_ = STACK_CAP>
struct SiteRecorder {
  static constexpr int STACK = STACK_;
  Site* sites;
  TaskRec* tasks;
  int n_sites, n_tasks;
  bool overflow;

  RT_AD void task(const Task& tk) {
    if (n_tasks >= CAP) {  // a task holds at least one site, so never
      overflow = true;
      return;
    }
    tasks[n_tasks].w = tk.w;
    if (tk.parent >= 0) sites[tk.parent].child = n_tasks;
    ++n_tasks;
  }

  RT_AD int site(V3 vi, V3 eye, C3 fcs, int flags, int idx, bool hit, bool lit) {
    if (n_sites >= CAP || overflow) {
      overflow = true;
      return -1;
    }
    Site& st = sites[n_sites];
    st.vi = vi;
    st.eye = eye;
    st.fcs = fcs;
    st.flags = flags;
    st.idx = idx;
    st.task = n_tasks - 1;
    st.child = -1;
    st.hit = hit;
    st.lit = lit;
    return n_sites++;
  }
};

// The adjoint of a shading site from its hit point on, shared with the march
// backward (march_bwd_body.cuh): object row ``o``/``oi`` hit at ``pt`` by a
// ray along ``eye`` with throughput ``fcs`` before it, shaded with shadow
// outcome ``lit``; ``has_child`` when its refraction sub-trace ran, whose
// colour is ``ch_col`` and whose start-ray cotangents are ``ch_g_vi``,
// ``ch_g_eye``. ``gc`` is the cotangent of its trace's colour, ``*g_fcs``
// that of the throughput after it (in: from the trace's next site; out:
// before it), ``g_next_vi`` and ``g_next_eye`` those of the bounced ray when
// the trace went on (``cont``). Adds the site's colour to ``*col``, its light
// cotangent to ``*g_light``, its object's field cotangents to ``g_row``, and
// returns the cotangents of ``pt`` in ``*gpt`` and of ``eye`` in ``*ge``.
// ``TEX``: whether the hit may read a texture (the trace backward and the
// textured march backward); the untextured march backward leaves it false.
template <bool TEX = false>
RT_AD void shade_adj(const SceneView& s, const float* o, const int* oi, V3 eye, V3 pt, C3 fcs,
                     int flags, bool lit, bool has_child, C3 ch_col, V3 ch_g_vi, V3 ch_g_eye,
                     bool cont, C3 gc, V3 g_next_vi, V3 g_next_eye, C3* g_fcs, C3* col,
                     V3* gpt_out, V3* ge_out, V3* g_light, float* g_row) {
  const int kind = oi[0];
  const V3 light = s.light;

  // the site's forward, as trace_task computed it
  V3 rel = sub(pt, v3(o[0], o[1], o[2]));
  V3 n = surface_normal(o, kind, pt);
  float li = dot(light, n);
  float ln2 = 2.0f * li;
  V3 rtl = sub(v3(n.x * ln2, n.y * ln2, n.z * ln2), light);
  float di = fmaxf(li, 0.0f);
  float pn = o[12];
  float ri = -dot(rtl, eye);
  float refl = (pn != 0.0f && ri > 0.0f) ? powf(ri, pn) : 0.0f;
  float k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
  float k2 = lit ? refl : 0.0f;
  float u, v;
  get_uv(rel, oi[2], o[15], o[16], &u, &v);
  const bool tex = TEX && textured(s, oi);
  C3 kd = tex ? fetch_texture(s.tx, oi[3], u, v) : pattern_diffuse(o, oi[1], u, v);
  C3 base = c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);
  const float f = o[13];
  C3 face = base;
  if (has_child)
    face = c3(base.r * (1.0f - f) + ch_col.r * f, base.g * (1.0f - f) + ch_col.g * f,
              base.b * (1.0f - f) + ch_col.b * f);

  // accumulate with the per-channel IGNORE guards
  C3 gface = c3(0.0f, 0.0f, 0.0f);
  if (!(flags & RIGNORE)) {
    col->r += face.r * fcs.r;
    gface.r = gc.r * fcs.r;
    g_row[9] = g_fcs->r * fcs.r;
    g_fcs->r = gc.r * face.r + g_fcs->r * o[9];
  }
  if (!(flags & GIGNORE)) {
    col->g += face.g * fcs.g;
    gface.g = gc.g * fcs.g;
    g_row[10] = g_fcs->g * fcs.g;
    g_fcs->g = gc.g * face.g + g_fcs->g * o[10];
  }
  if (!(flags & BIGNORE)) {
    col->b += face.b * fcs.b;
    gface.b = gc.b * fcs.b;
    g_row[11] = g_fcs->b * fcs.b;
    g_fcs->b = gc.b * face.b + g_fcs->b * o[11];
  }

  V3 gpt = v3(0.0f, 0.0f, 0.0f), gn = v3(0.0f, 0.0f, 0.0f), ge = v3(0.0f, 0.0f, 0.0f);
  if (cont) {  // mirror bounce: vi' = pt, eye' = eye + n*en2, en2 = -2 eye.n
    float en2 = -2.0f * dot(eye, n);
    acc3(&gpt, g_next_vi);
    acc3(&ge, g_next_eye);
    acc3(&gn, scale(g_next_eye, en2));
    float gen2 = -2.0f * dot(g_next_eye, n);
    acc3(&ge, scale(n, gen2));
    acc3(&gn, scale(eye, gen2));
  }

  C3 gbase = gface;
  if (has_child) {  // face = base*(1 - f) + col_child*f; child starts at pt + ray*eps
    gbase = c3(gface.r * (1.0f - f), gface.g * (1.0f - f), gface.b * (1.0f - f));
    g_row[13] += gface.r * (ch_col.r - base.r) + gface.g * (ch_col.g - base.g) +
                 gface.b * (ch_col.b - base.b);
    acc3(&gpt, ch_g_vi);
    V3 gray = add(scale(ch_g_vi, F32_EPS), ch_g_eye);
    bend_adj(eye, n, o[14], gray, &ge, &gn, &g_row[14]);
  }

  // base = kd*k1 + k2; kd from the texture or the pattern at uv
  C3 gkd = c3(gbase.r * k1, gbase.g * k1, gbase.b * k1);
  float gk1 = gbase.r * kd.r + gbase.g * kd.g + gbase.b * kd.b;
  float gk2 = gbase.r + gbase.g + gbase.b;
  float gu = 0.0f, gv = 0.0f;
  if (tex)
    fetch_texture_adj(s.tx, oi[3], u, v, gkd, &gu, &gv);
  else
    pattern_diffuse_adj(o, oi[1], u, v, gkd, g_row, &gu, &gv);
  V3 grel = v3(0.0f, 0.0f, 0.0f);
  get_uv_adj(rel, oi[2], o[15], o[16], gu, gv, &grel, &g_row[15], &g_row[16]);

  // Lambert + Phong
  float gdi = 0.0f, grefl = 0.0f;
  if (lit) {
    if (0.2f + di <= 1.0f) gdi = gk1;
    grefl = gk2;
  }
  float gri = 0.0f;
  pow_adj(ri, pn, grefl, &gri, &g_row[12]);
  V3 grtl = scale(eye, -gri);
  acc3(&ge, scale(rtl, -gri));
  acc3(&gn, scale(grtl, ln2));
  float gli = 2.0f * dot(grtl, n) + (li >= 0.0f ? gdi : 0.0f);
  g_light->x += -grtl.x + gli * n.x;
  g_light->y += -grtl.y + gli * n.y;
  g_light->z += -grtl.z + gli * n.z;
  acc3(&gn, scale(light, gli));

  // the normal, then rel = pt - org
  if (kind == KIND_SPHERE) acc3(&grel, normalized_adj(rel, gn));
  else {
    g_row[3] += gn.x;
    g_row[4] += gn.y;
    g_row[5] += gn.z;
  }
  acc3(&gpt, grel);
  g_row[0] -= grel.x;
  g_row[1] -= grel.y;
  g_row[2] -= grel.z;
  *gpt_out = gpt;
  *ge_out = ge;
}

// The reverse sweep's step for a shading site (a hit): shade_adj at the hit
// point pt = vi + eye*t, then pt's cotangent through t (a constant past the
// cutoff). Arguments as shade_adj's, the child read from ``tasks``; adds the
// winner's field cotangents through ``acc`` and returns the cotangents of
// the site's own ray in ``*g_vi``, ``*g_eye``.
template <class Acc>
RT_AD void hit_adj(const SceneView& s, float cutoff, const Site& st, const TaskRec* tasks,
                   bool cont, C3 gc, V3 g_next_vi, V3 g_next_eye, C3* g_fcs, C3* col,
                   V3* g_vi, V3* g_eye, V3* g_light, Acc& acc) {
  const float* o = s.f32 + st.idx * F32_COLS;
  const int* oi = s.i32 + st.idx * I32_COLS;
  const int kind = oi[0];
  const V3 vi = st.vi, eye = st.eye;
  float t = candidate_t(o, kind, vi, eye, INFINITY, st.flags);
  V3 pt = add(vi, scale(eye, t));

  float g_row[F32_COLS];
  for (int k = 0; k < F32_COLS; ++k) g_row[k] = 0.0f;
  const TaskRec* ch = st.child >= 0 ? &tasks[st.child] : nullptr;
  const C3 zc = c3(0.0f, 0.0f, 0.0f);
  const V3 zv = v3(0.0f, 0.0f, 0.0f);
  V3 gpt, ge;
  shade_adj<true>(s, o, oi, eye, pt, st.fcs, st.flags, st.lit, ch != nullptr,
                  ch ? ch->col : zc, ch ? ch->g_vi : zv, ch ? ch->g_eye : zv, cont, gc,
                  g_next_vi, g_next_eye, g_fcs, col, &gpt, &ge, g_light, g_row);

  // pt = vi + eye*t, a constant past the cutoff
  V3 gvi = v3(0.0f, 0.0f, 0.0f);
  if (t < cutoff) {
    acc3(&gvi, gpt);
    acc3(&ge, scale(gpt, t));
    candidate_t_adj(o, kind, vi, eye, st.flags, dot(gpt, eye), &gvi, &ge, g_row);
  }
  acc.add_row(st.idx, g_row);
  *g_vi = gvi;
  *g_eye = ge;
}

// The pixel's cotangent g pulled back to the scene tables through ``acc``
// (rows 0..n-1: the objects' 19 columns; row n: camera, light), recording
// at most CAP sites, its traversal's task stack holding STACK tasks. Returns
// the pixel's colour (trace_pixel's).
template <int CAP, int STACK = STACK_CAP, class Acc>
RT_AD C3 trace_pixel_grad(const SceneView& s, const Params& p, float cutoff, const float* cam,
                          int ix, int iy, C3 g, Acc& acc) {
  Site sites[CAP];
  TaskRec tasks[CAP];
  SiteRecorder<CAP, STACK> rec;
  rec.sites = sites;
  rec.tasks = tasks;
  rec.n_sites = 0;
  rec.n_tasks = 0;
  rec.overflow = false;
  C3 out = trace_pixel(s, p, cam, ix, iy, rec);
  if (rec.overflow) {  // unreachable at the wrapper's cap: poison, never drop a site
    acc.add(s.n, 0, nanf(""));
    return c3(nanf(""), nanf(""), nanf(""));
  }
#ifdef RT_COUNT_OPS
  s.ops[4] += rec.n_sites;
  if (static_cast<unsigned long long>(rec.n_sites) > s.ops[5]) s.ops[5] = rec.n_sites;
#endif

  V3 g_light = v3(0.0f, 0.0f, 0.0f);
  V3 g_vi = v3(0.0f, 0.0f, 0.0f), g_eye = v3(0.0f, 0.0f, 0.0f);
  C3 g_fcs = c3(0.0f, 0.0f, 0.0f), col = c3(0.0f, 0.0f, 0.0f);
  for (int i = rec.n_sites - 1; i >= 0; --i) {
    const Site& st = sites[i];
    TaskRec& tk = tasks[st.task];
    const bool cont = i + 1 < rec.n_sites && sites[i + 1].task == st.task;
    if (!cont) {  // the trace's last site
      g_vi = g_eye = v3(0.0f, 0.0f, 0.0f);
      g_fcs = col = c3(0.0f, 0.0f, 0.0f);
    }
    C3 gc = c3(g.r * tk.w.r, g.g * tk.w.g, g.b * tk.w.b);
    if (st.hit) {
      hit_adj(s, cutoff, st, tasks, cont, gc, g_vi, g_eye, &g_fcs, &col, &g_vi, &g_eye,
              &g_light, acc);
    } else {  // a miss adds bg*fcs, unguarded, and ends its trace
      C3 bg = background(p.bg, s.light, st.eye);
      col.r += bg.r * st.fcs.r;
      col.g += bg.g * st.fcs.g;
      col.b += bg.b * st.fcs.b;
      g_fcs = c3(gc.r * bg.r, gc.g * bg.g, gc.b * bg.b);
      g_vi = g_eye = v3(0.0f, 0.0f, 0.0f);
      background_adj(p.bg, s.light, st.eye,
                     c3(gc.r * st.fcs.r, gc.g * st.fcs.g, gc.b * st.fcs.b), &g_light, &g_eye);
    }
    if (i == 0 || sites[i - 1].task != st.task) {  // the trace's first site
      tk.col = col;
      tk.g_vi = g_vi;
      tk.g_eye = g_eye;
    }
  }
  // the camera ray's trace is task 0: its start is the camera
  if (rec.n_sites > 0) {
    Q4 gq = camera_ray_adj(p.xres, p.yres, p.sx, p.sy, cam, ix, iy, tasks[0].g_eye);
    const float gcam[CAM_GRADS] = {tasks[0].g_vi.x, tasks[0].g_vi.y, tasks[0].g_vi.z,
                                   gq.x, gq.y, gq.z, gq.w, g_light.x, g_light.y, g_light.z};
    acc.add_cam(s.n, gcam);
  }
  return out;
}

}  // namespace rt
