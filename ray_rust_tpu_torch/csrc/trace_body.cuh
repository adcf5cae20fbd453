// Per-pixel body of the Whitted trace forward (trace mode), shared by the
// CUDA kernel (trace_fwd.cu) and a host build (trace_host.cpp) that the CPU
// tests run against the plain PyTorch version.
//
// It computes what ray_rust_tpu/ops/pallas_trace.py:render_color_pallas
// computes for one pixel: the camera ray (render.rs:808-815), the reflection
// loop with its throughput, object-0 and depth exits (render.rs:1142-1224),
// the nearest-hit scan over all objects (render.rs:993-1018), shading with a
// shadow ray that passes transparent blockers, Lambert + Phong, procedural
// patterns, the pseudo-refraction subtree (render.rs:1020-1140) and the sky
// (src/main.rs:231-260). Every operation is written in the order the plain
// version (ops/trace.py) evaluates it, in f32, so that a build without
// contracted multiply-adds rounds as it does.
//
// The refraction recursion becomes an explicit per-thread stack of pending
// sub-traces. A sub-trace's colour enters its parent's pixel linearly, with
// weight (parent weight) * (parent throughput) * transparency, and nothing
// the parent does next depends on it, so a shading site pushes the sub-trace
// with that weight and the parent runs on. A task at level L pushes at most
// max(1, max_reflections - L) children, all at deeper levels, so the stack
// never holds more than 1 + R(R-1)/2 tasks for R = max_reflections
// (ops/kernel_trace.py checks that against STACK_CAP; a push past it would
// turn the pixel to NaN rather than lose the sub-trace).
//
// Vectors, the sky, uv maps, patterns and the normal are shared with the
// march-mode body (march_body.cuh). The traversal takes a recorder: the
// forward kernel's (NoRecord) does nothing, the backward kernel's
// (trace_bwd_body.cuh) saves the state of every raycast site, so both run
// one traversal.
//
// A build with -DRT_COUNT_OPS counts the f32 arithmetic of the object loops
// (the fewest operations each object test can take) into *SceneView::ops,
// for the kernels' roofline bound; the ordinary build compiles it away.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ inline
#else
#define RT_HD inline
#endif

#ifdef RT_COUNT_OPS
#define RT_COUNT(s, k) (*(s).ops += static_cast<unsigned long long>(k))
#else
#define RT_COUNT(s, k) ((void)0)
#endif

namespace rt {

// Column layout of the packed scene tables (ops/kernel_trace.py:pack_scene,
// the same as ray_rust_tpu/ops/pallas_trace.py:_pack_scene).
constexpr int F32_COLS = 19;  // org xyz, normal xyz, diffuse rgb, specular rgb,
                              // pn, t, n, pattern_scale, pattern_angle_scale,
                              // radius, glow_dist
constexpr int I32_COLS = 4;   // kind, pattern, uvmap, texture id
constexpr int CAM_COLS = 8;   // position xyz, rotation xyzw, pad
constexpr int LIGHT_COLS = 4; // direction xyz, pad

constexpr int KIND_SPHERE = 0;
constexpr int PATTERN_CHECKERBOARD = 1;
constexpr int PATTERN_GRADATION = 2;
constexpr int UVMAP_YZ = 1;
constexpr int UVMAP_ZX = 2;
constexpr int UVMAP_LL = 3;
constexpr int OUTONLY = 1;
constexpr int INONLY = 1 << 1;
constexpr int RIGNORE = 1 << 2;
constexpr int GIGNORE = 1 << 3;
constexpr int BIGNORE = 1 << 4;
constexpr int BG_DEFAULT_SKY = 0;
constexpr int BG_BLACK = 1;
constexpr int STACK_CAP = 16;

// Fewest f32 operations (add, sub, mul, div, sqrt) of one object test in a
// raycast: a sphere whose discriminant is negative, a floor facing away.
constexpr int OPS_SPHERE_TEST = 19;
constexpr int OPS_FLOOR_TEST = 8;

constexpr float F32_EPS = 1.1920928955078125e-7f;  // f32::EPSILON
constexpr float PI_F = 3.14159265358979323846f;
constexpr float PIO2_F = 1.57079632679489661923f;
constexpr float PIO4_F = 0.78539816339744830962f;
constexpr float TAN3PIO8_F = 2.414213562373095f;
constexpr float TANPIO8_F = 0.4142135623730950f;
constexpr float SKY_A = 50.0f * PI_F;  // rounded in f32, as the plain version
constexpr float TWO_PI_F = 2.0f * PI_F;

struct V3 {
  float x, y, z;
};
struct C3 {
  float r, g, b;
};

RT_HD V3 v3(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
RT_HD C3 c3(float r, float g, float b) {
  C3 c;
  c.r = r;
  c.g = g;
  c.b = b;
  return c;
}
RT_HD V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
RT_HD V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
RT_HD V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
RT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RT_HD bool is_finite(float x) { return fabsf(x) < INFINITY; }

// v / sqrt(v.v), a sqrt then a divide (vec3.rs:36-39); 0 at zero length.
RT_HD V3 normalized(V3 v) {
  float sq = dot(v, v);
  if (!(sq > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  float ln = sqrtf(sq);
  return v3(v.x / ln, v.y / ln, v.z / ln);
}

// Hamilton product (quat.rs:63-72); quaternions as (x, y, z, w).
struct Q4 {
  float x, y, z, w;
};
RT_HD Q4 qmul(Q4 a, Q4 b) {
  Q4 q;
  q.x = a.y * b.z - a.z * b.y + a.x * b.w + a.w * b.x;
  q.y = a.z * b.x - a.x * b.z + a.y * b.w + a.w * b.y;
  q.z = a.x * b.y - a.y * b.x + a.z * b.w + a.w * b.z;
  q.w = -a.x * b.x - a.y * b.y - a.z * b.z + a.w * b.w;
  return q;
}

// Cephes atanf / asinf (utils/fastmath.py), not the libm functions.
RT_HD float cephes_atan(float x) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  float a = fabsf(x);
  float xr, y0;
  if (a > TAN3PIO8_F) {
    xr = -1.0f / a;
    y0 = PIO2_F;
  } else if (a > TANPIO8_F) {
    xr = (a - 1.0f) / (a + 1.0f);
    y0 = PIO4_F;
  } else {
    xr = a;
    y0 = 0.0f;
  }
  float z = xr * xr;
  float p = (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
             3.33329491539e-1f) * z * xr + xr;
  return sign * (y0 + p);
}

RT_HD float cephes_atan2(float y, float x) {
  if (x == 0.0f) return y > 0.0f ? PIO2_F : (y < 0.0f ? -PIO2_F : 0.0f);
  float z = cephes_atan(y / x);
  float w = x < 0.0f ? (y < 0.0f ? -PI_F : PI_F) : 0.0f;
  return w + z;
}

RT_HD float cephes_asin(float x) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  float a = fminf(fabsf(x), 1.0f);
  bool big = a > 0.5f;
  float z = big ? 0.5f * (1.0f - a) : a * a;
  float xr = big ? sqrtf(z) : a;
  float p = ((((4.2163199048e-2f * z + 2.4181311049e-2f) * z + 4.5470025998e-2f) * z +
              7.4953002686e-2f) * z + 1.6666752422e-1f) * z * xr + xr;
  return sign * (big ? PIO2_F - 2.0f * p : p);
}

// f - floor(f/freq)*freq (modutil.rs:1-3)
RT_HD float floor_mod(float f, float freq) { return f - floorf(f / freq) * freq; }

// Stripe-grid sky with sun glare (ops/sky.py:default_sky).
RT_HD C3 background(int bg, V3 light, V3 d) {
  if (bg == BG_BLACK) return c3(0.0f, 0.0f, 0.0f);
  float phi = cephes_atan2(d.z, d.x);
  float the = cephes_asin(fminf(fmaxf(d.y, -1.0f), 1.0f));
  float dp = fmodf(SKY_A + phi * 10.0f * PI_F, TWO_PI_F) - PI_F;
  float dt = fmodf(SKY_A + the * 10.0f * PI_F, TWO_PI_F) - PI_F;
  float base_r = 0.5f / (15.0f * (dp * dp * dt * dt) + 1.0f);
  float base_gb = 0.25f - d.y / 4.0f;
  float ld = dot(light, d);
  if (ld > 0.9995f) return c3(2.0f, 2.0f, 2.0f);
  float glare = ld > 0.995f ? (ld - 0.995f) * 150.0f : 0.0f;
  float dot2 = ld > 0.9f ? (ld - 0.9f) * 5.0f : 0.0f;
  return c3(base_r + glare + dot2, base_gb + glare + dot2, base_gb + glare);
}

// The packed scene as the body reads it: per-object rows and the light.
struct SceneView {
  const float* f32;  // (n, F32_COLS)
  const int* i32;    // (n, I32_COLS)
  int n;
  V3 light;
#ifdef RT_COUNT_OPS
  unsigned long long* ops;  // this thread's operation count
#endif
};

// Render parameters: image size, 2*fov in f32, depth caps, background id.
struct Params {
  int xres, yres;
  float sx, sy;
  int max_reflections;
  int refraction_cap;  // min(max_refractions, refraction_unroll)
  int bg;
};

// One object's intersection parameter, or +inf (ops/intersect.py).
RT_HD float candidate_t(const float* o, int kind, V3 vi, V3 eye, float t_run, int flags) {
  V3 wpt = sub(vi, v3(o[0], o[1], o[2]));
  if (kind == KIND_SPHERE) {
    float r = o[17];
    float b = 2.0f * dot(eye, wpt);
    float c = dot(wpt, wpt) - r * r;
    float d2 = b * b - 4.0f * c;
    if (!(d2 >= F32_EPS)) return INFINITY;
    float d = sqrtf(d2);
    float t0 = (-b - d) / 2.0f;
    float t1 = t0 + d;
    if (!(flags & OUTONLY) && t0 >= 0.0f && t0 < t_run) return t0;
    if (!(flags & INONLY) && t1 > 0.0f && t1 < t_run) return t1;
    return INFINITY;
  }
  V3 nrm = v3(o[3], o[4], o[5]);
  float w = dot(nrm, eye);
  if (!(w < 0.0f)) return INFINITY;
  float t0 = -dot(nrm, wpt) / w;
  return (t0 >= 0.0f && t0 < t_run) ? t0 : INFINITY;
}

// Nearest hit: strictly closer wins, first index wins ties, object ``ig``
// skipped. Returns t (+inf on a miss, with *idx = 0).
RT_HD float raycast(const SceneView& s, V3 vi, V3 eye, int ig, int flags, int* idx) {
  float t = INFINITY;
  *idx = 0;
  for (int i = 0; i < s.n; ++i) {
    if (i == ig) continue;
    const int kind = s.i32[i * I32_COLS];
    RT_COUNT(s, kind == KIND_SPHERE ? OPS_SPHERE_TEST : OPS_FLOOR_TEST);
    float c = candidate_t(s.f32 + i * F32_COLS, kind, vi, eye, t, flags);
    if (c < t) {
      t = c;
      *idx = i;
    }
  }
  return t;
}

RT_HD void get_uv(V3 rel, int uvmap, float ps, float pas, float* u, float* v) {
  if (uvmap == UVMAP_YZ) {
    *u = rel.y / ps;
    *v = rel.z / ps;
  } else if (uvmap == UVMAP_ZX) {
    *u = rel.z / ps;
    *v = rel.x / ps;
  } else if (uvmap == UVMAP_LL) {
    *u = cephes_atan2(rel.z, rel.x) / pas;
    *v = cephes_atan2(sqrtf(rel.x * rel.x + rel.z * rel.z), rel.y) / pas;
  } else {
    *u = rel.x / ps;
    *v = rel.y / ps;
  }
}

// floor(x) as int32, saturating where it does not fit.
RT_HD int floor_to_int(float x) {
  float f = floorf(x);
  if (f >= 2147483648.0f) return 2147483647;
  if (!(f >= -2147483648.0f)) return (int)0x80000000u;
  return (int)f;
}

// Procedural pattern colour (render.rs:301-314).
RT_HD C3 pattern_diffuse(const float* o, int pattern, float u, float v) {
  C3 d = c3(o[6], o[7], o[8]);
  if (pattern == PATTERN_GRADATION)
    return c3(d.r * floor_mod(u, 1.0f), d.g * floor_mod(v, 1.0f), d.b);
  // checkerboard: black where floor(u) + floor(v) is even
  if (pattern == PATTERN_CHECKERBOARD && ((floor_to_int(u) ^ floor_to_int(v)) & 1) == 0)
    return c3(0.0f, 0.0f, 0.0f);
  return d;
}

// Sphere (pt - org)/|pt - org| (render.rs:443-445) or the floor's stored
// face normal (render.rs:553-555), for object row ``o`` of kind ``kind``.
RT_HD V3 surface_normal(const float* o, int kind, V3 pt) {
  return kind == KIND_SPHERE ? normalized(sub(pt, v3(o[0], o[1], o[2]))) : v3(o[3], o[4], o[5]);
}

// The camera ray of pixel (ix, iy) (render.rs:808-815):
// normalize(rot * (1, ey, ez, 0) * conj(rot)). ``cam`` is the packed camera row.
RT_HD V3 camera_ray(int xres, int yres, float sx, float sy, const float* cam, int ix, int iy) {
  float ey = (float)(ix - xres / 2) * sx / (float)xres;
  float ez = -(float)(iy - yres / 2) * sy / (float)yres;
  Q4 q = {cam[3], cam[4], cam[5], cam[6]};
  Q4 qc = {-q.x, -q.y, -q.z, q.w};
  Q4 e = {1.0f, ey, ez, 0.0f};
  Q4 r = qmul(qmul(q, e), qc);
  return normalized(v3(r.x, r.y, r.z));
}

// A pending trace: start ray, level, ignored object, flags, the weight its
// colour carries into the pixel, and the recorder's id of the site that
// pushed it (-1 for the camera ray).
struct Task {
  V3 vi, eye;
  C3 w;
  int lev, ig, flags;
  int parent;
};

// The forward kernel's recorder: records nothing.
struct NoRecord {
  RT_HD void task(const Task&) {}
  RT_HD int site(V3, V3, C3, int, int, bool, bool) { return -1; }
};

// Run one trace (render.rs:1142-1224) and add its weighted colour to *out;
// refraction sub-traces go onto the stack. ``rec.task`` sees the trace
// start and ``rec.site`` each raycast site: its ray, throughput, flags,
// winner, hit and shadow outcome; the id it returns is the parent of the
// site's refraction sub-trace.
template <class Rec>
RT_HD void trace_task(const SceneView& s, const Params& p, const Task& tk, C3* out,
                      Task* stack, int* sp, Rec& rec) {
  rec.task(tk);
  V3 vi = tk.vi, eye = tk.eye;
  int ig = tk.ig, flags = tk.flags;
  C3 fcs = c3(1.0f, 1.0f, 1.0f);
  int n_iters = p.max_reflections - tk.lev > 1 ? p.max_reflections - tk.lev : 1;
  for (int step = 0; step < n_iters; ++step) {
    int lev = tk.lev + 1 + step;
    int idx;
    float t = raycast(s, vi, eye, ig, flags, &idx);
    if (!is_finite(t)) {
      rec.site(vi, eye, fcs, flags, idx, false, false);
      // a miss picks up the background once, unguarded (render.rs:1212-1217)
      C3 bg = background(p.bg, s.light, eye);
      out->r += tk.w.r * (bg.r * fcs.r);
      out->g += tk.w.g * (bg.g * fcs.g);
      out->b += tk.w.b * (bg.b * fcs.b);
      return;
    }
    const float* o = s.f32 + idx * F32_COLS;
    const int* oi = s.i32 + idx * I32_COLS;
    V3 pt = add(vi, scale(eye, t));
    V3 org = v3(o[0], o[1], o[2]);
    V3 n = surface_normal(o, oi[0], pt);

    // Lambert + Phong (render.rs:1024-1046)
    float li = dot(s.light, n);
    float ln2 = 2.0f * li;
    V3 rtl = sub(v3(n.x * ln2, n.y * ln2, n.z * ln2), s.light);
    float di = fmaxf(li, 0.0f);
    float pn = o[12];
    float ri = -dot(rtl, eye);
    float refl = (pn != 0.0f && ri > 0.0f) ? powf(ri, pn) : 0.0f;

    // shadow ray: lit when it escapes or its blocker is transparent
    int i_s;
    float t_s = raycast(s, add(pt, scale(s.light, F32_EPS)), s.light, idx, 0, &i_s);
    bool lit = !is_finite(t_s) || s.f32[i_s * F32_COLS + 13] > 0.0f;
    const int site = rec.site(vi, eye, fcs, flags, idx, true, lit);
    float k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
    float k2 = lit ? refl : 0.0f;

    float u, v;
    get_uv(sub(pt, org), oi[2], o[15], o[16], &u, &v);
    C3 kd = pattern_diffuse(o, oi[1], u, v);
    C3 face = c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);

    bool mr = !(flags & RIGNORE), mg = !(flags & GIGNORE), mb = !(flags & BIGNORE);
    float f = o[13];
    if (lev < p.refraction_cap && f > 0.0f) {
      // pseudo-refraction (render.rs:1093-1132): bend, ignore the source
      float sp_n = dot(eye, n);
      float fracn = fabsf(o[14]) > 1e-6f ? o[14] : 1.0f;
      float bend = sp_n * ((sp_n > 0.0f ? fracn : 1.0f / fracn) - 1.0f);
      V3 ray = normalized(add(eye, v3(n.x * bend, n.y * bend, n.z * bend)));
      Task c;
      c.vi = add(pt, scale(ray, F32_EPS));
      c.eye = ray;
      c.lev = lev;
      c.ig = idx;
      c.flags = sp_n < 0.0f ? OUTONLY : INONLY;
      c.parent = site;
      c.w = c3(mr ? tk.w.r * (fcs.r * f) : 0.0f, mg ? tk.w.g * (fcs.g * f) : 0.0f,
               mb ? tk.w.b * (fcs.b * f) : 0.0f);
      if (*sp < STACK_CAP) {
        stack[(*sp)++] = c;
      } else {  // unreachable under the bound: poison the pixel, never drop work
        out->r = out->g = out->b = nanf("");
      }
      face = c3(face.r * (1.0f - f), face.g * (1.0f - f), face.b * (1.0f - f));
    }

    // accumulate with the per-channel IGNORE guards (render.rs:1175-1186)
    if (mr) {
      out->r += tk.w.r * (face.r * fcs.r);
      fcs.r = fcs.r * o[9];
    }
    if (mg) {
      out->g += tk.w.g * (face.g * fcs.g);
      fcs.g = fcs.g * o[10];
    }
    if (mb) {
      out->b += tk.w.b * (face.b * fcs.b);
      fcs.b = fcs.b * o[11];
    }

    bool cont = idx != 0 && fcs.r + fcs.g + fcs.b > 0.1f && lev < p.max_reflections;
    if (!cont) return;
    // mirror bounce + entry/exit flag flip (render.rs:1199-1211)
    float en2 = -2.0f * dot(eye, n);
    V3 new_eye = add(eye, v3(n.x * en2, n.y * en2, n.z * en2));
    flags = dot(n, new_eye) < 0.0f ? ((flags & ~INONLY) | OUTONLY)
                                   : ((flags & ~OUTONLY) | INONLY);
    vi = pt;
    eye = new_eye;
    ig = idx;
  }
}

// The colour of pixel (ix, iy). ``cam`` is the packed camera row.
template <class Rec>
RT_HD C3 trace_pixel(const SceneView& s, const Params& p, const float* cam, int ix, int iy,
                     Rec& rec) {
  Task stack[STACK_CAP];
  stack[0].vi = v3(cam[0], cam[1], cam[2]);
  stack[0].eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  stack[0].w = c3(1.0f, 1.0f, 1.0f);
  stack[0].lev = 0;
  stack[0].ig = -1;
  stack[0].flags = 0;
  stack[0].parent = -1;
  int sp = 1;
  C3 out = c3(0.0f, 0.0f, 0.0f);
  while (sp > 0) {
    Task tk = stack[--sp];
    trace_task(s, p, tk, &out, stack, &sp, rec);
  }
  return out;
}

RT_HD C3 trace_pixel(const SceneView& s, const Params& p, const float* cam, int ix, int iy) {
  NoRecord rec;
  return trace_pixel(s, p, cam, ix, iy, rec);
}

}  // namespace rt
