// Per-pixel body of the march-mode forward with glow, shared by the CUDA
// kernel (march_fwd.cu) and a host build (march_host.cpp) that the CPU tests
// run against the plain PyTorch version.
//
// It computes what ray_rust_tpu/ops/pallas_march.py:render_color_pallas_march
// computes for one pixel, written as the plain version (ops/trace.py
// raymarch and shading, ops/march.py march_single) evaluates it:
// position-based sphere tracing over the scene SDF (render.rs:1226-1297),
// the lap loop with its cached march and the miss-re-adds-sky quirk, march
// shading whose shadow march checks the *shaded* object's transparency, the
// refraction sub-march, and the factor 1 + g*0.99^min_min_dist that ends
// every raymarch (render.rs:1299-1411). Every operation is in the plain
// version's order, in f32, for a build without contracted multiply-adds.
//
// The refraction recursion. A sub-march's colour reaches its parent only
// after the sub-march, all its laps and its own glow factor are done, and
// the parent then blends it into the face colour before accumulating:
// ((kd*k1 + k2)*(1 - f) + fc2*f) * fcs. So a sub-march is a real call whose
// result the parent waits for, not a task pushed with a linear weight as in
// the trace body. The call depth is bounded: a sub-march starts at level
// ``nest`` = the parent lap's level, which is above the parent's own level
// and below the refraction cap, so a chain of nested raymarch calls holds
// at most max(1, refraction_cap) frames. raymarch<D> is instantiated per
// depth D up to MARCH_FRAMES, so the call graph has no recursion
// (ops/kernel_march.py refuses a cap past MARCH_FRAMES; a call past it
// would turn the pixel to NaN rather than drop the sub-march). Every level
// is forced inline, with every function of this file from march_pixel down
// (RT_INLINE), so the kernel is one straight program: built with real
// calls between the levels (__noinline__), the optimized kernel read illegal
// addresses on the card at some image sizes, while the same source built
// with -G, with ptxas -O0 or fully inlined ran clean and matched this host
// build. chip_smoke.py fails when ptxas reports any function of march_fwd.cu
// besides the kernel.
#pragma once

#include "trace_body.cuh"

#ifdef __CUDACC__
#define RT_INLINE __host__ __device__ __forceinline__
#else
#define RT_INLINE inline
#endif

namespace rt {

constexpr int MARCH_FRAMES = 10;  // ops/kernel_march.py: FRAME_CAP

// f32 operations (add, sub, mul, div, sqrt) of one object's SDF, of the
// glow metric, and of one march step's update.
constexpr int OPS_SPHERE_SDF = 10;
constexpr int OPS_FLOOR_SDF = 8;
constexpr int OPS_GLOW = 1;
constexpr int OPS_STEP = 7;

// March-mode render parameters.
struct MarchParams {
  int xres, yres;
  float sx, sy;
  int refraction_cap;  // min(max_refractions, refraction_unroll)
  int bg;
  int max_laps;  // raymarch_max_reflections
  int max_iter;  // march_max_iter
  float eps, far_away;
  int glow_on;
  float glow;
};

// One march's outcome (ops/march.py:MarchResult).
struct March {
  float final_dist;
  int idx;
  V3 pos;
  int iter;
  float travel;
  float min_dist;
};

// One object's SDF: sphere max(|org - p| - r, 0), floor max((p - o).n, 0)
// (render.rs:473-475, 571-573).
RT_INLINE float object_distance(const float* o, int kind, V3 pos) {
  if (kind == KIND_SPHERE) {
    V3 d = sub(v3(o[0], o[1], o[2]), pos);
    return fmaxf(sqrtf(dot(d, d)) - o[17], 0.0f);
  }
  return fmaxf(dot(sub(pos, v3(o[0], o[1], o[2])), v3(o[3], o[4], o[5])), 0.0f);
}

// Scene SDF (render.rs:1226-1251): nearest distance (strictly closer wins,
// first index wins ties, object ``ig`` skipped) and its index; with GLOW
// also the least positive dist * glow_dist (+inf where none is).
template <bool GLOW>
RT_INLINE float distance_estimate(const SceneView& s, V3 pos, int ig, int* idx, float* glow) {
  float closest = INFINITY;
  float g = INFINITY;
  *idx = 0;
  for (int i = 0; i < s.n; ++i) {
    if (i == ig) continue;
    const float* o = s.f32 + i * F32_COLS;
    const int kind = s.i32[i * I32_COLS];
    RT_COUNT(s, (kind == KIND_SPHERE ? OPS_SPHERE_SDF : OPS_FLOOR_SDF) + (GLOW ? OPS_GLOW : 0));
    float d = object_distance(o, kind, pos);
    if (d < closest) {
      closest = d;
      *idx = i;
    }
    if (GLOW) {
      float gl = d * o[18];
      if (gl > 0.0f && gl < g) g = gl;
    }
  }
  *glow = g;
  return closest;
}

// Sphere tracing (render.rs:1266-1297): the step comes before the stop
// check, so the result includes the final step. Without GLOW, min_dist is
// +inf (a shadow march reads only travel and iter).
template <bool GLOW>
RT_INLINE March march_single(const SceneView& s, const MarchParams& p, V3 pos, V3 eye,
                               int ig) {
  March m;
  m.pos = pos;
  m.travel = 0.0f;
  m.iter = 0;
  m.min_dist = INFINITY;
  for (;;) {
    int idx;
    float glow;
    float dist = distance_estimate<GLOW>(s, m.pos, ig, &idx, &glow);
    RT_COUNT(s, OPS_STEP);
    m.pos = add(m.pos, scale(eye, dist));
    m.travel = m.travel + dist;
    m.iter += 1;
    if (GLOW && glow < m.min_dist) m.min_dist = glow;
    m.final_dist = dist;
    m.idx = idx;
    if (dist < p.eps || dist > p.far_away || m.iter > p.max_iter) return m;
  }
}

template <int D>
RT_INLINE C3 raymarch(const SceneView& s, const MarchParams& p, V3 pos, V3 eye, int lev,
                        int ig, int flags);

// March shading (render.rs:1020-1140) of a hit on object ``idx`` at level
// ``nest``, by the raymarch frame at depth D.
template <int D>
RT_INLINE C3 march_shading(const SceneView& s, const MarchParams& p, int idx, V3 n, V3 pt,
                           V3 eye, int nest) {
  const float* o = s.f32 + idx * F32_COLS;
  const int* oi = s.i32 + idx * I32_COLS;

  // Lambert + Phong (render.rs:1024-1046)
  float li = dot(s.light, n);
  float ln2 = 2.0f * li;
  V3 rtl = sub(v3(n.x * ln2, n.y * ln2, n.z * ln2), s.light);
  float di = fmaxf(li, 0.0f);
  float pn = o[12];
  float ri = -dot(rtl, eye);
  float refl = (pn != 0.0f && ri > 0.0f) ? powf(ri, pn) : 0.0f;

  // shadow march: lit when it escapes or runs out of steps, or when the
  // shaded object itself is transparent (render.rs:1048-1067)
  float f = o[13];
  March sh = march_single<false>(s, p, add(pt, scale(s.light, F32_EPS)), s.light, idx);
  bool lit = sh.travel >= p.far_away || sh.iter >= p.max_iter || f > 0.0f;
  float k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
  float k2 = lit ? refl : 0.0f;

  float u, v;
  get_uv(sub(pt, v3(o[0], o[1], o[2])), oi[2], o[15], o[16], &u, &v);
  C3 kd = pattern_diffuse(o, oi[1], u, v);
  C3 base = c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);
  if (!(nest < p.refraction_cap && f > 0.0f)) return base;

  // pseudo-refraction (render.rs:1093-1132): bend, ignore the source, and
  // march the sub-ray from level ``nest``
  float sp_n = dot(eye, n);
  float fracn = fabsf(o[14]) > 1e-6f ? o[14] : 1.0f;
  float bend = sp_n * ((sp_n > 0.0f ? fracn : 1.0f / fracn) - 1.0f);
  V3 ray = normalized(add(eye, v3(n.x * bend, n.y * bend, n.z * bend)));
  int sub_flags = sp_n < 0.0f ? OUTONLY : INONLY;
  C3 fc2;
  if constexpr (D + 1 < MARCH_FRAMES) {
    fc2 = raymarch<D + 1>(s, p, add(pt, scale(ray, F32_EPS)), ray, nest, idx, sub_flags);
  } else {  // unreachable under the bound: poison the pixel, never drop work
    fc2 = c3(nanf(""), nanf(""), nanf(""));
  }
  return c3((kd.r * k1 + k2) * (1.0f - f) + fc2.r * f, (kd.g * k1 + k2) * (1.0f - f) + fc2.g * f,
            (kd.b * k1 + k2) * (1.0f - f) + fc2.b * f);
}

// The march + reflect loop of one ray at level ``lev`` (render.rs:1299-1411),
// ending with its glow factor.
template <int D>
RT_INLINE C3 raymarch(const SceneView& s, const MarchParams& p, V3 pos, V3 eye, int lev,
                        int ig, int flags) {
  C3 fcs = c3(1.0f, 1.0f, 1.0f);
  C3 ret = c3(0.0f, 0.0f, 0.0f);
  float min_min_dist = INFINITY;
  March res;
  bool need_march = true;
  const int laps = p.max_laps - lev > 1 ? p.max_laps - lev : 1;
  for (int step = 0; step < laps; ++step) {
    const int lev_i = lev + 1 + step;
    if (need_march) {
      res = p.glow_on ? march_single<true>(s, p, pos, eye, ig)
                      : march_single<false>(s, p, pos, eye, ig);
    }
    if (res.min_dist < min_min_dist) min_min_dist = res.min_dist;
    if (!(res.final_dist < p.eps)) {
      // a miss keeps the lane and its march, and re-adds the sky each lap
      C3 bg = background(p.bg, s.light, eye);
      ret = c3(ret.r + bg.r * fcs.r, ret.g + bg.g * fcs.g, ret.b + bg.b * fcs.b);
      need_march = false;
      continue;
    }
    const float* o = s.f32 + res.idx * F32_COLS;
    V3 pt = res.pos;
    V3 n = surface_normal(o, s.i32[res.idx * I32_COLS], pt);
    C3 face = march_shading<D>(s, p, res.idx, n, pt, eye, lev_i);

    // accumulate with the per-channel IGNORE guards (render.rs:1175-1186)
    if (!(flags & RIGNORE)) {
      ret.r = ret.r + face.r * fcs.r;
      fcs.r = fcs.r * o[9];
    }
    if (!(flags & GIGNORE)) {
      ret.g = ret.g + face.g * fcs.g;
      fcs.g = fcs.g * o[10];
    }
    if (!(flags & BIGNORE)) {
      ret.b = ret.b + face.b * fcs.b;
      fcs.b = fcs.b * o[11];
    }

    bool cont = res.idx != 0 && fcs.r + fcs.g + fcs.b > 0.1f && lev_i < p.max_laps;
    if (!cont) break;
    // mirror bounce + entry/exit flag flip (render.rs:1199-1211)
    float en2 = -2.0f * dot(eye, n);
    V3 new_eye = add(eye, v3(n.x * en2, n.y * en2, n.z * en2));
    flags = dot(n, new_eye) < 0.0f ? ((flags & ~INONLY) | OUTONLY) : ((flags & ~OUTONLY) | INONLY);
    pos = pt;
    eye = new_eye;
    ig = res.idx;
    need_march = true;
  }
  if (p.glow_on && !(fabsf(min_min_dist) == INFINITY)) {
    float factor = 1.0f + p.glow * powf(0.99f, min_min_dist);
    ret = c3(ret.r * factor, ret.g * factor, ret.b * factor);
  }
  return ret;
}

// The colour of pixel (ix, iy). ``cam`` is the packed camera row.
RT_INLINE C3 march_pixel(const SceneView& s, const MarchParams& p, const float* cam, int ix,
                         int iy) {
  V3 eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  return raymarch<0>(s, p, v3(cam[0], cam[1], cam[2]), eye, 0, -1, 0);
}

}  // namespace rt
