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
// every raymarch (render.rs:1299-1411). A textured hit reads its texel as
// the trace body does (K1a); the JAX kernel declines textures, and the JAX
// package renders them through its jnp march, the plain version's
// function. Every operation is in the plain version's order, in f32, for a
// build without contracted multiply-adds.
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
// depth D up to MARCH_FRAMES, so the call graph has no recursion (a call
// past it would turn the pixel to NaN rather than drop the sub-march);
// past that cap the wrappers launch the deep march (raymarch_deep, at the
// end of this file), the same recursion as one loop over an explicit
// stack of MARCH_FRAMES_DEEP frames. Every level
// is forced inline, with every function of this file from march_pixel down
// (RT_INLINE), so the kernel is one straight program: built with real
// calls between the levels (__noinline__), the optimized kernel read illegal
// addresses on the card at some image sizes, while the same source built
// with -G, with ptxas -O0 or fully inlined ran clean and matched this host
// build. chip_smoke.py fails when ptxas reports any function of march_fwd.cu
// besides the kernel.
//
// What bounds a march is its slowest thread: a block holds its SM slot until
// its last warp ends, and a pixel's marches run one SDF sweep after another.
// A ray that grazes the floor near the horizon crawls toward it (or away
// from it) in steps that shrink (or grow) by a factor rho = 1 + e.n each,
// thousands of them, up to the march_max_iter cap. Two shortcuts of the JAX
// kernel cut that chain short (MarchParams::floor_skip, the config's
// march_floor_skip, turns the first off; the plain version has neither):
//
// - The floor tail (floor_tail, ray_rust_tpu/ops/pallas_march.py:_floor_tail).
//   While a floor wins the SDF, the k-th distance is h*rho^k, so the stop
//   step (a hit, an escape past far_away or the cap), the travel, the end
//   state and the sampled glow minimum have closed forms. They hold up to
//   s_break, the first travel where another object would tie the floor (a
//   sphere's root is quadratic, a floor's linear): a stop before it
//   finishes the march at once; a march that another object interrupts
//   steps on (the JAX kernel fast-forwards it to s_break). The reference's
//   f32 position update stalls once a step moves no coordinate that the
//   floor's distance reads, so a grazing ray can stop short of eps and run
//   to the cap: the tail predicts that stall (freeze_distance) and misses
//   where the reference misses. The JAX kernel keeps the objects' ray
//   constants as tile-shaped arrays and so takes the tail only up to 64
//   objects; here each of the tail's two object passes recomputes them from
//   the row in shared memory and the lane's position and direction, so no
//   thread holds an array per object and the tail applies at every N the
//   kernels take. A march tries it at its first step won by a floor, then
//   every FLOOR_TAIL_PERIOD steps while a floor wins. The sums are
//   evaluated from e.n itself (log1pf, expm1f) rather than from the rounded
//   rho, so a grazing ray's end point stays on the floor to f32 rounding.
// - The never-converges shortcut (never_converges, pallas_march.py:168-189)
//   for marches that keep no glow (shadow marches, and primaries without
//   glow): where every object stays more than 2*eps from the whole forward
//   ray, no sample can come within eps, so the march ends by escape or cap,
//   which give the same lit and miss decisions; it ends before its first
//   step. With it, a closed-form tail of such a march may also ignore an
//   object that clears its whole escape corridor by 2*eps.
//
// A march whose hit is shaded through a texture (K1a) takes no floor tail
// toward that floor (textured_floor), as the JAX package's textured march,
// its jnp loop, takes none. In Bilinear the blend follows the hit point
// continuously, and the closed form's end point, which rounds apart from
// the stepped march's accumulated position by ~1e-2 in world units at the
// horizon, moved the colour of 1.5-1.9% of the default scene's pixels by
// more than 1e-3 (its host build at 320x240 and 1280x720), past a knife
// edge. In Nearest the image moved on 0.013% of pixels, knife edges, but
// the gradient did not hold: the tail's glow argmin on a flat run of
// samples differs from the stepped one's, which moves the camera's
// cotangent by the same amount as over an untextured floor (|dg| 3.8 and
// 6.0 in camera.rotation.z, host build at 160x120 with glow, none without
// glow: tools/tail_grad_probe.py), while the Nearest floor's own cotangent is ~240 times smaller
// (its texels are constants), so the leaf came to relative L2 0.018 of the
// march gradient budget's 0.02. The shadow marches, which read no texture,
// keep the tail.
//
// The closed forms round apart from the step-by-step loop, and logf, expf
// and ceilf come from libdevice on the card and glibc on the host, so a
// stop step may move by one on knife-edge lanes: the tail's contract is the
// JAX package's, an image equal to the step-by-step one but for a sliver of
// pixels on decision boundaries (tests/test_torch_march.py). Not carried
// over: the JAX kernel's ray-parametric step form (pallas_march.py:85-97,
// 127-147), which rounds differently and only saves arithmetic.
//
// The traversal takes a recorder, as trace_task does in trace_body.cuh: the
// forward kernel's (NoMarchRecord) records nothing, the march backward's
// (march_bwd_body.cuh) saves every raymarch call, every lap and the glow
// argmin, so both kernels run one traversal. Under a recorder whose
// TRACK_GLOW is set, march_single also keeps the glow argmin's position
// (before the step), step index and object, as the JAX kernel's record_glow
// does (ray_rust_tpu/ops/pallas_march.py:210-243); a floor tail keeps the
// first of the samples whose f32 glow ties the least (first_tied_sample),
// as the stepped march does, where the JAX tail keeps the last.
#pragma once

#include "trace_body.cuh"

#ifdef __CUDACC__
#define RT_INLINE __host__ __device__ __forceinline__
#else
#define RT_INLINE inline
#endif

namespace rt {

constexpr int MARCH_FRAMES = 10;  // ops/kernel_march.py: FRAME_CAP

// A march tries the floor tail at its first step won by a floor, then every
// FLOOR_TAIL_PERIOD steps while a floor wins. Each try costs up to two
// object passes: trying at every step slowed the 720p march kernel by ~30%,
// periods past 64 lose the tail's gain on long marches, and 16-64 lie within
// the spread of one build (a sweep on an H100, PERF.md §6).
constexpr int FLOOR_TAIL_PERIOD = 32;

// f32 operations (add, sub, mul, div, sqrt; logf, log1pf, expf, expm1f,
// ceilf and floorf one each) of one object's SDF, of the glow metric, of
// one march step's update, and of the shortcuts: the floor tail's set-up,
// its s_break pass per sphere and floor (and the escape clearance of a
// march without glow), one sample offset, the resolution, its glow pass per
// glowing sphere and floor (and per candidate sample, and the first sample
// that ties a floor's glow argmin), and the never-converges test per sphere
// and floor.
constexpr int OPS_SPHERE_SDF = 10;
constexpr int OPS_FLOOR_SDF = 8;
constexpr int OPS_GLOW = 1;
constexpr int OPS_STEP = 7;
constexpr int OPS_TAIL_SETUP = 12;
constexpr int OPS_TAIL_SPHERE = 36;
constexpr int OPS_TAIL_FLOOR = 16;
constexpr int OPS_TAIL_CLEAR_SPHERE = 8;
constexpr int OPS_TAIL_CLEAR_FLOOR = 2;
constexpr int OPS_TAIL_OFFSET = 4;
constexpr int OPS_TAIL_RESOLVE = 21;
constexpr int OPS_TAIL_GLOW_SPHERE = 25;
constexpr int OPS_TAIL_GLOW_FLOOR = 13;
constexpr int OPS_TAIL_CAND_SPHERE = 10;
constexpr int OPS_TAIL_CAND_FLOOR = 7;
constexpr int OPS_TAIL_FREEZE = 6;
constexpr int OPS_TAIL_TIE = 11;
constexpr int OPS_TAIL_DRIFT_SPHERE = 20;
constexpr int OPS_TAIL_DRIFT_FLOOR = 7;
constexpr int OPS_CLEAR_SPHERE = 22;
constexpr int OPS_CLEAR_FLOOR = 14;

// A -DRT_COUNT_OPS build also counts the object passes (SDF sweeps, the
// tail's passes, the never-converges test) into SceneView::ops[3]: the
// serial chain of a thread, and the marches the never-converges test ended
// into ops[5]. The host loops keep each pixel's largest operation and pass
// counts in ops[2] and ops[4].
#ifdef RT_COUNT_OPS
#define RT_COUNT_PASS(s) ((s).ops[3] += 1ull)
#define RT_COUNT_NEVER(s) ((s).ops[5] += 1ull)
#define RT_PIXEL_COUNT_BEGIN(ops) \
  const unsigned long long rt_ops0 = (ops)[0], rt_pass0 = (ops)[3]
#define RT_PIXEL_COUNT_END(ops)                                              \
  do {                                                                       \
    if ((ops)[0] - rt_ops0 > (ops)[2]) (ops)[2] = (ops)[0] - rt_ops0;        \
    if ((ops)[3] - rt_pass0 > (ops)[4]) (ops)[4] = (ops)[3] - rt_pass0;      \
  } while (0)
#else
#define RT_COUNT_PASS(s) ((void)0)
#define RT_COUNT_NEVER(s) ((void)0)
#define RT_PIXEL_COUNT_BEGIN(ops) ((void)0)
#define RT_PIXEL_COUNT_END(ops) ((void)0)
#endif

// March-mode render parameters; the frame and the window as Params's
// (trace_body.cuh): K3 and K4 cover the window.
struct MarchParams {
  int xres, yres;
  int row0 = 0, col0 = 0, h = 0, w = 0;
  float sx, sy;
  int refraction_cap;  // min(max_refractions, refraction_unroll)
  int bg;
  int max_laps;  // raymarch_max_reflections
  int max_iter;  // march_max_iter
  float eps, far_away;
  int glow_on;
  float glow;
  int floor_skip;  // march_floor_skip: try the closed-form floor tail
};

// One march's outcome (ops/march.py:MarchResult); the glow argmin only
// under a recorder that tracks it.
struct March {
  float final_dist;
  int idx;
  V3 pos;
  int iter;
  float travel;
  float min_dist;
  V3 glow_pos;   // the position before the step that set min_dist
  int glow_iter; // that step's index, -1 where no glow was seen
  int glow_obj;  // the object whose glow metric it was
};

// The forward kernel's recorder: records nothing. A recorder's TEXTURED says
// whether a hit may read the scene's texture atlas (march_shading): the
// forward kernel reads it wherever the scene has one; the untextured march
// backward compiles the fetch out, so it stays the kernel it was.
struct NoMarchRecord {
  static constexpr bool TRACK_GLOW = false;
  static constexpr bool TEXTURED = true;
  RT_INLINE int frame(int) { return -1; }
  RT_INLINE int site(int, V3, int, int, C3, const March&, bool) { return -1; }
  RT_INLINE void lit(int, bool) {}
  RT_INLINE void glow(int, int, const March&, bool) {}
  RT_INLINE void frame_end(int, C3, C3) {}
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
// also the least positive dist * glow_dist (+inf where none is) and the
// object it came from (the first on ties).
template <bool GLOW>
RT_INLINE float distance_estimate(const SceneView& s, V3 pos, int ig, int* idx, float* glow,
                                  int* glow_obj) {
  float closest = INFINITY;
  float g = INFINITY;
  *idx = 0;
  *glow_obj = 0;
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
      if (gl > 0.0f && gl < g) {
        g = gl;
        *glow_obj = i;
      }
    }
  }
  *glow = g;
  return closest;
}

// The never-converges test (ray_rust_tpu/ops/pallas_march.py:168-189): true
// when every object but ``ig`` stays more than 2*eps from the whole forward
// ray pos + e*t, t >= 0. A sphere's least distance is perp - r past its
// closest approach and its distance at ``pos`` before it; a floor clears
// only where the ray does not descend toward it.
RT_INLINE bool never_converges(const SceneView& s, const MarchParams& p, V3 pos, V3 eye,
                               int ig) {
  RT_COUNT_PASS(s);
  for (int i = 0; i < s.n; ++i) {
    if (i == ig) continue;
    const float* o = s.f32 + i * F32_COLS;
    float dmin;
    if (s.i32[i * I32_COLS] == KIND_SPHERE) {
      RT_COUNT(s, OPS_CLEAR_SPHERE);
      V3 w = sub(v3(o[0], o[1], o[2]), pos);
      float s_star = dot(w, eye);
      V3 pv = sub(w, scale(eye, s_star));
      float perp2 = dot(pv, pv);
      dmin = (s_star > 0.0f ? sqrtf(perp2) : sqrtf(perp2 + s_star * s_star)) - o[17];
    } else {
      RT_COUNT(s, OPS_CLEAR_FLOOR);
      V3 nrm = v3(o[3], o[4], o[5]);
      dmin = dot(eye, nrm) >= 0.0f ? dot(sub(pos, v3(o[0], o[1], o[2])), nrm) : -INFINITY;
    }
    if (!(dmin > 2.0f * p.eps)) return false;
  }
  return true;
}

// The first travel t >= 0 at which a sphere (radius r, its centre at travel
// s_star along the ray and perp2 from it squared) comes within h + a*t of
// the ray's point: the lower root of (1 - a^2) t^2 - 2 (s* + a (r + h)) t +
// (perp2 + s*^2) - (r + h)^2 = 0, 0 where it is within already and +inf
// where it never is. |a| >= 0.99 gives 0: no claim.
RT_INLINE float sphere_tie(float s_star, float perp2, float r, float h, float a) {
  if (!(fabsf(a) < 0.99f)) return 0.0f;
  const float A2 = fmaxf(1.0f - a * a, 1e-4f) * 2.0f;
  const float rh = r + h;
  const float B = -2.0f * (s_star + a * rh);
  const float C = perp2 + s_star * s_star - rh * rh;
  const float D = B * B - 2.0f * A2 * C;
  const float sqrtD = sqrtf(fmaxf(D, 0.0f));
  const float r_lo = (-B - sqrtD) / A2;
  const float r_hi = (-B + sqrtD) / A2;
  return D < 0.0f ? INFINITY : r_lo > 0.0f ? r_lo : r_hi > 0.0f ? 0.0f : INFINITY;
}

// Whether a hit on floor ``i`` reads a texture, where the floor tail does
// not end a shaded march toward it.
RT_INLINE bool textured_floor(const SceneView& s, int i) {
  return textured(s, s.i32 + i * I32_COLS);
}

// Half the float spacing at x: the largest step that leaves x as it is.
RT_INLINE float half_spacing(float x) {
  int e2;
  frexpf(x, &e2);
  return ldexpf(1.0f, e2 - 25);
}

// The floor distance below which a march toward floor ``o`` may stall in
// f32, over its approach from ``pos`` to travel ``t_end``: a step moves
// coordinate i by e_i*d, which rounds to nothing under half the float
// spacing at p_i, and the SDF of a floor reads only the coordinates where
// its normal is nonzero. So the distance stops falling once every such
// coordinate along which the ray descends has frozen: below the least over
// them of half the spacing over |e_i|, the spacing taken at the wider end of
// the approach. *exact is set where each of those coordinates keeps one
// spacing over the whole approach, so that the stall comes at that distance.
RT_INLINE float freeze_distance(const SceneView& s, const float* o, V3 pos, V3 eye, float t_end,
                                bool* exact) {
  const float n[3] = {o[3], o[4], o[5]};
  const float pc[3] = {pos.x, pos.y, pos.z};
  const float ec[3] = {eye.x, eye.y, eye.z};
  float f = INFINITY;
  *exact = true;
  for (int i = 0; i < 3; ++i) {
    if (!(n[i] * ec[i] < 0.0f)) continue;  // the distance does not fall along i
    RT_COUNT(s, OPS_TAIL_FREEZE);
    const float p1 = pc[i] + ec[i] * t_end;
    const float h0 = half_spacing(pc[i]), h1 = half_spacing(p1);
    *exact = *exact && h0 == h1 && (pc[i] < 0.0f) == (p1 < 0.0f) && pc[i] != 0.0f;
    f = fminf(f, fmaxf(h0, h1) / fabsf(ec[i]));
  }
  return f;
}

// The travel from sample 0 to sample i of a floor tail whose first step is
// h and whose steps grow by rho = 1 + a: h*(rho^i - 1)/a, with log_rho =
// log1p(a) (i steps of h where rho rounds to 1).
RT_INLINE float tail_offset(float h, float a, float log_rho, float i) {
  return log_rho != 0.0f ? h * (expm1f(i * log_rho) / a) : h * i;
}

// The first sample from 0 to k whose glow the stepped march reads as g, the
// f32 glow of a floor's distance d = d0 + sl*t (sl < 0) at sample k of a
// tail (step h, rho = 1 + a). On a grazing ray that distance falls by less
// than its float spacing a step, so the stepped march reads one glow value
// over a run of samples and keeps the first of them (distance_estimate's
// strict <), where the closed form would take the last: the sample whose
// distance first rounds to at most D, the largest distance whose glow
// rounds to g (within two spacings of d, as gd*d and d lie within a binade).
RT_INLINE float first_tied_sample(float d, float g, float gd, float d0, float sl, float h,
                                  float a, float log_rho, float k) {
  float D = d;
  for (int j = 0; j < 3; ++j) {
    const float up = nextafterf(D, INFINITY);
    if (!(up * gd == g)) break;
    D = up;
  }
  const float t = ((D - d0) + half_spacing(D)) / sl;  // travel where d reaches D's rounding
  float kt;
  if (log_rho != 0.0f) {
    const float q = t * a / h;
    kt = q > -1.0f ? ceilf(log1pf(q) / log_rho) : k;
  } else {
    kt = ceilf(t / h);
  }
  return fminf(fmaxf(kt, 0.0f), k);
}

// The closed-form floor tail (ray_rust_tpu/ops/pallas_march.py:_floor_tail,
// over the lane's position). ``m`` is the march at its sample 0: position
// m.pos, m.iter steps taken, glow already updated with this sample, whose
// SDF is h, won by floor ``win``. Where the march stops (a hit, an escape,
// the cap or a stall) before s_break, finishes ``m`` there and returns
// true; else returns false and the caller steps on. TEX: the march's hit
// is shaded and may read a texture, so a march toward a textured floor
// steps on.
template <bool GLOW, bool TRACK, bool TEX>
RT_INLINE bool floor_tail(const SceneView& s, const MarchParams& p, V3 eye, int ig, float h,
                          int win, March& m) {
  const float* ow = s.f32 + win * F32_COLS;
  const float a = dot(eye, v3(ow[3], ow[4], ow[5]));  // rho - 1
  RT_COUNT_PASS(s);
  RT_COUNT(s, OPS_TAIL_SETUP);
  if (!(h > p.eps && h < p.far_away && 1.0f + a > 1e-6f)) return false;
  if (TEX && a < 0.0f && textured_floor(s, win)) return false;
  const float log_rho = log1pf(a);
  // the undisturbed stop: the first k with h*rho^k < eps (rho < 1) or
  // > far_away (rho > 1), or the iteration cap
  const float k_cap = static_cast<float>(p.max_iter - m.iter);
  float k_stop = k_cap;
  if (log_rho != 0.0f) {
    const float k_geo = ceilf((logf(a < 0.0f ? p.eps : p.far_away) - logf(h)) / log_rho);
    k_stop = fminf(k_geo, k_cap);
  }
  k_stop = fmaxf(k_stop, 0.0f);
  // Toward the floor, the reference's f32 update may stall (freeze_distance)
  // before the stop: where some coordinate still moves at the last distance
  // (eps for a hit) it does not; where the stall distance is exact, the
  // march is geometric up to sample k_frz, then d_stall a step to the cap,
  // a miss; else where it stalls is not known, and the loop steps.
  bool frozen = false;
  float k_frz = 0.0f;
  if (a < 0.0f) {
    RT_COUNT(s, OPS_TAIL_OFFSET + 3);
    bool exact;
    const float f = freeze_distance(s, ow, m.pos, eye, tail_offset(h, a, log_rho, k_stop), &exact);
    const float d_last = k_stop < k_cap ? p.eps : h * expf(k_stop * log_rho);
    if (!(f < d_last)) {
      if (!exact) return false;
      k_frz = fmaxf(ceilf(logf(f / h) / log_rho), 0.0f);
      frozen = k_frz < k_cap;
      if (frozen) k_stop = k_cap;
    }
  }
  // The stalled stretch [S_frz, S_end]: a step there moves coordinate i by
  // e_i*d_stall rounded to its float spacing, off the ray's by at most the
  // lesser of half that spacing (largest at an end of the stretch) and
  // |e_i|*d_stall. So the lane stays inside the cone d_stall + c*(t - S_frz)
  // around the ray, c those summed over d_stall, and an object outside the
  // cone never wins the SDF there.
  float S_frz = 0.0f, d_stall = 0.0f, S_end = 0.0f, c_drift = 0.0f;
  if (frozen) {
    RT_COUNT(s, 2 * OPS_TAIL_OFFSET + 12 + 6 * OPS_TAIL_FREEZE);
    S_frz = tail_offset(h, a, log_rho, k_frz);
    d_stall = h * expf(k_frz * log_rho);
    S_end = S_frz + (k_cap - k_frz + 1.0f) * d_stall;
    const V3 p0 = add(m.pos, scale(eye, S_frz)), p1 = add(m.pos, scale(eye, S_end));
    c_drift = (fminf(half_spacing(fmaxf(fabsf(p0.x), fabsf(p1.x))), fabsf(eye.x) * d_stall) +
               fminf(half_spacing(fmaxf(fabsf(p0.y), fabsf(p1.y))), fabsf(eye.y) * d_stall) +
               fminf(half_spacing(fmaxf(fabsf(p0.z), fabsf(p1.z))), fabsf(eye.z) * d_stall)) /
              d_stall;
  }
  bool drift_clear = true;
  // a march without glow may ignore an object that clears its whole escape
  // corridor [0, S_stop] by 2*eps: it cannot converge anywhere on it
  constexpr bool CLEAR = !GLOW && !TRACK;
  float S_stop = 0.0f;
  if (CLEAR && a > 0.0f) {
    RT_COUNT(s, OPS_TAIL_OFFSET + 1);
    S_stop = tail_offset(h, a, log_rho, k_stop + 1.0f);
  }

  // s_break: the first travel at which another object would tie the floor,
  // whose distance there is h + a*t
  float s_break = INFINITY;
  for (int i = 0; i < s.n; ++i) {
    if (i == win || i == ig) continue;
    const float* o = s.f32 + i * F32_COLS;
    float sb, d_min;
    if (s.i32[i * I32_COLS] == KIND_SPHERE) {
      RT_COUNT(s, OPS_TAIL_SPHERE);
      V3 w = sub(v3(o[0], o[1], o[2]), m.pos);
      float s_star = dot(w, eye);
      V3 pv = sub(w, scale(eye, s_star));
      float perp2 = dot(pv, pv);
      float wlen2 = perp2 + s_star * s_star;
      float r = o[17];
      sb = sphere_tie(s_star, perp2, r, h, a);
      if (CLEAR && a > 0.0f) {
        RT_COUNT(s, OPS_TAIL_CLEAR_SPHERE);
        float dS = sqrtf(perp2 + (S_stop - s_star) * (S_stop - s_star));
        bool interior = s_star > 0.0f && s_star < S_stop;
        d_min = fminf(fminf(sqrtf(wlen2), dS), interior ? sqrtf(perp2) : INFINITY) - r;
        if (d_min > 2.0f * p.eps) sb = INFINITY;
      }
      if (frozen) {  // outside the cone, or (a steep cone) its widest end
        RT_COUNT(s, OPS_TAIL_DRIFT_SPHERE);
        const float dt = fminf(fmaxf(s_star, S_frz), S_end) - s_star;
        drift_clear = drift_clear &&
                      (c_drift < 0.99f
                           ? sphere_tie(s_star - S_frz, perp2, r, d_stall, c_drift) > S_end - S_frz
                           : sqrtf(perp2 + dt * dt) - r > d_stall + c_drift * (S_end - S_frz));
      }
    } else {
      RT_COUNT(s, OPS_TAIL_FLOOR);
      V3 nrm = v3(o[3], o[4], o[5]);
      float d0 = dot(sub(m.pos, v3(o[0], o[1], o[2])), nrm);
      float sl = dot(eye, nrm);
      float sl_a = sl - a;
      sb = d0 > h ? (sl_a >= 0.0f ? INFINITY : (d0 - h) / fmaxf(-sl_a, 1e-12f)) : 0.0f;
      if (CLEAR && a > 0.0f) {
        RT_COUNT(s, OPS_TAIL_CLEAR_FLOOR);
        d_min = fminf(d0, d0 + sl * S_stop);
        if (d_min > 2.0f * p.eps) sb = INFINITY;
      }
      if (frozen) {  // affine along the ray, as the cone: its ends decide
        RT_COUNT(s, OPS_TAIL_DRIFT_FLOOR);
        drift_clear = drift_clear && d0 + sl * S_frz > d_stall &&
                      d0 + sl * S_end > d_stall + c_drift * (S_end - S_frz);
      }
    }
    s_break = fminf(s_break, sb);
    if (!(s_break > 0.0f)) return false;  // no sample past the first is safe
  }

  // k_safe: the last sample strictly before s_break; offset(k) < s_break
  // <=> k < log1p(s_break*a/h)/log_rho (every sample where a < 0 and
  // s_break lies past the tail's limit h/-a)
  RT_COUNT(s, OPS_TAIL_RESOLVE);
  float k_bound;
  if (log_rho != 0.0f) {
    const float q = s_break * a / h;
    k_bound = q > -1.0f ? log1pf(q) / log_rho : 3e7f;
  } else {
    k_bound = s_break / h;
  }
  const float k_safe = ceilf(fminf(k_bound, 3e7f)) - 1.0f;
  // The tail takes a march that stops inside the safe zone (a stall, also
  // with its stretch clear). One that another object would interrupt steps
  // on, as the reference does: the JAX kernel fast-forwards it to s_break,
  // which here moved K4's gradient off autograd's by 5% for under 0.1% of the
  // work (PERF.md §6).
  if (frozen ? !(drift_clear && k_frz <= k_safe) : !(k_stop <= k_safe)) return false;
  const float kf = frozen ? k_frz : k_stop;
  const int k = static_cast<int>(kf);
  const float fd = h * expf(kf * log_rho);
  // the sample the logs stop at must stop as evaluated, or the loop steps
  if (!frozen && kf < k_cap && !(a < 0.0f ? fd < p.eps : fd > p.far_away)) return false;
  const float S = frozen ? S_end : tail_offset(h, a, log_rho, kf + 1.0f);

  if (GLOW) {
    // the glow minimum over samples 1..k (sample 0 is the step's own): an
    // object's distance along the ray is convex (sphere) or affine (floor)
    // in the travel, so its least sample is the last one or one of the two
    // that bracket its continuous minimum
    RT_COUNT_PASS(s);
    float best_v = INFINITY, best_i = 0.0f, best_t = 0.0f;
    int best_j = 0;
    bool best_floor = false;  // a floor's sample, not a stall's stretch
    for (int i = 0; i < s.n; ++i) {
      if (i == ig) continue;
      const float* o = s.f32 + i * F32_COLS;
      const float gd = o[18];
      if (!(gd > 0.0f)) continue;  // its glow metric is never > 0
      const bool sph = s.i32[i * I32_COLS] == KIND_SPHERE;
      float s_star = 0.0f, perp2 = 0.0f, d0 = 0.0f, sl = 0.0f;
      float cand[3];
      int nc = 0;
      if (sph) {
        RT_COUNT(s, OPS_TAIL_GLOW_SPHERE);
        V3 w = sub(v3(o[0], o[1], o[2]), m.pos);
        s_star = dot(w, eye);
        V3 pv = sub(w, scale(eye, s_star));
        perp2 = dot(pv, pv);
        const float s_rel = fminf(fmaxf(s_star, 0.0f), S);
        const float i_star = log_rho != 0.0f
                                 ? log1pf(fmaxf(s_rel * a / h, -0.99999994f)) / log_rho
                                 : s_rel / h;
        const float i1 = fminf(fmaxf(floorf(i_star), 0.0f), kf);
        const float i2 = fminf(i1 + 1.0f, kf);
        if (i1 > 0.0f) cand[nc++] = i1;
        if (i2 > i1) cand[nc++] = i2;
        if (kf > i2) cand[nc++] = kf;
      } else {
        RT_COUNT(s, OPS_TAIL_GLOW_FLOOR);
        V3 nrm = v3(o[3], o[4], o[5]);
        d0 = dot(sub(m.pos, v3(o[0], o[1], o[2])), nrm);
        sl = dot(eye, nrm);
        if (kf > 0.0f) cand[nc++] = kf;
      }
      // a stall's stretch: the sphere's nearest point on it and its end,
      // another floor's end (the winner's distance stays d_stall there)
      float drift_t[2];
      int nd = 0;
      if (frozen) {
        if (sph) drift_t[nd++] = fminf(fmaxf(s_star, S_frz), S_end);
        if (sph || i != win) drift_t[nd++] = S_end;
      }
      for (int c = 0; c < nc + nd; ++c) {
        RT_COUNT(s, sph ? OPS_TAIL_CAND_SPHERE : OPS_TAIL_CAND_FLOOR);
        const float t = c < nc ? tail_offset(h, a, log_rho, cand[c]) : drift_t[c - nc];
        float d;
        if (sph) {
          const float dt = t - s_star;
          d = fmaxf(sqrtf(perp2 + dt * dt) - o[17], 0.0f);
        } else {
          d = fmaxf(d0 + sl * t, 0.0f);
        }
        const float g = d * gd;
        if (g > 0.0f && g < best_v) {
          best_v = g;
          best_t = t;
          best_i = c < nc ? cand[c] : fminf(kf + floorf((t - S_frz) / d_stall), k_cap);
          best_j = i;
          best_floor = !sph && c < nc;
        }
      }
    }
    if (best_v < m.min_dist) {
      m.min_dist = best_v;
      if (TRACK) {
        RT_COUNT(s, 6);
        if (best_floor) {  // the loop's slope, d0 and distance, recomputed
          const float* o = s.f32 + best_j * F32_COLS;
          const V3 nrm = v3(o[3], o[4], o[5]);
          const float sl = dot(eye, nrm);
          RT_COUNT(s, 5);
          if (sl < 0.0f) {
            RT_COUNT(s, OPS_TAIL_TIE + OPS_TAIL_OFFSET + 10);
            const float d0 = dot(sub(m.pos, v3(o[0], o[1], o[2])), nrm);
            const float d = fmaxf(d0 + sl * best_t, 0.0f);
            best_i = first_tied_sample(d, best_v, o[18], d0, sl, h, a, log_rho, best_i);
            best_t = tail_offset(h, a, log_rho, best_i);
          }
        }
        m.glow_pos = add(m.pos, scale(eye, best_t));
        m.glow_iter = m.iter + static_cast<int>(best_i);
        m.glow_obj = best_j;
      }
    }
  }

  m.pos = add(m.pos, scale(eye, S));
  m.travel = m.travel + S;
  // a stall ends at the cap, missing: its distance stays above eps
  m.iter += frozen ? static_cast<int>(k_cap) + 1 : k + 1;
  m.final_dist = frozen ? fmaxf(d_stall, p.eps) : fd;
  m.idx = win;
  return true;
}

// Sphere tracing (render.rs:1266-1297): the step comes before the stop
// check, so the result includes the final step. Without GLOW, min_dist is
// +inf (a shadow march reads only travel and iter). With TRACK, the glow
// argmin is kept as well. With p.floor_skip, floor tails resolve in closed
// form (TEX: but not toward a textured floor, floor_tail); without
// GLOW and TRACK, a march that cannot converge ends at once.
template <bool GLOW, bool TRACK, bool TEX>
RT_INLINE March march_single(const SceneView& s, const MarchParams& p, V3 pos, V3 eye,
                               int ig) {
  March m;
  m.pos = pos;
  m.travel = 0.0f;
  m.iter = 0;
  m.min_dist = INFINITY;
  if (TRACK) {
    m.glow_pos = pos;
    m.glow_iter = -1;
    m.glow_obj = 0;
  }
  if (!GLOW && !TRACK && never_converges(s, p, pos, eye, ig)) {
    RT_COUNT_NEVER(s);
    m.pos = add(pos, scale(eye, p.far_away));
    m.travel = p.far_away;
    m.iter = 1;
    m.final_dist = p.far_away;
    m.idx = 0;
    return m;
  }
  int next_try = p.floor_skip ? 0 : 0x7fffffff;  // the step that may try the floor tail
  for (;;) {
    int idx, glow_obj;
    float glow;
    float dist = distance_estimate<GLOW>(s, m.pos, ig, &idx, &glow, &glow_obj);
    RT_COUNT_PASS(s);
    if (GLOW && glow < m.min_dist) {
      m.min_dist = glow;
      if (TRACK) {
        m.glow_pos = m.pos;
        m.glow_iter = m.iter;
        m.glow_obj = glow_obj;
      }
    }
    if (m.iter >= next_try && s.i32[idx * I32_COLS] != KIND_SPHERE) {
      if (floor_tail<GLOW, TRACK, TEX>(s, p, eye, ig, dist, idx, m)) return m;
      next_try = m.iter + FLOOR_TAIL_PERIOD;
    }
    RT_COUNT(s, OPS_STEP);
    m.pos = add(m.pos, scale(eye, dist));
    m.travel = m.travel + dist;
    m.iter += 1;
    m.final_dist = dist;
    m.idx = idx;
    if (dist < p.eps || dist > p.far_away || m.iter > p.max_iter) return m;
  }
}

template <int D, class Rec>
RT_INLINE C3 raymarch(const SceneView& s, const MarchParams& p, V3 pos, V3 eye, int lev,
                        int ig, int flags, Rec& rec, int parent_site);

// March shading (render.rs:1020-1092) of a hit on object ``idx`` up to its
// refraction: Lambert + Phong, the shadow march and the pattern, or the
// texel where the material is textured (K1a's fetch_texture,
// trace_body.cuh); the marches read no texture. ``site`` is the recorder's
// id of the lap. Returns the face colour kd*k1 + k2 and sets *f_out to the
// hit's transparency.
template <class Rec>
RT_INLINE C3 march_shade_base(const SceneView& s, const MarchParams& p, int idx, V3 n, V3 pt,
                              V3 eye, Rec& rec, int site, float* f_out) {
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
  March sh =
      march_single<false, false, false>(s, p, add(pt, scale(s.light, F32_EPS)), s.light, idx);
  bool lit = sh.travel >= p.far_away || sh.iter >= p.max_iter || f > 0.0f;
  rec.lit(site, lit);
  float k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
  float k2 = lit ? refl : 0.0f;

  float u, v;
  get_uv(sub(pt, v3(o[0], o[1], o[2])), oi[2], o[15], o[16], &u, &v);
  C3 kd;
  if (Rec::TEXTURED && textured(s, oi)) {  // the image replaces the pattern (render.rs:249-316)
    RT_COUNT_TEXEL(s);
    kd = fetch_texture(s.tx, oi[3], u, v);
  } else {
    kd = pattern_diffuse(o, oi[1], u, v);
  }
  *f_out = f;
  return c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);
}

// The pseudo-refraction's sub-ray from a hit on object row ``o`` with
// normal ``n`` (render.rs:1093-1132): the bent direction, and the
// sub-march's flags in *sub_flags.
RT_INLINE V3 refraction_ray(const float* o, V3 n, V3 eye, int* sub_flags) {
  float sp_n = dot(eye, n);
  float fracn = fabsf(o[14]) > 1e-6f ? o[14] : 1.0f;
  float bend = sp_n * ((sp_n > 0.0f ? fracn : 1.0f / fracn) - 1.0f);
  *sub_flags = sp_n < 0.0f ? OUTONLY : INONLY;
  return normalized(add(eye, v3(n.x * bend, n.y * bend, n.z * bend)));
}

// A refracting hit's face: its own colour ``base`` and the sub-march's
// colour ``fc2`` blended by the transparency f.
RT_INLINE C3 refraction_blend(C3 base, float f, C3 fc2) {
  return c3(base.r * (1.0f - f) + fc2.r * f, base.g * (1.0f - f) + fc2.g * f,
            base.b * (1.0f - f) + fc2.b * f);
}

// March shading (render.rs:1020-1140) of a hit on object ``idx`` at level
// ``nest``, by the raymarch frame at depth D: march_shade_base, then the
// pseudo-refraction, which ignores the source and marches the sub-ray from
// level ``nest``.
template <int D, class Rec>
RT_INLINE C3 march_shading(const SceneView& s, const MarchParams& p, int idx, V3 n, V3 pt,
                           V3 eye, int nest, Rec& rec, int site) {
  float f;
  const C3 base = march_shade_base(s, p, idx, n, pt, eye, rec, site, &f);
  if (!(nest < p.refraction_cap && f > 0.0f)) return base;
  int sub_flags;
  const V3 ray = refraction_ray(s.f32 + idx * F32_COLS, n, eye, &sub_flags);
  C3 fc2;
  if constexpr (D + 1 < MARCH_FRAMES) {
    fc2 = raymarch<D + 1>(s, p, add(pt, scale(ray, F32_EPS)), ray, nest, idx, sub_flags, rec,
                          site);
  } else {  // unreachable under the bound: poison the pixel, never drop work
    fc2 = c3(nanf(""), nanf(""), nanf(""));
  }
  return refraction_blend(base, f, fc2);
}

// The march + reflect loop of one ray at level ``lev`` (render.rs:1299-1411),
// ending with its glow factor. ``parent_site`` is the recorder's id of the
// lap whose refraction started it (-1 for the camera ray).
template <int D, class Rec>
RT_INLINE C3 raymarch(const SceneView& s, const MarchParams& p, V3 pos, V3 eye, int lev,
                        int ig, int flags, Rec& rec, int parent_site) {
  const int frame = rec.frame(parent_site);
  C3 fcs = c3(1.0f, 1.0f, 1.0f);
  C3 ret = c3(0.0f, 0.0f, 0.0f);
  float min_min_dist = INFINITY;
  March res;
  bool need_march = true;
  const int laps = p.max_laps - lev > 1 ? p.max_laps - lev : 1;
  for (int step = 0; step < laps; ++step) {
    const int lev_i = lev + 1 + step;
    if (need_march) {
      res = p.glow_on ? march_single<true, Rec::TRACK_GLOW, Rec::TEXTURED>(s, p, pos, eye, ig)
                      : march_single<false, Rec::TRACK_GLOW, Rec::TEXTURED>(s, p, pos, eye, ig);
    }
    const bool hit = res.final_dist < p.eps;
    const int site = rec.site(frame, eye, ig, flags, fcs, res, hit);
    if (res.min_dist < min_min_dist) {
      min_min_dist = res.min_dist;
      rec.glow(frame, site, res, hit);
    }
    if (!hit) {
      // a miss keeps the lane and its march, and re-adds the sky each lap
      C3 bg = background(p.bg, s.light, eye);
      ret = c3(ret.r + bg.r * fcs.r, ret.g + bg.g * fcs.g, ret.b + bg.b * fcs.b);
      need_march = false;
      continue;
    }
    const float* o = s.f32 + res.idx * F32_COLS;
    V3 pt = res.pos;
    V3 n = surface_normal(o, s.i32[res.idx * I32_COLS], pt);
    C3 face = march_shading<D>(s, p, res.idx, n, pt, eye, lev_i, rec, site);

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
  C3 out = ret;
  if (p.glow_on && !(fabsf(min_min_dist) == INFINITY)) {
    float factor = 1.0f + p.glow * powf(0.99f, min_min_dist);
    out = c3(ret.r * factor, ret.g * factor, ret.b * factor);
  }
  rec.frame_end(frame, ret, out);
  return out;
}

// The colour of pixel (ix, iy). ``cam`` is the packed camera row.
template <class Rec>
RT_INLINE C3 march_pixel(const SceneView& s, const MarchParams& p, const float* cam, int ix,
                         int iy, Rec& rec) {
  V3 eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  return raymarch<0>(s, p, v3(cam[0], cam[1], cam[2]), eye, 0, -1, 0, rec, -1);
}

RT_INLINE C3 march_pixel(const SceneView& s, const MarchParams& p, const float* cam, int ix,
                         int iy) {
  NoMarchRecord rec;
  return march_pixel(s, p, cam, ix, iy, rec);
}

// The deep march: raymarch's refraction recursion written a second time, as
// one loop over an explicit stack of suspended raymarch calls, for
// refraction caps past MARCH_FRAMES (K3's march_fwd_deep.cu, K4's buffer
// instance march_bwd_buf.cu). A call is suspended where a lap's hit starts
// a refraction sub-march; the sub-march then runs in the loop's state, and
// when its glow factor is done its colour resumes the lap that started it,
// which blends it, accumulates and bounces as raymarch does. Every float
// operation and every recorder call (frame, site, lit, glow, frame_end)
// comes in raymarch's order, so the image is the recursive body's bit for
// bit wherever that one takes the cap, and with march_floor_skip off the
// plain march's. The stack holds MARCH_FRAMES_DEEP - 1 suspended calls
// beside the running one: a chain of nested calls climbs through distinct
// levels below the cap, so it takes refraction caps up to
// MARCH_FRAMES_DEEP, any raymarch_max_reflections. An entry is 100 bytes,
// so the stack is 6.3 KB of local memory a thread, touched once a
// sub-march each way.
constexpr int MARCH_FRAMES_DEEP = 64;  // ops/kernel_march.py: FRAME_CAP_DEEP

// A raymarch call suspended at the lap whose hit started a sub-march: what
// the lap needs to finish (its face colour and transparency, the hit's
// object, point and normal, the direction it marched) and the call's state
// for its next laps. The lap's successor starts from the hit, so the call's
// start point, ignored object and march result are dead here.
struct MarchFrame {
  V3 eye, n, pt;
  C3 fcs, ret;   // the call's throughput and colour before the lap's face
  C3 base;       // the lap's kd*k1 + k2
  float f;       // the hit's transparency
  float min_min_dist;
  int lev, step, flags, idx;
  int frame;     // the recorder's id of the call
};

// raymarch<0> of the ray from ``pos`` along ``eye`` on the explicit stack.
template <class Rec>
RT_INLINE C3 raymarch_deep(const SceneView& s, const MarchParams& p, V3 pos, V3 eye, Rec& rec) {
  MarchFrame stack[MARCH_FRAMES_DEEP - 1];
  int depth = 0;
  // the running call: raymarch's arguments and locals
  int lev = 0, ig = -1, flags = 0, step = 0;
  int frame = rec.frame(-1);
  C3 fcs = c3(1.0f, 1.0f, 1.0f);
  C3 ret = c3(0.0f, 0.0f, 0.0f);
  float min_min_dist = INFINITY;
  March res;
  bool need_march = true;
  // the lap at ``step``: its hit, and after a sub-march (``resumed``) its
  // colour ``sub``
  V3 n = v3(0.0f, 0.0f, 0.0f), pt = n;
  C3 base = c3(0.0f, 0.0f, 0.0f), sub = base;
  float f = 0.0f;
  int idx = 0;
  bool resumed = false;
  for (;;) {
    const int laps = p.max_laps - lev > 1 ? p.max_laps - lev : 1;
    bool called = false;  // a lap started a sub-march, which runs next
    for (; step < laps; ++step) {
      const int lev_i = lev + 1 + step;
      C3 face;
      if (resumed) {
        resumed = false;
        face = refraction_blend(base, f, sub);
      } else {
        if (need_march) {
          res = p.glow_on ? march_single<true, Rec::TRACK_GLOW, Rec::TEXTURED>(s, p, pos, eye, ig)
                          : march_single<false, Rec::TRACK_GLOW, Rec::TEXTURED>(s, p, pos, eye, ig);
        }
        const bool hit = res.final_dist < p.eps;
        const int site = rec.site(frame, eye, ig, flags, fcs, res, hit);
        if (res.min_dist < min_min_dist) {
          min_min_dist = res.min_dist;
          rec.glow(frame, site, res, hit);
        }
        if (!hit) {
          // a miss keeps the lane and its march, and re-adds the sky each lap
          C3 bg = background(p.bg, s.light, eye);
          ret = c3(ret.r + bg.r * fcs.r, ret.g + bg.g * fcs.g, ret.b + bg.b * fcs.b);
          need_march = false;
          continue;
        }
        idx = res.idx;
        pt = res.pos;
        n = surface_normal(s.f32 + idx * F32_COLS, s.i32[idx * I32_COLS], pt);
        base = march_shade_base(s, p, idx, n, pt, eye, rec, site, &f);
        face = base;
        if (lev_i < p.refraction_cap && f > 0.0f) {
          int sub_flags;
          const V3 ray = refraction_ray(s.f32 + idx * F32_COLS, n, eye, &sub_flags);
          if (depth < MARCH_FRAMES_DEEP - 1) {  // suspend this call, start the sub-march
            MarchFrame& c = stack[depth++];
            c.eye = eye;
            c.n = n;
            c.pt = pt;
            c.fcs = fcs;
            c.ret = ret;
            c.base = base;
            c.f = f;
            c.min_min_dist = min_min_dist;
            c.lev = lev;
            c.step = step;
            c.flags = flags;
            c.idx = idx;
            c.frame = frame;
            frame = rec.frame(site);
            pos = add(pt, scale(ray, F32_EPS));
            eye = ray;
            lev = lev_i;
            ig = idx;
            flags = sub_flags;
            step = 0;
            fcs = c3(1.0f, 1.0f, 1.0f);
            ret = c3(0.0f, 0.0f, 0.0f);
            min_min_dist = INFINITY;
            need_march = true;
            called = true;
            break;
          }
          // unreachable under the bound: poison the pixel, never drop work
          face = refraction_blend(base, f, c3(nanf(""), nanf(""), nanf("")));
        }
      }

      // accumulate with the per-channel IGNORE guards (render.rs:1175-1186)
      const float* o = s.f32 + idx * F32_COLS;
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

      bool cont = idx != 0 && fcs.r + fcs.g + fcs.b > 0.1f && lev_i < p.max_laps;
      if (!cont) break;
      // mirror bounce + entry/exit flag flip (render.rs:1199-1211)
      float en2 = -2.0f * dot(eye, n);
      V3 new_eye = add(eye, v3(n.x * en2, n.y * en2, n.z * en2));
      flags = dot(n, new_eye) < 0.0f ? ((flags & ~INONLY) | OUTONLY)
                                     : ((flags & ~OUTONLY) | INONLY);
      pos = pt;
      eye = new_eye;
      ig = idx;
      need_march = true;
    }
    if (called) continue;
    C3 out = ret;
    if (p.glow_on && !(fabsf(min_min_dist) == INFINITY)) {
      float factor = 1.0f + p.glow * powf(0.99f, min_min_dist);
      out = c3(ret.r * factor, ret.g * factor, ret.b * factor);
    }
    rec.frame_end(frame, ret, out);
    if (depth == 0) return out;
    const MarchFrame& c = stack[--depth];  // resume the caller's lap
    eye = c.eye;
    n = c.n;
    pt = c.pt;
    fcs = c.fcs;
    ret = c.ret;
    base = c.base;
    f = c.f;
    min_min_dist = c.min_min_dist;
    lev = c.lev;
    step = c.step;
    flags = c.flags;
    idx = c.idx;
    frame = c.frame;
    sub = out;
    resumed = true;
  }
}

// march_pixel through the deep march.
template <class Rec>
RT_INLINE C3 march_pixel_deep(const SceneView& s, const MarchParams& p, const float* cam,
                              int ix, int iy, Rec& rec) {
  V3 eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  return raymarch_deep(s, p, v3(cam[0], cam[1], cam[2]), eye, rec);
}

RT_INLINE C3 march_pixel_deep(const SceneView& s, const MarchParams& p, const float* cam,
                              int ix, int iy) {
  NoMarchRecord rec;
  return march_pixel_deep(s, p, cam, ix, iy, rec);
}

}  // namespace rt
