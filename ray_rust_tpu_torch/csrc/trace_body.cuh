// Per-pixel body of the Whitted trace forward (trace mode), shared by the
// CUDA kernel (trace_fwd.cu) and a host build (trace_host.cpp) that the CPU
// tests run against the plain PyTorch version.
//
// It computes what ray_rust_tpu/ops/pallas_trace.py:render_color_pallas
// computes for one pixel: the camera ray (render.rs:808-815), the reflection
// loop with its throughput, object-0 and depth exits (render.rs:1142-1224),
// the nearest-hit scan over all objects (render.rs:993-1018), shading with a
// shadow ray that passes transparent blockers, Lambert + Phong, procedural
// patterns or image textures (K1a), the pseudo-refraction subtree
// (render.rs:1020-1140) and the sky (src/main.rs:231-260). Every operation
// is written in the order the plain version (ops/trace.py) evaluates it, in
// f32, so that a build without contracted multiply-adds rounds as it does.
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
// Image textures (K1a, replacing ray_rust_tpu/ops/pallas_trace.py:
// fetch_taps, fetch_texture and _tex_blend): a textured hit reads its texel's
// 2x2 wrap neighbourhood from the atlas that ops/kernel_trace.py:pack_textures
// builds, one 16-byte word a texel (four r | g<<8 | b<<16 taps), and blends
// the taps in f32 as the plain version (ops/texture.py:sample_texture_packed)
// does. The lookup is arithmetic, not a CUDA texture object: hardware
// bilinear filtering weighs in 8-bit fixed point and hardware wrapping is
// not the reference's imod/fimod, so neither would give the plain version's
// floats. Float-to-int conversions follow torch's on the same device, so the
// card's build matches the plain version on the card and the host build the
// plain version on the CPU even where u*w overflows int32 at the horizon.
//
// The untextured trace is generic over its scalar type T (forward-mode
// derivatives, K5: dual.cuh, trace_retrace.cu). With T = float it is the
// forward's code. With T = Dual<L> every value is the float trace's own,
// operation for operation, and the tangents are the derivatives by L seeded
// entries of the tables, whose rows the body reads seeded (table_row; the
// camera row's entries follow the objects'): every decision (winner, flags,
// lit, cont, pattern cell) is taken on the value, each nearest-hit scan
// runs on the values and recomputes only the winner's t in T, the shadow
// scan runs on the values alone, and a hit at t >= SceneViewT::cutoff
// keeps its point as a constant (the JAX kernel's grad_distance_cutoff,
// pallas_trace.py:984-988). The texture fetch stays float-only. Every function is forced inline (RT_FI): the kernels are one
// function each, and chip_smoke.py fails when ptxas reports another.
//
// A build with -DRT_COUNT_OPS counts the f32 arithmetic of the object loops
// (the fewest operations each object test can take) into SceneView::ops[0],
// and the texel bytes the traversal's texture fetches read into ops[1], for
// the kernels' roofline bound; the ordinary build compiles it away.
#pragma once

#include <math.h>

#include <type_traits>

#include "dual.cuh"

#ifdef __CUDACC__
#define RT_FI __host__ __device__ __forceinline__
#else
#define RT_FI inline
#endif

#ifdef RT_COUNT_OPS
#define RT_COUNT(s, k) ((s).ops[0] += static_cast<unsigned long long>(k))
#define RT_COUNT_TEXEL(s) ((s).ops[1] += sizeof(Texel4))
#else
#define RT_COUNT(s, k) ((void)0)
#define RT_COUNT_TEXEL(s) ((void)0)
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
constexpr int TEX_META_COLS = 4;  // width, height, base texel, filter

constexpr int KIND_SPHERE = 0;
constexpr int PATTERN_CHECKERBOARD = 1;
constexpr int PATTERN_GRADATION = 2;
constexpr int UVMAP_YZ = 1;
constexpr int UVMAP_ZX = 2;
constexpr int UVMAP_LL = 3;
constexpr int FILTER_BILINEAR = 1;
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

template <class T>
struct V3T {
  T x, y, z;
};
template <class T>
struct C3T {
  T r, g, b;
};
using V3 = V3T<float>;
using C3 = C3T<float>;

template <class T>
RT_FI V3T<T> v3(T x, T y, T z) {
  V3T<T> v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
template <class T>
RT_FI C3T<T> c3(T r, T g, T b) {
  C3T<T> c;
  c.r = r;
  c.g = g;
  c.b = b;
  return c;
}
template <class T>
RT_FI V3T<T> add(V3T<T> a, V3T<T> b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
template <class T>
RT_FI V3T<T> sub(V3T<T> a, V3T<T> b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
template <class T, class S>
RT_FI V3T<T> scale(V3T<T> a, S s) { return v3(a.x * s, a.y * s, a.z * s); }
template <class T>
RT_FI T dot(V3T<T> a, V3T<T> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RT_FI bool is_finite(float x) { return fabsf(x) < INFINITY; }
// the values of a vector, and the vector with its tangents cut (dual.cuh)
template <class T>
RT_FI V3 val3(V3T<T> a) { return v3(val(a.x), val(a.y), val(a.z)); }
template <class T>
RT_FI V3T<T> stop3(V3T<T> a) { return v3(stop(a.x), stop(a.y), stop(a.z)); }

// v / sqrt(v.v), a sqrt then a divide (vec3.rs:36-39); 0 at zero length.
template <class T>
RT_FI V3T<T> normalized(V3T<T> v) {
  T sq = dot(v, v);
  if (!(sq > 0.0f)) return V3T<T>{0.0f, 0.0f, 0.0f};
  T ln = sqrtf(sq);
  return v3(v.x / ln, v.y / ln, v.z / ln);
}

// Hamilton product (quat.rs:63-72); quaternions as (x, y, z, w).
template <class T>
struct Q4T {
  T x, y, z, w;
};
using Q4 = Q4T<float>;
template <class T>
RT_FI Q4T<T> qmul(Q4T<T> a, Q4T<T> b) {
  Q4T<T> q;
  q.x = a.y * b.z - a.z * b.y + a.x * b.w + a.w * b.x;
  q.y = a.z * b.x - a.x * b.z + a.y * b.w + a.w * b.y;
  q.z = a.x * b.y - a.y * b.x + a.z * b.w + a.w * b.z;
  q.w = -a.x * b.x - a.y * b.y - a.z * b.z + a.w * b.w;
  return q;
}

// Cephes atanf / asinf (utils/fastmath.py), not the libm functions.
template <class T>
RT_FI T cephes_atan(T x) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  T a = fabsf(x);
  T xr;
  float y0;
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
  T z = xr * xr;
  T p = (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
         3.33329491539e-1f) * z * xr + xr;
  return sign * (y0 + p);
}

template <class T>
RT_FI T cephes_atan2(T y, T x) {
  if (x == 0.0f) return T(y > 0.0f ? PIO2_F : (y < 0.0f ? -PIO2_F : 0.0f));
  T z = cephes_atan(y / x);
  float w = x < 0.0f ? (y < 0.0f ? -PI_F : PI_F) : 0.0f;
  return w + z;
}

template <class T>
RT_FI T cephes_asin(T x) {
  float sign = x < 0.0f ? -1.0f : 1.0f;
  T a = fminf(fabsf(x), 1.0f);
  bool big = a > 0.5f;
  T z = big ? 0.5f * (1.0f - a) : a * a;
  T xr = big ? sqrtf(z) : a;
  T p = ((((4.2163199048e-2f * z + 2.4181311049e-2f) * z + 4.5470025998e-2f) * z +
              7.4953002686e-2f) * z + 1.6666752422e-1f) * z * xr + xr;
  return sign * (big ? PIO2_F - 2.0f * p : p);
}

// f - floor(f/freq)*freq (modutil.rs:1-3)
template <class T>
RT_FI T floor_mod(T f, float freq) { return f - floorf(f / freq) * freq; }

// Stripe-grid sky with sun glare (ops/sky.py:default_sky).
template <class T>
RT_FI C3T<T> background(int bg, V3T<T> light, V3T<T> d) {
  if (bg == BG_BLACK) return C3T<T>{0.0f, 0.0f, 0.0f};
  T phi = cephes_atan2(d.z, d.x);
  T the = cephes_asin(fminf(fmaxf(d.y, -1.0f), 1.0f));
  T dp = fmodf(SKY_A + phi * 10.0f * PI_F, TWO_PI_F) - PI_F;
  T dt = fmodf(SKY_A + the * 10.0f * PI_F, TWO_PI_F) - PI_F;
  T base_r = 0.5f / (15.0f * (dp * dp * dt * dt) + 1.0f);
  T base_gb = 0.25f - d.y / 4.0f;
  T ld = dot(light, d);
  if (ld > 0.9995f) return C3T<T>{2.0f, 2.0f, 2.0f};
  T glare = ld > 0.995f ? (ld - 0.995f) * 150.0f : 0.0f;
  T dot2 = ld > 0.9f ? (ld - 0.9f) * 5.0f : 0.0f;
  return c3(base_r + glare + dot2, base_gb + glare + dot2, base_gb + glare);
}

// One atlas texel's 2x2 wrap neighbourhood (TextureBank.packed's taps, x
// then y), each tap r | g<<8 | b<<16: one 16-byte load.
struct alignas(16) Texel4 {
  unsigned int p00, p10, p01, p11;
};

// The texture atlas as the kernels take it (ops/kernel_trace.py:
// pack_textures): ``len`` texels, ``stride`` (the widest texture's width) a
// row, and a (n_tex, TEX_META_COLS) meta table. All zero when the scene has
// no texture.
struct TexArgs {
  const Texel4* tex;
  const int* meta;
  int n_tex, stride, len;
};

// The packed scene as the body reads it: per-object rows, the light and the
// texture atlas (none by default: the march bodies read no texture). A
// Dual<L> trace also carries the entry of the cotangent block (object rows
// of F32_COLS, then the camera's 7 and the light's 3 columns) that its
// tangent lane 0 is seeded at, and the gradient's distance cutoff.
template <class T>
struct SceneViewT {
  const float* f32;  // (n, F32_COLS)
  const int* i32;    // (n, I32_COLS)
  int n;
  V3T<T> light;
  TexArgs tx = {nullptr, nullptr, 0, 0, 0};
  int seed = 0;
  float cutoff = INFINITY;
#ifdef RT_COUNT_OPS
  unsigned long long* ops;  // this thread's counts: f32 operations, texel bytes
#endif
};
using SceneView = SceneViewT<float>;

// Object i's f32 row as a T trace reads it: the row itself for float, its
// entries seeded in their tangent lanes for Dual<L>.
template <class T>
RT_FI auto table_row(const SceneViewT<T>& s, int i) {
  if constexpr (is_dual_v<T>) {
    return T::row(s.f32 + i * F32_COLS, i * F32_COLS - s.seed);
  } else {
    return s.f32 + i * F32_COLS;
  }
}

// Render parameters: image size, 2*fov in f32, depth caps, background id.
struct Params {
  int xres, yres;
  float sx, sy;
  int max_reflections;
  int refraction_cap;  // min(max_refractions, refraction_unroll)
  int bg;
};

// One object's intersection parameter, or +inf (ops/intersect.py), for
// object row ``o`` (table_row).
template <class R, class T>
RT_FI T candidate_t(R o, int kind, V3T<T> vi, V3T<T> eye, float t_run, int flags) {
  V3T<T> wpt = sub(vi, V3T<T>{o[0], o[1], o[2]});
  if (kind == KIND_SPHERE) {
    T r = o[17];
    T b = 2.0f * dot(eye, wpt);
    T c = dot(wpt, wpt) - r * r;
    T d2 = b * b - 4.0f * c;
    if (!(d2 >= F32_EPS)) return T(INFINITY);
    T d = sqrtf(d2);
    T t0 = (-b - d) / 2.0f;
    T t1 = t0 + d;
    if (!(flags & OUTONLY) && t0 >= 0.0f && t0 < t_run) return t0;
    if (!(flags & INONLY) && t1 > 0.0f && t1 < t_run) return t1;
    return T(INFINITY);
  }
  V3T<T> nrm = {o[3], o[4], o[5]};
  T w = dot(nrm, eye);
  if (!(w < 0.0f)) return T(INFINITY);
  T t0 = -dot(nrm, wpt) / w;
  return (t0 >= 0.0f && t0 < t_run) ? t0 : T(INFINITY);
}

// Nearest hit on the values: strictly closer wins, first index wins ties,
// object ``ig`` skipped. Returns t (+inf on a miss, with *idx = 0).
template <class T>
RT_FI float nearest_t(const SceneViewT<T>& s, V3 vi, V3 eye, int ig, int flags, int* idx) {
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

// The nearest hit's t in T: the scan on the values, then for a Dual<L>
// trace the winner's t again from its seeded row. Without the running
// bound the winner takes the same root, so the value is the scan's.
template <class T>
RT_FI T raycast(const SceneViewT<T>& s, V3T<T> vi, V3T<T> eye, int ig, int flags, int* idx) {
  if constexpr (is_dual_v<T>) {
    const float t = nearest_t(s, val3(vi), val3(eye), ig, flags, idx);
    if (!is_finite(t)) return T(t);
    return candidate_t(table_row(s, *idx), s.i32[*idx * I32_COLS], vi, eye, INFINITY, flags);
  } else {
    return nearest_t(s, vi, eye, ig, flags, idx);
  }
}

template <class T>
RT_FI void get_uv(V3T<T> rel, int uvmap, T ps, T pas, T* u, T* v) {
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
RT_FI int floor_to_int(float x) {
  float f = floorf(x);
  if (f >= 2147483648.0f) return 2147483647;
  if (!(f >= -2147483648.0f)) return (int)0x80000000u;
  return (int)f;
}

// Procedural pattern colour (render.rs:301-314) of object row ``o``.
template <class R, class T>
RT_FI C3T<T> pattern_diffuse(R o, int pattern, T u, T v) {
  C3T<T> d = {o[6], o[7], o[8]};
  if (pattern == PATTERN_GRADATION)
    return c3(d.r * floor_mod(u, 1.0f), d.g * floor_mod(v, 1.0f), d.b);
  // checkerboard: black where floor(u) + floor(v) is even
  if (pattern == PATTERN_CHECKERBOARD &&
      ((floor_to_int(val(u)) ^ floor_to_int(val(v))) & 1) == 0)
    return C3T<T>{0.0f, 0.0f, 0.0f};
  return d;
}

// f32 -> int32 as torch converts on the same device: the card's conversion
// saturates (NaN -> 0), the CPU's (x86 cvttss2si) gives INT_MIN for anything
// out of range.
RT_FI int f32_to_i32(float x) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(x);
#else
  return (x >= -2147483648.0f && x < 2147483648.0f) ? static_cast<int>(x)
                                                      : static_cast<int>(0x80000000u);
#endif
}

// Integer modulo via f32 division (modutil.rs:4-6), wrapping in int32 as
// torch's integer arithmetic does.
RT_FI int imod(int f, int freq) {
  const int q = f32_to_i32(floorf(static_cast<float>(f) / static_cast<float>(freq)));
  return static_cast<int>(static_cast<unsigned>(f) -
                          static_cast<unsigned>(q) * static_cast<unsigned>(freq));
}

// (frac, idx) split of the floored modulo (modutil.rs:10-14): returns the
// fraction and sets *idx.
RT_FI float fimod(float f, float freq, int* idx) {
  const float fm = floor_mod(f, freq);
  *idx = imod(f32_to_i32(fm), f32_to_i32(freq));
  return fm - floorf(fm);
}

// Where texture ``tid``'s lookup at (u, v) reads the atlas (render.rs:253-
// 296): Nearest truncates u*w toward zero, Bilinear floors it and keeps the
// fractions (*fu, *fv); both wrap by the texture's true size. The flat index
// is clamped to the atlas (in range for every finite uv) as the plain version
// and the JAX kernel (pallas_trace.py:674) clamp it. Sets *bilin.
RT_FI int texel_index(const TexArgs& tx, int tid, float u, float v, bool* bilin, float* fu,
                      float* fv) {
  const int* m = tx.meta + TEX_META_COLS * (tid < tx.n_tex ? tid : tx.n_tex - 1);
  const int w = m[0], h = m[1];
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  *bilin = m[3] == FILTER_BILINEAR;
  int ix, iy;
  if (*bilin) {
    *fu = fimod(u * wf, wf, &ix);
    *fv = fimod(v * hf, hf, &iy);
  } else {
    ix = imod(f32_to_i32(truncf(u * wf)), w);
    iy = imod(f32_to_i32(truncf(v * hf)), h);
  }
  long long flat = static_cast<long long>(m[2]) + static_cast<long long>(iy) * tx.stride + ix;
  flat = flat < 0 ? 0 : (flat >= tx.len ? tx.len - 1 : flat);
  return static_cast<int>(flat);
}

// One texel's taps: on the card one read-only 16-byte load.
RT_FI Texel4 load_texel(const Texel4* p) {
#ifdef __CUDA_ARCH__
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  Texel4 t;
  t.p00 = q.x;
  t.p10 = q.y;
  t.p01 = q.z;
  t.p11 = q.w;
  return t;
#else
  return *p;
#endif
}

RT_FI C3 unpack_tap(unsigned int w) {
  return c3(static_cast<float>(w & 0xFFu), static_cast<float>((w >> 8) & 0xFFu),
            static_cast<float>((w >> 16) & 0xFFu));
}

// The texture colour at (u, v), in [0, 1): texture ``tid`` (>= 0) sampled
// Nearest or Bilinear, blended in the reference's term order
// (pixelutil.rs:4-13; ops/texture.py:_blend), then / 256.
RT_FI C3 fetch_texture(const TexArgs& tx, int tid, float u, float v) {
  bool bilin;
  float fu = 0.0f, fv = 0.0f;
  const Texel4 q = load_texel(tx.tex + texel_index(tx, tid, u, v, &bilin, &fu, &fv));
  const C3 p00 = unpack_tap(q.p00);
  if (!bilin) return c3(p00.r / 256.0f, p00.g / 256.0f, p00.b / 256.0f);
  const C3 p10 = unpack_tap(q.p10), p01 = unpack_tap(q.p01), p11 = unpack_tap(q.p11);
  const float a = (1.0f - fu) * (1.0f - fv), b = (1.0f - fu) * fv;
  const float c = fu * (1.0f - fv), d = fu * fv;
  return c3((a * p00.r + b * p01.r + c * p10.r + d * p11.r) / 256.0f,
            (a * p00.g + b * p01.g + c * p10.g + d * p11.g) / 256.0f,
            (a * p00.b + b * p01.b + c * p10.b + d * p11.b) / 256.0f);
}

// Whether the hit on object row ``oi`` reads a texture: its material has one
// and the scene carries an atlas (as ops/texture.py:lookup_diffuse).
template <class T>
RT_FI bool textured(const SceneViewT<T>& s, const int* oi) {
  return oi[3] >= 0 && s.tx.n_tex > 0;
}

// Sphere (pt - org)/|pt - org| (render.rs:443-445) or the floor's stored
// face normal (render.rs:553-555), for object row ``o`` of kind ``kind``.
template <class R, class T>
RT_FI V3T<T> surface_normal(R o, int kind, V3T<T> pt) {
  return kind == KIND_SPHERE ? normalized(sub(pt, V3T<T>{o[0], o[1], o[2]}))
                             : V3T<T>{o[3], o[4], o[5]};
}

// The camera ray of pixel (ix, iy) (render.rs:808-815):
// normalize(rot * (1, ey, ez, 0) * conj(rot)). ``cam`` is the packed camera
// row, or a Dual trace's seeded view of it.
template <class R>
RT_FI auto camera_ray(int xres, int yres, float sx, float sy, R cam, int ix, int iy) {
  using T = std::decay_t<decltype(cam[0])>;
  float ey = (float)(ix - xres / 2) * sx / (float)xres;
  float ez = -(float)(iy - yres / 2) * sy / (float)yres;
  Q4T<T> q = {cam[3], cam[4], cam[5], cam[6]};
  Q4T<T> qc = {-q.x, -q.y, -q.z, q.w};
  Q4T<T> e = {1.0f, ey, ez, 0.0f};
  Q4T<T> r = qmul(qmul(q, e), qc);
  return normalized(v3(r.x, r.y, r.z));
}

// A pending trace: start ray, level, ignored object, flags, the weight its
// colour carries into the pixel, and the recorder's id of the site that
// pushed it (-1 for the camera ray).
template <class T>
struct TaskT {
  V3T<T> vi, eye;
  C3T<T> w;
  int lev, ig, flags;
  int parent;
};
using Task = TaskT<float>;

// The forward kernel's recorder (and the re-trace's): records nothing.
struct NoRecord {
  template <class Tk>
  RT_FI void task(const Tk&) {}
  template <class V, class C>
  RT_FI int site(V, V, C, int, int, bool, bool) {
    return -1;
  }
};

// Run one trace (render.rs:1142-1224) and add its weighted colour to *out;
// refraction sub-traces go onto the stack. ``rec.task`` sees the trace
// start and ``rec.site`` each raycast site: its ray, throughput, flags,
// winner, hit and shadow outcome; the id it returns is the parent of the
// site's refraction sub-trace.
template <class T, class Rec>
RT_FI void trace_task(const SceneViewT<T>& s, const Params& p, const TaskT<T>& tk, C3T<T>* out,
                      TaskT<T>* stack, int* sp, Rec& rec) {
  rec.task(tk);
  V3T<T> vi = tk.vi, eye = tk.eye;
  int ig = tk.ig, flags = tk.flags;
  C3T<T> fcs = {1.0f, 1.0f, 1.0f};
  int n_iters = p.max_reflections - tk.lev > 1 ? p.max_reflections - tk.lev : 1;
  for (int step = 0; step < n_iters; ++step) {
    int lev = tk.lev + 1 + step;
    int idx;
    T t = raycast(s, vi, eye, ig, flags, &idx);
    if (!is_finite(t)) {
      rec.site(vi, eye, fcs, flags, idx, false, false);
      // a miss picks up the background once, unguarded (render.rs:1212-1217)
      C3T<T> bg = background(p.bg, s.light, eye);
      out->r += tk.w.r * (bg.r * fcs.r);
      out->g += tk.w.g * (bg.g * fcs.g);
      out->b += tk.w.b * (bg.b * fcs.b);
      return;
    }
    const auto o = table_row(s, idx);
    const int* oi = s.i32 + idx * I32_COLS;
    V3T<T> pt = add(vi, scale(eye, t));
    if constexpr (is_dual_v<T>) {  // a hit past the cutoff is a constant point
      if (!(val(t) < s.cutoff)) pt = stop3(pt);
    }
    V3T<T> org = {o[0], o[1], o[2]};
    V3T<T> n = surface_normal(o, oi[0], pt);

    // Lambert + Phong (render.rs:1024-1046)
    T li = dot(s.light, n);
    T ln2 = 2.0f * li;
    V3T<T> rtl = sub(v3(n.x * ln2, n.y * ln2, n.z * ln2), s.light);
    T di = fmaxf(li, 0.0f);
    T pn = o[12];
    T ri = -dot(rtl, eye);
    T refl = (pn != 0.0f && ri > 0.0f) ? powf(ri, pn) : 0.0f;

    // shadow ray, on the values: lit when it escapes or its blocker is
    // transparent
    int i_s;
    float t_s = nearest_t(s, add(val3(pt), scale(val3(s.light), F32_EPS)), val3(s.light), idx,
                          0, &i_s);
    bool lit = !is_finite(t_s) || s.f32[i_s * F32_COLS + 13] > 0.0f;
    const int site = rec.site(vi, eye, fcs, flags, idx, true, lit);
    T k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
    T k2 = lit ? refl : 0.0f;

    T u, v;
    get_uv(sub(pt, org), oi[2], o[15], o[16], &u, &v);
    C3T<T> kd;
    if constexpr (is_dual_v<T>) {  // the re-trace takes untextured scenes
      kd = pattern_diffuse(o, oi[1], u, v);
    } else if (textured(s, oi)) {  // the image replaces the pattern (render.rs:249-316)
      RT_COUNT_TEXEL(s);
      kd = fetch_texture(s.tx, oi[3], u, v);
    } else {
      kd = pattern_diffuse(o, oi[1], u, v);
    }
    C3T<T> face = c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);

    bool mr = !(flags & RIGNORE), mg = !(flags & GIGNORE), mb = !(flags & BIGNORE);
    T f = o[13];
    if (lev < p.refraction_cap && f > 0.0f) {
      // pseudo-refraction (render.rs:1093-1132): bend, ignore the source
      T sp_n = dot(eye, n);
      T fracn = fabsf(o[14]) > 1e-6f ? o[14] : 1.0f;
      T bend = sp_n * ((sp_n > 0.0f ? fracn : 1.0f / fracn) - 1.0f);
      V3T<T> ray = normalized(add(eye, v3(n.x * bend, n.y * bend, n.z * bend)));
      TaskT<T> c;
      c.vi = add(pt, scale(ray, F32_EPS));
      c.eye = ray;
      c.lev = lev;
      c.ig = idx;
      c.flags = sp_n < 0.0f ? OUTONLY : INONLY;
      c.parent = site;
      c.w = C3T<T>{mr ? tk.w.r * (fcs.r * f) : 0.0f, mg ? tk.w.g * (fcs.g * f) : 0.0f,
                   mb ? tk.w.b * (fcs.b * f) : 0.0f};
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

    bool cont = idx != 0 && val(fcs.r) + val(fcs.g) + val(fcs.b) > 0.1f &&
                lev < p.max_reflections;
    if (!cont) return;
    // mirror bounce + entry/exit flag flip (render.rs:1199-1211)
    T en2 = -2.0f * dot(eye, n);
    V3T<T> new_eye = add(eye, v3(n.x * en2, n.y * en2, n.z * en2));
    flags = dot(val3(n), val3(new_eye)) < 0.0f ? ((flags & ~INONLY) | OUTONLY)
                                               : ((flags & ~OUTONLY) | INONLY);
    vi = pt;
    eye = new_eye;
    ig = idx;
  }
}

// The colour of pixel (ix, iy). ``cam`` is the packed camera row.
template <class T, class Rec>
RT_FI C3T<T> trace_pixel(const SceneViewT<T>& s, const Params& p, const float* cam, int ix,
                         int iy, Rec& rec) {
  TaskT<T> stack[STACK_CAP];
  if constexpr (is_dual_v<T>) {  // the camera's entries follow the objects'
    const auto c = T::row(cam, s.n * F32_COLS - s.seed);
    stack[0].vi = V3T<T>{c[0], c[1], c[2]};
    stack[0].eye = camera_ray(p.xres, p.yres, p.sx, p.sy, c, ix, iy);
  } else {  // the row itself: through a helper, ptxas gave K1 two more registers
    stack[0].vi = V3T<T>{cam[0], cam[1], cam[2]};
    stack[0].eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  }
  stack[0].w = C3T<T>{1.0f, 1.0f, 1.0f};
  stack[0].lev = 0;
  stack[0].ig = -1;
  stack[0].flags = 0;
  stack[0].parent = -1;
  int sp = 1;
  C3T<T> out = {0.0f, 0.0f, 0.0f};
  while (sp > 0) {
    TaskT<T> tk = stack[--sp];
    trace_task(s, p, tk, &out, stack, &sp, rec);
  }
  return out;
}

template <class T>
RT_FI C3T<T> trace_pixel(const SceneViewT<T>& s, const Params& p, const float* cam, int ix,
                         int iy) {
  NoRecord rec;
  return trace_pixel(s, p, cam, ix, iy, rec);
}

}  // namespace rt
