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
// with that weight and the parent runs on. A task at level L raycasts at
// levels L+1 .. L+max(1, R - L) (R = max_reflections) and pushes a sub-trace
// only at a level below the refraction cap C, and the stack pops its top
// first. So the stack's levels rise strictly from bottom to top, all below
// C: a popped task at level L replaces itself by children at levels above
// L. And at most one task on it lies at level R or deeper: a task there
// raycasts once, so it pushes at most one sub-trace, at its level + 1, after
// it left the stack. So the stack never holds more than stack_tasks(R, C)
// = max(1, min(R, C - 1)) tasks: 3 at the default refraction_unroll=4,
// whatever R. The instances run STACK_CAP tasks, or STACK_CAP_DEEP where a
// recorder with STACK selects it; the launchers pick the 16-task instance
// whenever stack_tasks is 16 or less and refuse past 64
// (ops/kernel_trace.py: stack_tasks); a push past the stack would turn the
// pixel to NaN rather than lose the sub-trace. The counting build keeps the
// most tasks a pixel's stack held in *SceneViewT::tasks.
//
// Vectors, the sky, uv maps, patterns and the normal are shared with the
// march-mode body (march_body.cuh). The traversal takes a recorder: the
// forward kernel's (NoRecord) does nothing, the backward kernel's
// (trace_bwd_body.cuh) saves the state of every raycast site, so both run
// one traversal.
//
// Image textures (K1a, replacing ray_rust_tpu/ops/pallas_trace.py:
// fetch_taps, fetch_texture and _tex_blend): a textured hit reads its texel's
// 2x2 wrap neighbourhood from the atlas that ops/kernel_pack.py:pack_textures
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
// derivatives, K5: dual.cuh, trace_retrace_body.cuh). With T = float it is
// the forward's code. With T = Dual<L> every value is the float trace's own,
// operation for operation, and the tangents are the derivatives by L of the
// pixel's local entries: the camera's 7, the light's 3, then the 19 columns
// of each object in SceneViewT::mask (the winners of the pixel's float
// trace), compacted in index order (object_entry). The body reads seeded
// entries in three places only: the winner's row (table_row), the camera row
// and the light; every decision (winner, flags, lit, cont, pattern cell) is
// taken on the value, each nearest-hit scan runs on the values and
// recomputes only the winner's t in T, the shadow scan runs on the values
// alone, and a hit at t >= SceneViewT::cutoff keeps its point as a constant
// (the JAX kernel's grad_distance_cutoff, pallas_trace.py:984-988). A Dual
// trace that wins an object outside the mask turns the pixel's tangents to
// NaN rather than drop its entries. The texture fetch stays float-only.
// Every function is forced inline (RT_FI): the kernels are one function
// each, and chip_smoke.py fails when ptxas reports another.
//
// The per-tile object cull (K1b, replacing ray_rust_tpu/ops/pallas_trace.py:
// _build_candidates and _corner_dir): a 16x16 tile's camera rays all lie in
// the pyramid over its four corner pixels' rays, so a sphere that lies more
// than its radius outside one of the pyramid's side planes is hit by none of
// them, and by none of the shadow rays from their first hits along the
// light, when that plane also faces the light. cull_tile builds the planes,
// cull_object tests one object, and two bitmasks over the objects (one word
// a 32 objects, bit i%32 of word i/32) carry the tile's primary and shadow
// candidates; floors are always candidates. Only a recorder that says CULL
// (K1's, trace_fwd.cu and trace_host.cpp) takes them, and only for the root
// trace's first raycast and its shadow ray, as the JAX kernel does
// (pallas_trace.py:1026-1030); every later bounce and refraction sub-trace
// scans all objects. nearest_in scans a mask's set bits in increasing index
// order, so under the strictly-closer, first-index rule it returns the full
// scan's winner bit for bit whenever the mask holds every object the ray can
// hit. The test is made conservative in f32 (cull_object says why).
//
// A build with -DRT_COUNT_OPS counts the f32 arithmetic of the object loops
// (the fewest operations each object test can take) into SceneView::ops[0],
// and the texel bytes the traversal's texture fetches read into ops[1], for
// the kernels' roofline bound; the forward's (trace_host.cpp) also counts
// the rest of the body's f32 operations (shading, sky, camera ray) into
// ops[2], a diagnostic of how far K1 is from the card's issue rate; with the
// cull it counts the objects cull_object tested into ops[3], the primary
// candidates scanned and the scans into ops[4] and ops[5], and the shadow
// candidates scanned and the scans into ops[6] and ops[7] (the cull's own
// f32 operations go to ops[0]); the ordinary build compiles it away.
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
// The forward's counting build (trace_host.cpp) also counts the shading,
// sky and camera-ray operations into ops[2]; the backward's and the
// re-trace's, which keep their own slots there, do not.
#if defined(RT_COUNT_OPS) && defined(RT_COUNT_SHADING)
#define RT_COUNT_SHADE(s, k) ((s).ops[2] += static_cast<unsigned long long>(k))
#else
#define RT_COUNT_SHADE(s, k) ((void)0)
#endif
// The cull's slots (only a CULL recorder's traversal and the host build's
// list building reach them).
#ifdef RT_COUNT_OPS
#define RT_COUNT_SLOT(s, slot, k) ((s).ops[slot] += static_cast<unsigned long long>(k))
#else
#define RT_COUNT_SLOT(s, slot, k) ((void)0)
#endif
// The most tasks a pixel's stack held, where the counting build was given
// a place for it (SceneViewT::tasks).
#ifdef RT_COUNT_OPS
#define RT_COUNT_TASKS(s, k) \
  ((s).tasks != nullptr && static_cast<unsigned long long>(k) > *(s).tasks \
       ? (void)(*(s).tasks = static_cast<unsigned long long>(k)) : (void)0)
#else
#define RT_COUNT_TASKS(s, k) ((void)0)
#endif

namespace rt {

// Column layout of the packed scene tables (ops/kernel_pack.py:pack_scene,
// the same as ray_rust_tpu/ops/pallas_trace.py:_pack_scene).
constexpr int F32_COLS = 19;  // org xyz, normal xyz, diffuse rgb, specular rgb,
                              // pn, t, n, pattern_scale, pattern_angle_scale,
                              // radius, glow_dist
constexpr int I32_COLS = 4;   // kind, pattern, uvmap, texture id
constexpr int CAM_COLS = 8;   // position xyz, rotation xyzw, pad
constexpr int LIGHT_COLS = 4; // direction xyz, pad
constexpr int TEX_META_COLS = 4;  // width, height, base texel (unread: texel_index), filter

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
// The deeper task stack, a second instance of each trace kernel that takes
// it: refraction caps 18 to 65 past 16 reflections (stack_tasks).
constexpr int STACK_CAP_DEEP = 64;

// The most tasks a pixel's stack holds at once (see above): the launchers'
// choice of instance, ops/kernel_trace.py:stack_tasks's twin.
inline int stack_tasks(int max_reflections, int refraction_cap) {
  const int m = max_reflections < refraction_cap - 1 ? max_reflections : refraction_cap - 1;
  return m > 1 ? m : 1;
}
// K1b's tile: the forward kernel's block (trace_fwd.cu).
constexpr int CULL_TILE = 16;
// The table regime a kernel library is built for: each of K1-K4 builds a
// second library with -DRT_GLOBAL_TABLES (ops/_build.py: the "_global"
// names), whose kernels read the object tables where the pack kernel wrote
// them instead of staging them in shared memory (the backwards also add
// their cotangents straight to the output block, bwd_kernel.cuh). The
// wrappers launch it for scenes whose tables do not fit the launch shape's
// share of an SM's shared memory. It holds the same instances as the first
// (cull, task stack, record cap), so the two differ only where the tables
// are read. A second library rather than a template argument: each compiles
// in an nvcc of its own, beside the other; the march backward's two
// instances already set the build's time (176 s of 185 on the H100's host
// for the shared build, 185 for the global one, PERF.md §6), and its four
// in one nvcc would take about twice that.
#ifdef RT_GLOBAL_TABLES
constexpr bool GLOBAL_TABLES = true;
#else
constexpr bool GLOBAL_TABLES = false;
#endif
// The most textures whose meta rows a launch stages in shared memory beside
// the tables (ops/kernel_trace.py: TEXTURE_MAX). The wrappers launch a
// larger bank in the global-table build, which reads the rows where the
// pack kernel wrote them (TexArgs::meta) instead: 16 bytes a texture,
// looked up once a textured hit.
constexpr int TEXTURE_MAX = 1024;

// The meta rows a launch of this build stages for a bank of n_tex textures.
RT_FI int staged_meta(int n_tex) { return GLOBAL_TABLES && n_tex > TEXTURE_MAX ? 0 : n_tex; }
// K1b's f32 margins (cull_object): relative to the sphere's distance from
// the camera, to the camera's distance from the origin, and the least n.L
// of a plane that culls shadow rays.
constexpr float CULL_REL = 2e-3f;
constexpr float CULL_ABS = 1e-5f;
constexpr float CULL_SHADOW_MIN = 2e-3f;

// Fewest f32 operations (add, sub, mul, div, sqrt) of one object test in a
// raycast: a sphere whose discriminant is negative, a floor facing away.
constexpr int OPS_SPHERE_TEST = 19;
constexpr int OPS_FLOOR_TEST = 8;
// The f32 operations the rest of the body writes, for the diagnostic count
// (RT_COUNT_SHADE): each add, sub, mul, div, sqrt, min, max, abs, floor,
// trunc, fmod and pow once, though the last few take many instructions.
constexpr int OPS_CAMERA_RAY = 70;   // ey, ez, two quaternion products, normalize
constexpr int OPS_HIT = 53;          // hit point, Lambert + Phong, shadow origin,
                                     // face colour, accumulation, exit test
constexpr int OPS_SPHERE_NORMAL = 12;
constexpr int OPS_POW = 1;
constexpr int OPS_UV_PLANAR = 5;
constexpr int OPS_UV_LATLONG = 45;   // two Cephes atan2 and a sqrt
constexpr int OPS_GRADATION = 10;
constexpr int OPS_CHECKER = 2;
constexpr int OPS_TEX_NEAREST = 7;
constexpr int OPS_TEX_BILINEAR = 50;
constexpr int OPS_REFRACT = 40;      // bend, normalize, the sub-trace's start and weight
constexpr int OPS_BOUNCE = 17;       // mirror direction and the flag test
constexpr int OPS_MISS = 9;          // the background's share of the pixel
constexpr int OPS_SKY = 70;          // Cephes atan2 and asin, two fmodf, glare
constexpr int OPS_CULL_TILE = 304;   // four corner coordinates, four plane normals
                                     // rotated (two quaternion products each),
                                     // normalized and dotted with the light
constexpr int OPS_CULL_SPHERE = 36;  // offset, margin, four plane tests

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
// pack_textures): n_tex textures of ``texels`` texels each (Hmax * Wmax),
// ``stride`` (the widest texture's width, Wmax) a row, and a (n_tex,
// TEX_META_COLS) meta table. All zero when the scene has no texture. The
// atlas may hold 2^31 texels or more: its offsets are 64-bit (texel_index).
struct TexArgs {
  const Texel4* tex;
  const int* meta;
  int n_tex, stride, texels;
};

// A Dual trace's local entries (K5): the camera's 7 (position xyz,
// rotation xyzw) from 0, the light's 3 from LIGHT_ENTRY, then F32_COLS for
// each object of the pixel's winner mask, in index order.
constexpr int LIGHT_ENTRY = 7;
constexpr int SCENE_ENTRIES = 10;

RT_FI int popcount64(unsigned long long x) {
#ifdef __CUDA_ARCH__
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// The local entry of column 0 of object i (a bit of ``mask``, i < 64).
RT_FI int object_entry(unsigned long long mask, int i) {
  return SCENE_ENTRIES + F32_COLS * popcount64(mask & ((1ull << i) - 1ull));
}

// The packed scene as the body reads it: per-object rows, the light and the
// texture atlas (none by default: the march bodies read no texture). A
// Dual<L> trace also carries the local entry its tangent lane 0 is seeded
// at, the objects whose rows it seeds (bit i for object i: N <= 64) and the
// gradient's distance cutoff.
template <class T>
struct SceneViewT {
  const float* f32;  // (n, F32_COLS)
  const int* i32;    // (n, I32_COLS)
  int n;
  V3T<T> light;
  TexArgs tx = {nullptr, nullptr, 0, 0, 0};
  int seed = 0;
  unsigned long long mask = 0;
  float cutoff = INFINITY;
#ifdef RT_COUNT_OPS
  unsigned long long* ops;  // this thread's counts: f32 operations, texel bytes
  unsigned long long* tasks = nullptr;  // the most tasks a stack held, where given
#endif
};
using SceneView = SceneViewT<float>;

// Object i's f32 row as a T trace reads it: the row itself for float, its
// entries seeded at their local entries for Dual<L>.
template <class T>
RT_FI auto table_row(const SceneViewT<T>& s, int i) {
  if constexpr (is_dual_v<T>) {
    return T::row(s.f32 + i * F32_COLS, object_entry(s.mask, i) - s.seed);
  } else {
    return s.f32 + i * F32_COLS;
  }
}

// Render parameters: image size, the window a launch renders, 2*fov in
// f32, depth caps, background id. The camera rays take the frame's global
// pixel (ix, iy) and its size xres, yres; K1 and the backward kernels K2
// and K4 (bwd_kernel.cuh) cover rows row0 .. row0+h-1 and columns col0 ..
// col0+w-1 of the frame with h x w planes. K5 takes the whole frame.
struct Params {
  int xres, yres;
  int row0 = 0, col0 = 0, h = 0, w = 0;
  float sx, sy;
  int max_reflections;
  int refraction_cap;  // min(max_refractions, refraction_unroll)
  int bg;
};

// Whether the window of ``p`` (Params or MarchParams) holds a pixel and lies
// in its xres x yres frame; the backward launchers and their host builds
// return cudaErrorInvalidValue (1) for any other, never an empty grid.
template <class P>
inline bool window_ok(const P& p) {
  return p.h > 0 && p.w > 0 && p.row0 >= 0 && p.col0 >= 0 && p.row0 + p.h <= p.yres &&
         p.col0 + p.w <= p.xres;
}

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

RT_FI int lowest_bit(unsigned w) {
#ifdef __CUDA_ARCH__
  return __ffs(w) - 1;
#else
  return __builtin_ctz(w);
#endif
}

// nearest_t over the objects of candidate mask ``cand`` (bit i%32 of word
// i/32 for object i), in increasing index order: the full scan's winner
// whenever ``cand`` holds every object the ray can hit. Counts the
// candidates it tests into ops[slot] and the scan into ops[slot + 1].
RT_FI float nearest_in(const SceneView& s, const unsigned* cand, int slot, V3 vi, V3 eye, int ig,
                       int flags, int* idx) {
  float t = INFINITY;
  *idx = 0;
  RT_COUNT_SLOT(s, slot + 1, 1);
  const int words = (s.n + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    unsigned bits = cand[w];
    while (bits) {
      const int i = (w << 5) + lowest_bit(bits);
      bits &= bits - 1u;
      if (i == ig) continue;
      const int kind = s.i32[i * I32_COLS];
      RT_COUNT(s, kind == KIND_SPHERE ? OPS_SPHERE_TEST : OPS_FLOOR_TEST);
      RT_COUNT_SLOT(s, slot, 1);
      float c = candidate_t(s.f32 + i * F32_COLS, kind, vi, eye, t, flags);
      if (c < t) {
        t = c;
        *idx = i;
      }
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
// (tid * Hmax + iy) * Wmax + ix, the atlas being texture-major, is 64-bit
// (an atlas of 2^31 texels or more: the meta rows' int32 base texel column
// is not read) and clamped to the atlas (in range for every finite uv) as
// the plain version and the JAX kernel (pallas_trace.py:674) clamp it. Sets
// *bilin.
RT_FI long long texel_index(const TexArgs& tx, int tid, float u, float v, bool* bilin,
                            float* fu, float* fv) {
  const int t = tid < tx.n_tex ? tid : tx.n_tex - 1;
  const int* m = tx.meta + TEX_META_COLS * t;
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
  const long long len = static_cast<long long>(tx.texels) * tx.n_tex;
  long long flat = static_cast<long long>(t) * tx.texels +
                   static_cast<long long>(iy) * tx.stride + ix;
  return flat < 0 ? 0 : (flat >= len ? len - 1 : flat);
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

// A recorder's traits: the capacity of the task stack it runs with
// (STACK_CAP unless it says STACK) and whether it carries K1b's candidate
// masks (CULL). Only K1's recorder says either.
template <class Rec, class = void>
struct RecStack : std::integral_constant<int, STACK_CAP> {};
template <class Rec>
struct RecStack<Rec, std::void_t<decltype(Rec::STACK)>>
    : std::integral_constant<int, Rec::STACK> {};
template <class Rec, class = void>
struct RecCull : std::false_type {};
template <class Rec>
struct RecCull<Rec, std::void_t<decltype(Rec::CULL)>> : std::bool_constant<Rec::CULL> {};

// K1's recorder: records nothing, runs a stack of STACK_ tasks and, with
// CULL_, scans the root trace's first raycast over ``prim`` and its shadow
// ray over ``shadow`` (the tile's K1b masks).
template <bool CULL_, int STACK_>
struct FwdRecord : NoRecord {
  static constexpr bool CULL = CULL_;
  static constexpr int STACK = STACK_;
  const unsigned* prim = nullptr;
  const unsigned* shadow = nullptr;
};

// The side planes of the pyramid over a tile's camera rays (K1b): unit
// normals facing inward, whether each also bounds the tile's primary
// shadow rays, and the camera.
struct CullTile {
  V3 n[4];
  bool shadow[4];
  V3 cam;
  float cam_abs;  // |cam.x| + |cam.y| + |cam.z|
};

// The camera-space ray coordinates of pixel column ix and row iy, as
// camera_ray computes them: monotone in the pixel, so every pixel of a tile
// lies between its corners'.
RT_FI float pixel_ey(int ix, int xres, float sx) {
  return (float)(ix - xres / 2) * sx / (float)xres;
}
RT_FI float pixel_ez(int iy, int yres, float sy) {
  return -(float)(iy - yres / 2) * sy / (float)yres;
}

// v rotated by quaternion q as camera_ray rotates: q * (v, 0) * conj(q).
RT_FI V3 rotate(Q4 q, V3 v) {
  const Q4 qc = {-q.x, -q.y, -q.z, q.w};
  const Q4 e = {v.x, v.y, v.z, 0.0f};
  const Q4 r = qmul(qmul(q, e), qc);
  return v3(r.x, r.y, r.z);
}

// The pyramid of the tile whose corner pixels are (col0, row0) and (col0 +
// cols - 1, row0 + rows - 1), global pixels of the frame (ragged tiles, at
// the edge of the frame or of K1's window, keep the whole tile's corners,
// which only widens it). In camera space a pixel's ray is (1, ey, ez) with
// ey in [ylo, yhi] and ez in [zlo, zhi], so the planes are y = ylo x, y =
// yhi x, z = zlo x and z = zhi x with the exact normals (-ylo, 1, 0), (yhi,
// -1, 0), (-zlo, 0, 1), (zhi, 0, -1); rotated into the world as the rays
// are, and normalized. (The JAX kernel crosses the rotated corner rays,
// whose f32 rounding tilts a normal by ~1e-4 across a 16-pixel tile.)
RT_FI CullTile cull_tile(const Params& p, const float* cam, V3 light, int col0, int row0, int cols,
                         int rows) {
  const float ya = pixel_ey(col0, p.xres, p.sx), yb = pixel_ey(col0 + cols - 1, p.xres, p.sx);
  const float za = pixel_ez(row0, p.yres, p.sy), zb = pixel_ez(row0 + rows - 1, p.yres, p.sy);
  const float ylo = fminf(ya, yb), yhi = fmaxf(ya, yb);
  const float zlo = fminf(za, zb), zhi = fmaxf(za, zb);
  const Q4 q = {cam[3], cam[4], cam[5], cam[6]};
  const V3 nc[4] = {v3(-ylo, 1.0f, 0.0f), v3(yhi, -1.0f, 0.0f), v3(-zlo, 0.0f, 1.0f),
                    v3(zhi, 0.0f, -1.0f)};
  CullTile ct;
  for (int k = 0; k < 4; ++k) {
    ct.n[k] = normalized(rotate(q, nc[k]));
    ct.shadow[k] = dot(ct.n[k], light) >= CULL_SHADOW_MIN;
  }
  ct.cam = v3(cam[0], cam[1], cam[2]);
  ct.cam_abs = fabsf(cam[0]) + fabsf(cam[1]) + fabsf(cam[2]);
  return ct;
}

// Whether object row ``o`` of kind ``kind`` is a primary (*prim) and a
// shadow (*shadow) candidate of tile ``ct``. A sphere at d = org - cam of
// radius r is culled by plane k when n_k.d < -(r + m).
//
// Why the margin m = CULL_REL (|d|_1 + r) + CULL_ABS |cam|_1 keeps the cull
// exact in f32: candidate_t finds a hit where the rounded discriminant
// b*b - 4c is >= F32_EPS, and its rounding (~56 ulp of |w|^2, w = ray start
// - org, for a unit ray) lets a line pass up to sqrt(8.4e-7)|w| = 9.2e-4|w|
// outside the sphere and still hit it. A pixel's rounded ray leaves the
// exact pyramid by ~2e-6 of its length, a normal is off by ~1e-6. For a
// camera ray w = -d, so 2e-3 |d|_1 covers all of it with a factor of two.
// A shadow ray starts at a first hit pt, rounded to ~1e-7 |pt| (the
// CULL_ABS term covers the camera's share), and runs along L; only planes
// with n.L >= CULL_SHADOW_MIN cull it, so n.(pt + sL - cam) grows by at
// least 2e-3 s, which outruns the 9.2e-4 s that a blocker s along the ray
// gains in reach and the ~2e-6 s of pt's own distance from the pyramid.
RT_FI void cull_object(const CullTile& ct, const float* o, int kind, bool* prim, bool* shadow) {
  if (kind != KIND_SPHERE) {
    *prim = *shadow = true;
    return;
  }
  const float dx = o[0] - ct.cam.x, dy = o[1] - ct.cam.y, dz = o[2] - ct.cam.z;
  const float r = fabsf(o[17]);
  const float m = r + CULL_REL * (fabsf(dx) + fabsf(dy) + fabsf(dz) + r) + CULL_ABS * ct.cam_abs;
  bool out_p = false, out_s = false;
  for (int k = 0; k < 4; ++k) {
    const bool out = ct.n[k].x * dx + ct.n[k].y * dy + ct.n[k].z * dz < -m;
    out_p = out_p || out;
    out_s = out_s || (out && ct.shadow[k]);
  }
  *prim = !out_p;
  *shadow = !out_s;
}

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
    T t;
    if constexpr (RecCull<Rec>::value) {  // K1b: the root trace's first raycast
      t = tk.lev == 0 && step == 0 ? nearest_in(s, rec.prim, 4, vi, eye, ig, flags, &idx)
                                   : raycast(s, vi, eye, ig, flags, &idx);
    } else {
      t = raycast(s, vi, eye, ig, flags, &idx);
    }
    if (!is_finite(t)) {
      rec.site(vi, eye, fcs, flags, idx, false, false);
      // a miss picks up the background once, unguarded (render.rs:1212-1217)
      RT_COUNT_SHADE(s, OPS_MISS + (p.bg == BG_BLACK ? 0 : OPS_SKY));
      C3T<T> bg = background(p.bg, s.light, eye);
      out->r += tk.w.r * (bg.r * fcs.r);
      out->g += tk.w.g * (bg.g * fcs.g);
      out->b += tk.w.b * (bg.b * fcs.b);
      return;
    }
    const auto o = table_row(s, idx);
    if constexpr (is_dual_v<T>) {  // a winner outside the mask: poison, never drop
      if (!((s.mask >> idx) & 1ull)) out->r = out->g = out->b = T::poison();
    }
    const int* oi = s.i32 + idx * I32_COLS;
    V3T<T> pt = add(vi, scale(eye, t));
    if constexpr (is_dual_v<T>) {  // a hit past the cutoff is a constant point
      if (!(val(t) < s.cutoff)) pt = stop3(pt);
    }
    V3T<T> org = {o[0], o[1], o[2]};
    V3T<T> n = surface_normal(o, oi[0], pt);
    RT_COUNT_SHADE(s, OPS_HIT + (oi[0] == KIND_SPHERE ? OPS_SPHERE_NORMAL : 0));

    // Lambert + Phong (render.rs:1024-1046)
    T li = dot(s.light, n);
    T ln2 = 2.0f * li;
    V3T<T> rtl = sub(v3(n.x * ln2, n.y * ln2, n.z * ln2), s.light);
    T di = fmaxf(li, 0.0f);
    T pn = o[12];
    T ri = -dot(rtl, eye);
    T refl = (pn != 0.0f && ri > 0.0f) ? powf(ri, pn) : 0.0f;
    RT_COUNT_SHADE(s, (pn != 0.0f && ri > 0.0f) ? OPS_POW : 0);

    // shadow ray, on the values: lit when it escapes or its blocker is
    // transparent
    int i_s;
    float t_s;
    if constexpr (RecCull<Rec>::value) {  // K1b: the root's first shadow ray
      const V3 so = add(pt, scale(s.light, F32_EPS));
      t_s = tk.lev == 0 && step == 0 ? nearest_in(s, rec.shadow, 6, so, s.light, idx, 0, &i_s)
                                     : nearest_t(s, so, s.light, idx, 0, &i_s);
    } else {
      t_s = nearest_t(s, add(val3(pt), scale(val3(s.light), F32_EPS)), val3(s.light), idx, 0,
                      &i_s);
    }
    bool lit = !is_finite(t_s) || s.f32[i_s * F32_COLS + 13] > 0.0f;
    const int site = rec.site(vi, eye, fcs, flags, idx, true, lit);
    T k1 = lit ? fminf(0.2f + di, 1.0f) : 0.2f;
    T k2 = lit ? refl : 0.0f;

    T u, v;
    get_uv(sub(pt, org), oi[2], o[15], o[16], &u, &v);
    RT_COUNT_SHADE(s, oi[2] == UVMAP_LL ? OPS_UV_LATLONG : OPS_UV_PLANAR);
    C3T<T> kd;
    if constexpr (is_dual_v<T>) {  // the re-trace takes untextured scenes
      kd = pattern_diffuse(o, oi[1], u, v);
    } else if (textured(s, oi)) {  // the image replaces the pattern (render.rs:249-316)
      RT_COUNT_TEXEL(s);
      RT_COUNT_SHADE(s, s.tx.meta[TEX_META_COLS * (oi[3] < s.tx.n_tex ? oi[3] : s.tx.n_tex - 1)
                                  + 3] == FILTER_BILINEAR ? OPS_TEX_BILINEAR : OPS_TEX_NEAREST);
      kd = fetch_texture(s.tx, oi[3], u, v);
    } else {
      RT_COUNT_SHADE(s, oi[1] == PATTERN_GRADATION ? OPS_GRADATION
                        : (oi[1] == PATTERN_CHECKERBOARD ? OPS_CHECKER : 0));
      kd = pattern_diffuse(o, oi[1], u, v);
    }
    C3T<T> face = c3(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2);

    bool mr = !(flags & RIGNORE), mg = !(flags & GIGNORE), mb = !(flags & BIGNORE);
    T f = o[13];
    if (lev < p.refraction_cap && f > 0.0f) {
      RT_COUNT_SHADE(s, OPS_REFRACT);
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
      if (*sp < RecStack<Rec>::value) {
        stack[(*sp)++] = c;
        RT_COUNT_TASKS(s, *sp);
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
    RT_COUNT_SHADE(s, OPS_BOUNCE);
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
  TaskT<T> stack[RecStack<Rec>::value];
  if constexpr (is_dual_v<T>) {  // the camera's entries are local 0-6
    const auto c = T::row(cam, -s.seed);
    stack[0].vi = V3T<T>{c[0], c[1], c[2]};
    stack[0].eye = camera_ray(p.xres, p.yres, p.sx, p.sy, c, ix, iy);
  } else {  // the row itself: through a helper, ptxas gave K1 two more registers
    stack[0].vi = V3T<T>{cam[0], cam[1], cam[2]};
    stack[0].eye = camera_ray(p.xres, p.yres, p.sx, p.sy, cam, ix, iy);
  }
  RT_COUNT_SHADE(s, OPS_CAMERA_RAY);
  stack[0].w = C3T<T>{1.0f, 1.0f, 1.0f};
  stack[0].lev = 0;
  stack[0].ig = -1;
  stack[0].flags = 0;
  stack[0].parent = -1;
  int sp = 1;
  RT_COUNT_TASKS(s, sp);
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
