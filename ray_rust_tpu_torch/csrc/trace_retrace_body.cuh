// Per-pixel body of the re-trace gradient (K5), shared by the CUDA kernel
// (trace_retrace.cu) and a host build (trace_retrace_host.cpp) that the CPU
// tests hold against torch autograd of the plain PyTorch version and
// against the trace backward's host build.
//
// It computes what ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads
// computes for one pixel: the pixel's cotangent g pulled back to every entry
// of the scene tables, sum_c g_c * d img_c / d entry. The JAX kernel gets it
// from jax.vjp over a re-trace of its tile; here forward mode runs the
// forward's own trace body (trace_body.cuh:trace_pixel) in Dual<L> numbers
// (dual.cuh), which needs no record of the trace and no reverse sweep, so
// the oracle stays a derivation independent of the trace backward's (K2).
//
// A pixel's trace reads seeded entries only at its winners' rows, the camera
// row and the light, so most of the N * 19 + 10 entries have no derivative
// in it. The pixel therefore traces twice over:
//
// 1. a value pass, the forward's float trace (the image, bit for bit), whose
//    recorder (WinnerMask) sets bit i of a 64-bit mask for each hit on
//    object i (N <= 64, the JAX kernel's cap);
// 2. passes of the Dual<L> trace over the pixel's local entries only
//    (trace_body.cuh:object_entry: camera 0-6, light 7-9, then 19 a winner):
//    pass k seeds lanes 0..L-1 at local entries k*L .. k*L + L-1, and adds
//    each entry's cotangent to its place in the (n+1, 20) block.
//
// So a pixel with w winners takes ceil((10 + 19 w) / L) Dual passes, not
// ceil((19 N + 10) / L). The camera's and the light's entries go to the
// accumulator's add_scene, the objects' to add.
#pragma once

#include "trace_bwd_body.cuh"

namespace rt {

// Tangent lanes a Dual pass carries (ops/kernel_trace_retrace.py reads it
// from the library). Under compaction the tangent work follows the live
// entries whatever L is, and a larger L saves only value passes: in a sweep
// on an H100 of 1, 2 and 4 lanes at 1, 2 and 3 blocks an SM (PERF.md §6),
// two lanes at two blocks were the fastest.
constexpr int RETRACE_LANES = 2;

// The value pass's recorder: bit i for each hit site won by object i; its
// traversal's task stack holds STACK_ tasks.
template <int STACK_ = STACK_CAP>
struct WinnerMask {
  static constexpr int STACK = STACK_;
  unsigned long long bits = 0;
  template <class Tk>
  RT_FI void task(const Tk&) {}
  template <class V, class C>
  RT_FI int site(V, V, C, int, int idx, bool hit, bool) {
    if (hit) bits |= 1ull << idx;
    return -1;
  }
};

// The Dual passes' recorder: records nothing; its traversal's task stack
// holds STACK_ tasks.
template <int STACK_>
struct DualStack : NoRecord {
  static constexpr int STACK = STACK_;
};

// Dual passes of L lanes over the local entries of a pixel with winners ``mask``.
template <int L>
RT_FI int retrace_passes(unsigned long long mask) {
  return (SCENE_ENTRIES + F32_COLS * popcount64(mask) + L - 1) / L;
}

// The index of the j-th set bit of ``mask`` (j < popcount64(mask)).
RT_FI int nth_bit(unsigned long long mask, int j) {
  for (; j > 0; --j) mask &= mask - 1ull;
#ifdef __CUDA_ARCH__
  return __ffsll(static_cast<long long>(mask)) - 1;
#else
  return __builtin_ctzll(mask);
#endif
}

// The pixel's cotangent g pulled back to the tables through ``acc``:
// ``add_scene(e, v)`` for local entry e < SCENE_ENTRIES (row n's column e:
// each e once a pixel), ``add(i, c, v)`` for object i's column c (rows
// 0..n-1), zeros too, so that the lanes of a pass call it together; hits at
// t >= cutoff pass nothing through their point. Sets ``mask`` to the
// pixel's winners and returns its colour (trace_pixel's). Both traversals'
// task stacks hold STACK tasks.
template <int L, int STACK = STACK_CAP, class Acc>
RT_FI C3 retrace_pixel(const SceneView& s, const Params& p, float cutoff, const float* cam,
                       int ix, int iy, C3 g, Acc& acc, unsigned long long& mask) {
  WinnerMask<STACK> winners;
  const C3 colour = trace_pixel(s, p, cam, ix, iy, winners);
  mask = winners.bits;

  using D = Dual<L>;
  SceneViewT<D> sd;
  sd.f32 = s.f32;
  sd.i32 = s.i32;
  sd.n = s.n;
  sd.mask = mask;
  sd.cutoff = cutoff;
#ifdef RT_COUNT_OPS
  sd.ops = s.ops;
  sd.tasks = s.tasks;
#endif
  const int live = SCENE_ENTRIES + F32_COLS * popcount64(mask);
  for (int seed = 0; seed < live; seed += L) {
    sd.seed = seed;
    sd.light = v3(D::seeded(s.light.x, LIGHT_ENTRY - seed),
                  D::seeded(s.light.y, LIGHT_ENTRY + 1 - seed),
                  D::seeded(s.light.z, LIGHT_ENTRY + 2 - seed));
    DualStack<STACK> none;
    const C3T<D> c = trace_pixel(sd, p, cam, ix, iy, none);
    for (int k = 0; k < L; ++k) {
      const int e = seed + k;
      if (e >= live) break;
      const float v = g.r * c.r.d[k] + g.g * c.g.d[k] + g.b * c.b.d[k];
      if (e < SCENE_ENTRIES) {
        acc.add_scene(e, v);
      } else {
        const int o = e - SCENE_ENTRIES;
        acc.add(nth_bit(mask, o / F32_COLS), o % F32_COLS, v);
      }
    }
  }
  return colour;
}

}  // namespace rt
