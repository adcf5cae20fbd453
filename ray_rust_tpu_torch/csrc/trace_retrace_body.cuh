// Per-pixel body of the re-trace gradient (K5), shared by the CUDA kernel
// (trace_retrace.cu) and a host build (trace_retrace_host.cpp) that the CPU
// tests hold against torch autograd of the plain PyTorch version and
// against the trace backward's host build.
//
// It computes what ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads
// computes for one pixel, for one launch's L entries of the scene tables:
// the forward trace itself (trace_body.cuh:trace_pixel) run in Dual<L>
// (dual.cuh), with tangent lane k seeded at the launch's entry seed + k of
// the cotangent block's live entries (object rows of F32_COLS, then the
// camera's position and rotation and the light's direction, the layout of
// ops/kernel_trace_bwd.py:GRAD_COLS). The pixel adds
// sum_c g_c * d img_c / d entry for each of its L entries. The JAX kernel
// gets the same numbers from jax.vjp over a re-trace of its tile; forward
// mode needs no record of the trace and no reverse sweep, and the pixel's
// colour is the value part, the forward kernel's image bit for bit.
#pragma once

#include "trace_bwd_body.cuh"

namespace rt {

// Tangent lanes a launch carries (ops/kernel_trace_retrace.py reads it
// from the library). Two keep the kernel within 128 registers, two
// 256-thread blocks an SM, without spills (PERF.md, the lane count).
constexpr int RETRACE_LANES = 2;
// Live entries of the block's last row: camera xyz, rotation xyzw, light xyz.
constexpr int SCENE_ENTRIES = 10;

// The render parameters and the launch's first seeded entry.
struct RetraceParams : Params {
  int seed;
};

// The pixel's cotangent g pulled back to entries seed .. seed + L - 1 of the
// tables through ``acc`` (rows 0..n-1: the objects' 19 columns; row n:
// camera, light); hits at t >= cutoff pass nothing through their point.
// Returns the pixel's colour (trace_pixel's).
template <int L, class Acc>
RT_FI C3 retrace_pixel(const SceneView& s, const Params& p, float cutoff, int seed,
                       const float* cam, int ix, int iy, C3 g, Acc& acc) {
  using D = Dual<L>;
  SceneViewT<D> sd;
  sd.f32 = s.f32;
  sd.i32 = s.i32;
  sd.n = s.n;
  const int kl = s.n * F32_COLS + 7 - seed;  // the light's lanes follow the camera's 7
  sd.light = v3(D::seeded(s.light.x, kl), D::seeded(s.light.y, kl + 1),
                D::seeded(s.light.z, kl + 2));
  sd.seed = seed;
  sd.cutoff = cutoff;
#ifdef RT_COUNT_OPS
  sd.ops = s.ops;
#endif
  const C3T<D> c = trace_pixel(sd, p, cam, ix, iy);
  const int n_obj = s.n * F32_COLS;
  for (int k = 0; k < L; ++k) {
    const int e = seed + k;
    if (e >= n_obj + SCENE_ENTRIES) break;
    const float v = g.r * c.r.d[k] + g.g * c.g.d[k] + g.b * c.b.d[k];
    if (v != 0.0f) {
      if (e < n_obj) acc.add(e / F32_COLS, e % F32_COLS, v);
      else acc.add(s.n, e - n_obj, v);
    }
  }
  return c3(c.r.v, c.g.v, c.b.v);
}

}  // namespace rt
