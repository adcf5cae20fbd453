// Host build of the re-trace gradient's per-pixel body
// (trace_retrace_body.cuh): a plain loop over the pixels on the CPU, so the
// kernel's forward-mode gradient can be tested against torch autograd of
// the plain PyTorch version and against the trace backward's host build
// where there is no card. Same arguments as rt_trace_retrace in
// trace_retrace.cu, minus the device and stream. Build with ``g++
// -std=c++17 -O2 -ffp-contract=off -shared -fPIC`` (and -DRT_COUNT_OPS to
// add the f32 operations of the call to ops_total[0]: the value scans'
// object tests as the forward counts them, and every Dual operation with
// its tangents).

#include "trace_retrace_body.cuh"

namespace {

struct HostAcc {
  float* block;
  void add(int row, int col, float v) { block[row * rt::GRAD_COLS + col] += v; }
};

}  // namespace

extern "C" {

int rt_trace_retrace_lanes() { return rt::RETRACE_LANES; }

void rt_trace_retrace_host(const float* f32t, const int* i32t, const float* cam,
                           const float* light, int n, int xres, int yres, float sx, float sy,
                           int max_reflections, int refraction_cap, int bg, float cutoff,
                           int seed, const float* g_r, const float* g_g, const float* g_b,
                           float* out_block, float* prim_r, float* prim_g, float* prim_b,
                           unsigned long long* ops_total) {
  rt::SceneView s;
  s.f32 = f32t;
  s.i32 = i32t;
  s.n = n;
  s.light = rt::v3(light[0], light[1], light[2]);
#ifdef RT_COUNT_OPS
  s.ops = ops_total;
  rt::dual_op_count = 0;
#else
  (void)ops_total;
#endif
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  HostAcc acc = {out_block};
  for (int iy = 0; iy < yres; ++iy) {
    for (int ix = 0; ix < xres; ++ix) {
      const long o = static_cast<long>(iy) * xres + ix;
      rt::C3 c = rt::retrace_pixel<rt::RETRACE_LANES>(s, p, cutoff, seed, cam, ix, iy,
                                                      rt::c3(g_r[o], g_g[o], g_b[o]), acc);
      if (prim_r != nullptr) {
        prim_r[o] = c.r;
        prim_g[o] = c.g;
        prim_b[o] = c.b;
      }
    }
  }
#ifdef RT_COUNT_OPS
  ops_total[0] += rt::dual_op_count;
#endif
}

}  // extern "C"
