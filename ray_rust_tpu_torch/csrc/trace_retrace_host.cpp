// Host build of the re-trace gradient's per-pixel body
// (trace_retrace_body.cuh): a plain loop over the pixels on the CPU, so the
// kernel's forward-mode gradient can be tested against torch autograd of
// the plain PyTorch version and against the trace backward's host build
// where there is no card. Same arguments as rt_trace_retrace in
// trace_retrace.cu, minus the device and stream. Build with ``g++
// -std=c++17 -O2 -ffp-contract=off -shared -fPIC``, and with -DRT_COUNT_OPS
// to add the call's counts to ``ops_total`` (ops/kernel_trace_retrace.py:
// OPS_SLOTS): the f32 operations (the value pass's object tests as the
// forward counts them, and every Dual operation with its tangents), the
// texel bytes (none: K5 takes untextured scenes), the Dual passes, the most
// passes of one pixel, the sum over rows of 32 pixels (a warp of the
// kernel's 32-wide blocks) of their longest pixel's passes, then the pixels
// with w distinct winners for w = 0 .. 64. It returns 0, or 1 (the CUDA
// runtime's cudaErrorInvalidValue, named by rt_error_string below) for
// arguments no launch takes: a negative count or more than 64 objects (a
// pixel's winners are one 64-bit mask), an empty image, a null plane, more
// than 64 tasks (rt::stack_tasks). The counting build also exports
// rt_trace_retrace_tasks_host, which gives the most tasks a pixel's stack
// held.

#include "fixed_sum.cuh"
#include "trace_retrace_body.cuh"

namespace {

// Each term into the int64 block in the kernels' fixed point
// (fixed_sum.cuh: host_fixed_sum).
struct HostAcc : rt::FixedTerms {
  long long* block;
  int n;
  HostAcc(long long* b, const rt::FixedTerms& t, int rows) : rt::FixedTerms(t), block(b), n(rows) {}
  void add(int row, int col, float v) {
    put(block, row * rt::GRAD_COLS + col, take(row * rt::GRAD_COLS + col, v));
  }
  void add_scene(int e, float v) {
    put(block, n * rt::GRAD_COLS + e, take(n * rt::GRAD_COLS + e, v));
  }
};

#ifdef RT_COUNT_OPS
// slot 0 the operations, 1 the texel bytes (untextured: none)
constexpr int SLOT_PASSES = 2, SLOT_MOST = 3, SLOT_WARP = 4, SLOT_HIST = 5;
constexpr int WARP_X = 32;
#endif

// rt_trace_retrace_host; ``tasks`` (the counting build's, else null)
// receives the most tasks a pixel's stack held.
int retrace_host(const float* f32t, const int* i32t, const float* cam, const float* light, int n,
                 int xres, int yres, float sx, float sy, int max_reflections,
                 int refraction_cap, int bg, float cutoff, const float* g_r, const float* g_g,
                 const float* g_b, float* out_block, float* prim_r, float* prim_g,
                 float* prim_b, unsigned long long* ops_total, unsigned long long* tasks) {
  const int stack = rt::stack_tasks(max_reflections, refraction_cap);
  if (n < 0 || n > 64 || xres <= 0 || yres <= 0 || !g_r || !g_g || !g_b || !out_block ||
      stack > rt::STACK_CAP_DEEP)
    return 1;
  rt::SceneView s;
  s.f32 = f32t;
  s.i32 = i32t;
  s.n = n;
  s.light = rt::v3(light[0], light[1], light[2]);
#ifdef RT_COUNT_OPS
  s.ops = ops_total;
  s.tasks = tasks;
  rt::dual_op_count = 0;
#else
  (void)ops_total;
  (void)tasks;
#endif
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  const long long pixels = static_cast<long long>(xres) * yres;
#ifdef RT_COUNT_OPS
  std::vector<unsigned long long> again(SLOT_HIST + 65);  // a second run's counts
  int runs = 0;
#endif
  return rt::host_fixed_sum(
      out_block, (n + 1) * rt::GRAD_COLS, rt::planes_gbits(g_r, g_g, g_b, pixels),
      [&](long long* q, const rt::FixedTerms& t) {
        HostAcc acc(q, t, n);
#ifdef RT_COUNT_OPS
        unsigned long long* ops = runs++ == 0 ? ops_total : again.data();
        s.ops = ops;
        const unsigned long long dual_before = rt::dual_op_count;
#endif
        for (int iy = 0; iy < yres; ++iy) {
#ifdef RT_COUNT_OPS
          unsigned long long warp_most = 0;
#endif
          for (int ix = 0; ix < xres; ++ix) {
            const long o = static_cast<long>(iy) * xres + ix;
            unsigned long long mask;
            const rt::C3 g = rt::c3(g_r[o], g_g[o], g_b[o]);
            // the kernel's choice of the task stack (trace_retrace.cu)
            rt::C3 c = stack > rt::STACK_CAP
                           ? rt::retrace_pixel<rt::RETRACE_LANES, rt::STACK_CAP_DEEP>(
                                 s, p, cutoff, cam, ix, iy, g, acc, mask)
                           : rt::retrace_pixel<rt::RETRACE_LANES>(s, p, cutoff, cam, ix, iy, g,
                                                                  acc, mask);
            if (prim_r != nullptr) {
              prim_r[o] = c.r;
              prim_g[o] = c.g;
              prim_b[o] = c.b;
            }
#ifdef RT_COUNT_OPS
            const unsigned long long passes = rt::retrace_passes<rt::RETRACE_LANES>(mask);
            ops[SLOT_PASSES] += passes;
            if (passes > ops[SLOT_MOST]) ops[SLOT_MOST] = passes;
            if (passes > warp_most) warp_most = passes;
            if (ix % WARP_X == WARP_X - 1 || ix == xres - 1) {
              ops[SLOT_WARP] += warp_most;
              warp_most = 0;
            }
            ops[SLOT_HIST + rt::popcount64(mask)] += 1;
#endif
          }
        }
#ifdef RT_COUNT_OPS
        ops[0] += rt::dual_op_count - dual_before;
#endif
        return static_cast<rt::FixedTerms>(acc);
      });
}

}  // namespace

extern "C" {

int rt_trace_retrace_lanes() { return rt::RETRACE_LANES; }

const char* rt_error_string(int code) {
  return code == 0                     ? "no error"
         : code == 1                   ? "invalid argument"
         : code == rt::FIXED_OVERFLOW ? "the fixed-point cotangent sum would overflow int64"
                                       : "unknown error";
}

int rt_trace_retrace_host(const float* f32t, const int* i32t, const float* cam,
                           const float* light, int n, int xres, int yres, float sx, float sy,
                           int max_reflections, int refraction_cap, int bg, float cutoff,
                           const float* g_r, const float* g_g, const float* g_b,
                           float* out_block, float* prim_r, float* prim_g, float* prim_b,
                           unsigned long long* ops_total) {
  return retrace_host(f32t, i32t, cam, light, n, xres, yres, sx, sy, max_reflections,
                      refraction_cap, bg, cutoff, g_r, g_g, g_b, out_block, prim_r, prim_g,
                      prim_b, ops_total, nullptr);
}

#ifdef RT_COUNT_OPS
// rt_trace_retrace_host, and the most tasks any pixel's stack held (in its
// value pass or a Dual pass) into *tasks.
int rt_trace_retrace_tasks_host(const float* f32t, const int* i32t, const float* cam,
                                const float* light, int n, int xres, int yres, float sx,
                                float sy, int max_reflections, int refraction_cap, int bg,
                                float cutoff, const float* g_r, const float* g_g,
                                const float* g_b, float* out_block, float* prim_r,
                                float* prim_g, float* prim_b, unsigned long long* ops_total,
                                unsigned long long* tasks) {
  *tasks = 0;
  return retrace_host(f32t, i32t, cam, light, n, xres, yres, sx, sy, max_reflections,
                      refraction_cap, bg, cutoff, g_r, g_g, g_b, out_block, prim_r, prim_g,
                      prim_b, ops_total, tasks);
}
#endif

}  // extern "C"
