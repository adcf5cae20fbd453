// Re-trace gradient oracle (K5) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads (the
// body _make_bwd_kernel): from the packed scene tables of an untextured
// trace-mode scene and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image, by differentiating a re-trace of each
// pixel. It is the second, independent derivation of what the trace
// backward (K2, trace_bwd.cu) computes by replaying recorded sites, and the
// oracle K2 is held against at full size. The per-pixel program lives in
// trace_retrace_body.cuh: the forward's own trace body in forward-mode
// numbers (dual.cuh), RETRACE_LANES tangent lanes a launch; the wrapper
// (ops/kernel_trace_retrace.py) launches ceil(n_out / lanes) times for the
// n_out = 19 N + 10 entries, each launch adding its entries to one block.
//
// The JAX kernel's tile probe (_probe_case) and its three pre-differentiated
// program variants exist to skip a tile's dead work under a SIMD tile's
// shared control flow; a CUDA thread already stops at its own last bounce
// and its own last sub-trace, so they have no counterpart here.
//
// What bounds it: per-thread arithmetic. Each launch re-runs the forward's
// traversal with every value carrying L tangents (a product costs 1 + 3L
// operations), and its task stack of Dual rays sits in local memory; it
// reads the tables and three planes and adds at most L entries a block. The
// frame is the one the backwards share (bwd_kernel.cuh): tables in shared
// memory, a shared (n+1, 20) accumulator, one global atomic per nonzero
// entry a block. Built with --fmad=false, as the forward kernel, so the
// value part is the forward's image bit for bit.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace_retrace.py).

#include "bwd_kernel.cuh"
#include "trace_retrace_body.cuh"

namespace {

struct RetraceBody : rt::BwdFrame {
  static constexpr bool TEXTURED = false;
  template <class Acc>
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s,
                                               const rt::RetraceParams& p, float cutoff,
                                               const float* cam, int ix, int iy, rt::C3 g,
                                               Acc& acc) {
    return rt::retrace_pixel<rt::RETRACE_LANES>(s, p, cutoff, p.seed, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// Tangent lanes of one launch: the entries it adds.
int rt_trace_retrace_lanes() { return rt::RETRACE_LANES; }

// Launch the re-trace gradient for entries seed .. seed + lanes - 1 on
// ``stream`` of ``device`` (rt::launch_bwd); the render arguments and the
// cutoff as rt_trace_bwd's (trace_bwd.cu), without textures.
int rt_trace_retrace(const float* f32t, const int* i32t, const float* cam, const float* light,
                     int n, int xres, int yres, float sx, float sy, int max_reflections,
                     int refraction_cap, int bg, float cutoff, int seed, const float* g_r,
                     const float* g_g, const float* g_b, float* out_block, float* prim_r,
                     float* prim_g, float* prim_b, int device, void* stream) {
  rt::RetraceParams p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  p.seed = seed;
  const rt::TexArgs tx = {nullptr, nullptr, 0, 0, 0};
  return rt::launch_bwd<RetraceBody>(f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g, g_b,
                                     out_block, prim_r, prim_g, prim_b, device, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
