// Trace-mode backward (K2) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_grads_site
// (the body _make_site_bwd_kernel) for untextured scenes: from the packed
// scene tables and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image itself. The per-pixel program lives in
// trace_bwd_body.cuh.
//
// What bounds it: per-thread arithmetic and local memory, not bytes. It
// reads the tables and three f32 planes and writes an (n+1, 20) block and
// at most three planes, while each pixel re-runs the forward's raycasts
// (O(objects) each) and then walks up to SITE_CAP saved sites backwards.
// The design is simple and right, not fast: the frame shared with the march
// backward (bwd_kernel.cuh) stages the tables in shared memory as the
// forward kernel does and sums each block's cotangents in a shared (n+1, 20)
// block before one global atomicAdd per nonzero entry, so a 1080p frame
// takes ~8k global atomics per entry rather than one per pixel, site and
// field, in an order that changes from run to run. A warp-level reduction
// before the shared atomics, and the JAX kernel's pruned replay variants,
// are later work. Built with --fmad=false, as the forward kernel.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace_bwd.py).

#include "bwd_kernel.cuh"

namespace {

struct TraceBody {
  template <class Acc>
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::Params& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, Acc& acc) {
    return rt::trace_pixel_grad(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects, in bytes.
size_t rt_trace_bwd_smem(int n) { return rt::bwd_smem(n); }

// Launch the trace backward on ``stream`` of ``device`` (rt::launch_bwd).
int rt_trace_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int max_reflections,
                 int refraction_cap, int bg, float cutoff, const float* g_r, const float* g_g,
                 const float* g_b, float* out_block, float* prim_r, float* prim_g,
                 float* prim_b, int device, void* stream) {
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  return rt::launch_bwd<TraceBody>(f32t, i32t, cam, light, n, p, cutoff, g_r, g_g, g_b,
                                   out_block, prim_r, prim_g, prim_b, device, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
