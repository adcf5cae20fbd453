// March-mode backward (K4) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_march_grads
// (the body _make_march_bwd_kernel, its record _p1_march and replay
// _p2_march_replay) for untextured march-mode scenes: from the packed scene
// tables and the cotangent planes of the image it computes the cotangent of
// every object's 19 table columns and of the camera and the light, and
// optionally the image itself (the march kernel's, bit for bit). The
// per-pixel program lives in march_bwd_body.cuh.
//
// What bounds it: its slowest thread, not bytes. It reads the tables and
// three f32 planes and writes an (n+1, 20) block and at most three planes,
// while each pixel re-runs the forward's whole traversal (its record pass:
// marches and shadow marches, one O(objects) SDF sweep after another) before
// a reverse sweep over at most MARCH_SITE_CAP recorded laps, which costs a
// few SDF sweeps. The record pass is K3's march body, floor tail and
// never-converges shortcut included (march_body.cuh), so it is as short as
// K3's; what is left is the reverse sweep and its records, held to 128
// registers with ~8 KB of stack a thread (ptxas). The design is simple and
// right, not fast, in the trace backward's frame (bwd_kernel.cuh: tables in
// shared memory, a shared (n+1, 20) accumulator, one global atomic per
// nonzero entry per block, summed in an order that changes from run to
// run). The JAX kernel's tile gates are not carried over. Built with
// --fmad=false, as the forward kernels.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_march_bwd.py).

#include "bwd_kernel.cuh"
#include "march_bwd_body.cuh"

namespace {

struct MarchBody : rt::BwdFrame {
  static constexpr bool TEXTURED = false;
  template <class Acc>
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::MarchParams& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, Acc& acc) {
    return rt::march_pixel_grad(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects, in bytes.
size_t rt_march_bwd_smem(int n) { return rt::bwd_smem(n); }

// Launch the march backward on ``stream`` of ``device`` (rt::launch_bwd).
int rt_march_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int refraction_cap, int bg,
                 int max_laps, int max_iter, float eps, float far_away, int glow_on, float glow,
                 int floor_skip, float cutoff, const float* g_r, const float* g_g, const float* g_b,
                 float* out_block, float* prim_r, float* prim_g, float* prim_b, int device,
                 void* stream) {
  rt::MarchParams p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  p.max_laps = max_laps;
  p.max_iter = max_iter;
  p.eps = eps;
  p.far_away = far_away;
  p.glow_on = glow_on;
  p.glow = glow;
  p.floor_skip = floor_skip;
  return rt::launch_bwd<MarchBody>(f32t, i32t, cam, light, n, p, rt::TexArgs{}, cutoff, g_r,
                                   g_g, g_b, out_block, prim_r, prim_g, prim_b, device, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
