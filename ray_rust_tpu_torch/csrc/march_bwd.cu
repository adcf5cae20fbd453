// March-mode backward (K4) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_march_grads
// (the body _make_march_bwd_kernel, its record _p1_march and replay
// _p2_march_replay) for march-mode scenes: from the packed scene
// tables and the cotangent planes of the image it computes the cotangent of
// every object's 19 table columns and of the camera and the light, and
// optionally the image itself (the march kernel's, bit for bit). The
// per-pixel program lives in march_bwd_body.cuh. A textured scene (the JAX
// package's jnp path and its implicit VJP: its kernel declines textures)
// launches a second instance of the kernel, whose hits read the texture atlas
// and whose adjoint takes the texture's (u, v) cotangents through
// fetch_texture_adj, as K2's textured sites do; an untextured scene launches
// the kernel as it was before textures (its ptxas figures are pinned). A
// launch covers a window of the frame at its global origin, as K3's does
// (bwd_kernel.cuh).
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
// nonzero entry per block, in 64-bit fixed point, the same sum in any
// order). The JAX kernel's tile gates are not carried over. Built with
// --fmad=false, as the forward kernels.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_march_bwd.py).

#include "bwd_kernel.cuh"
#include "march_bwd_body.cuh"

namespace {

// TEX: the textured instance, which stages the atlas's meta rows
// (bwd_kernel.cuh) and reads the atlas.
template <bool TEX>
struct MarchBody : rt::BwdFrame {
  static constexpr bool TEXTURED = TEX;
  template <class Acc>
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::MarchParams& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, Acc& acc) {
    return rt::march_pixel_grad<TEX>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects and n_tex textures, in bytes.
size_t rt_march_bwd_smem(int n, int n_tex) { return rt::bwd_smem(n, n_tex); }

// Launch the march backward on ``stream`` of ``device`` (rt::launch_bwd)
// over the window of rt_march_fwd (march_fwd.cu), as rt_trace_bwd's
// (trace_bwd.cu): the textured instance where ``n_tex`` > 0, else the
// untextured one. The texture arguments are rt_trace_fwd's (trace_fwd.cu).
int rt_march_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                 float sy, int refraction_cap, int bg, int max_laps, int max_iter, float eps,
                 float far_away, int glow_on, float glow, int floor_skip, float cutoff,
                 const void* tex, const int* tex_meta, int n_tex, int tex_stride, int tex_texels,
                 const float* g_r, const float* g_g, const float* g_b, float* out_block,
                 float* prim_r, float* prim_g, float* prim_b, int device, void* stream) {
  rt::MarchParams p;
  p.xres = xres;
  p.yres = yres;
  p.row0 = row0;
  p.col0 = col0;
  p.h = h;
  p.w = w;
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
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  if (n_tex > 0)
    return rt::launch_bwd<MarchBody<true>>(f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g,
                                           g_b, out_block, prim_r, prim_g, prim_b, device,
                                           stream);
  return rt::launch_bwd<MarchBody<false>>(f32t, i32t, cam, light, n, p, rt::TexArgs{}, cutoff,
                                          g_r, g_g, g_b, out_block, prim_r, prim_g, prim_b,
                                          device, stream);
}

const char* rt_error_string(int code) { return rt::error_string(code); }

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed).
void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

}  // extern "C"
