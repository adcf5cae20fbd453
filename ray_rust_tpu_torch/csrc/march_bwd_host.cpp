// Host build of the march backward's per-pixel body (march_bwd_body.cuh): a
// plain loop over the pixels on the CPU, so the kernel's adjoint can be
// tested against torch autograd of the plain PyTorch version where there is
// no card. Same arguments as rt_march_bwd in march_bwd.cu (the window, each
// pixel at its global place in the frame, and the texture atlas: the
// textured body where ``n_tex`` > 0), minus the device and stream; it
// returns 0, or 1 (cudaErrorInvalidValue) for a window with no pixel or past
// the frame.
// Build with ``g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC`` (and
// -DRT_COUNT_OPS to count into ops_total[0..5] as march_host.cpp does).

#include "march_bwd_body.cuh"

namespace {

struct HostAcc {
  float* block;
  void add(int row, int col, float v) { block[row * rt::GRAD_COLS + col] += v; }
};

}  // namespace

extern "C" int rt_march_bwd_host(const float* f32t, const int* i32t, const float* cam,
                                 const float* light, int n, int xres, int yres, int row0,
                                 int col0, int h, int w, float sx, float sy, int refraction_cap,
                                 int bg, int max_laps, int max_iter, float eps, float far_away,
                                 int glow_on, float glow, int floor_skip, float cutoff,
                                 const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                                 int tex_len, const float* g_r, const float* g_g,
                                 const float* g_b, float* out_block, float* prim_r,
                                 float* prim_g, float* prim_b, unsigned long long* ops_total) {
  rt::SceneView s;
  s.f32 = f32t;
  s.i32 = i32t;
  s.n = n;
  s.light = rt::v3(light[0], light[1], light[2]);
  s.tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride, tex_len};
#ifdef RT_COUNT_OPS
  s.ops = ops_total;
#else
  (void)ops_total;
#endif
  rt::MarchParams p;
  p.xres = xres;
  p.yres = yres;
  p.row0 = row0;
  p.col0 = col0;
  p.h = h;
  p.w = w;
  if (!rt::window_ok(p)) return 1;
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
  HostAcc acc = {out_block};
  for (int ly = 0; ly < h; ++ly) {  // the pixel in the window
    for (int lx = 0; lx < w; ++lx) {
      const long o = static_cast<long>(ly) * w + lx;
      const int ix = col0 + lx, iy = row0 + ly;
      RT_PIXEL_COUNT_BEGIN(ops_total);
      const rt::C3 g = rt::c3(g_r[o], g_g[o], g_b[o]);
      const rt::C3 c = n_tex > 0 ? rt::march_pixel_grad<true>(s, p, cutoff, cam, ix, iy, g, acc)
                                 : rt::march_pixel_grad<false>(s, p, cutoff, cam, ix, iy, g, acc);
      RT_PIXEL_COUNT_END(ops_total);
      if (prim_r != nullptr) {
        prim_r[o] = c.r;
        prim_g[o] = c.g;
        prim_b[o] = c.b;
      }
    }
  }
  return 0;
}
