// Host build of the march backward's per-pixel body (march_bwd_body.cuh): a
// plain loop over the pixels on the CPU, so the kernel's adjoint can be
// tested against torch autograd of the plain PyTorch version where there is
// no card. Same arguments as rt_march_bwd in march_bwd.cu, minus the device
// and stream. Build with ``g++ -std=c++17 -O2 -ffp-contract=off -shared
// -fPIC`` (and -DRT_COUNT_OPS to add the operation count to *ops_total).

#include "march_bwd_body.cuh"

namespace {

struct HostAcc {
  float* block;
  void add(int row, int col, float v) { block[row * rt::GRAD_COLS + col] += v; }
};

}  // namespace

extern "C" void rt_march_bwd_host(const float* f32t, const int* i32t, const float* cam,
                                  const float* light, int n, int xres, int yres, float sx,
                                  float sy, int refraction_cap, int bg, int max_laps,
                                  int max_iter, float eps, float far_away, int glow_on,
                                  float glow, float cutoff, const float* g_r, const float* g_g,
                                  const float* g_b, float* out_block, float* prim_r,
                                  float* prim_g, float* prim_b, unsigned long long* ops_total) {
  rt::SceneView s;
  s.f32 = f32t;
  s.i32 = i32t;
  s.n = n;
  s.light = rt::v3(light[0], light[1], light[2]);
#ifdef RT_COUNT_OPS
  s.ops = ops_total;
#else
  (void)ops_total;
#endif
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
  HostAcc acc = {out_block};
  for (int iy = 0; iy < yres; ++iy) {
    for (int ix = 0; ix < xres; ++ix) {
      const long o = static_cast<long>(iy) * xres + ix;
      rt::C3 c = rt::march_pixel_grad(s, p, cutoff, cam, ix, iy,
                                      rt::c3(g_r[o], g_g[o], g_b[o]), acc);
      if (prim_r != nullptr) {
        prim_r[o] = c.r;
        prim_g[o] = c.g;
        prim_b[o] = c.b;
      }
    }
  }
}
