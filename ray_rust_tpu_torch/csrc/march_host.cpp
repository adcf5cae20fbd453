// Host build of the march kernel's per-pixel body (march_body.cuh): a plain
// loop over the pixels on the CPU, so the kernel's logic can be tested
// against the plain PyTorch version where there is no card. Same arguments
// as rt_march_fwd in march_fwd.cu (the window and the texture atlas too),
// minus the device and stream. Build with ``g++ -std=c++17 -O2
// -ffp-contract=off -shared -fPIC`` (and -DRT_COUNT_OPS to count into
// ops_total[0..5]: f32 operations, the texel bytes the textured hits read,
// the largest per pixel, object passes, the largest per pixel, the marches
// the never-converges test ended). rt_march_deep_host is the same loop
// through the deep march (march_body.cuh: raymarch_deep), the body of
// march_fwd_deep.cu.

#include "march_body.cuh"

namespace {

// The host loop over the window's pixels; DEEP: through the deep march.
template <bool DEEP>
void host_render(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                 float sy, int refraction_cap, int bg, int max_laps, int max_iter, float eps,
                 float far_away, int glow_on, float glow, int floor_skip, const void* tex,
                 const int* tex_meta, int n_tex, int tex_stride, int tex_texels, float* out_r,
                 float* out_g, float* out_b, unsigned long long* ops_total) {
  rt::SceneView s;
  s.f32 = f32t;
  s.i32 = i32t;
  s.n = n;
  s.light = rt::v3(light[0], light[1], light[2]);
  s.tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride, tex_texels};
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
  for (int ly = 0; ly < h; ++ly) {
    for (int lx = 0; lx < w; ++lx) {
      RT_PIXEL_COUNT_BEGIN(ops_total);
      rt::C3 c = DEEP ? rt::march_pixel_deep(s, p, cam, col0 + lx, row0 + ly)
                      : rt::march_pixel(s, p, cam, col0 + lx, row0 + ly);
      RT_PIXEL_COUNT_END(ops_total);
      const long o = static_cast<long>(ly) * w + lx;
      out_r[o] = c.r;
      out_g[o] = c.g;
      out_b[o] = c.b;
    }
  }
}

}  // namespace

#define RT_MARCH_HOST_ARGS                                                                   \
  const float *f32t, const int *i32t, const float *cam, const float *light, int n, int xres, \
      int yres, int row0, int col0, int h, int w, float sx, float sy, int refraction_cap,     \
      int bg, int max_laps, int max_iter, float eps, float far_away, int glow_on, float glow, \
      int floor_skip, const void *tex, const int *tex_meta, int n_tex, int tex_stride,        \
      int tex_texels, float *out_r, float *out_g, float *out_b, unsigned long long *ops_total
#define RT_MARCH_HOST_CALL                                                                  \
  f32t, i32t, cam, light, n, xres, yres, row0, col0, h, w, sx, sy, refraction_cap, bg,      \
      max_laps, max_iter, eps, far_away, glow_on, glow, floor_skip, tex, tex_meta, n_tex,   \
      tex_stride, tex_texels, out_r, out_g, out_b, ops_total

extern "C" void rt_march_host(RT_MARCH_HOST_ARGS) { host_render<false>(RT_MARCH_HOST_CALL); }

// rt_march_host through the deep march (march_fwd_deep.cu's body).
extern "C" void rt_march_deep_host(RT_MARCH_HOST_ARGS) { host_render<true>(RT_MARCH_HOST_CALL); }
