// Host build of the trace kernel's per-pixel body (trace_body.cuh): a plain
// loop over the pixels on the CPU, so the kernel's logic can be tested
// against the plain PyTorch version where there is no card. Same arguments
// as rt_trace_fwd in trace_fwd.cu, minus the device and stream. Build with
// ``g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC`` (and
// -DRT_COUNT_OPS to add the operation count to ops_total[0], the texel
// bytes read to ops_total[1] and the shading, sky and camera-ray operations
// to ops_total[2]).

#define RT_COUNT_SHADING
#include "trace_body.cuh"

extern "C" void rt_trace_host(const float* f32t, const int* i32t, const float* cam,
                              const float* light, int n, int xres, int yres, float sx,
                              float sy, int max_reflections, int refraction_cap, int bg,
                              const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                              int tex_len, float* out_r, float* out_g, float* out_b,
                              unsigned long long* ops_total) {
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
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  for (int iy = 0; iy < yres; ++iy) {
    for (int ix = 0; ix < xres; ++ix) {
      rt::C3 c = rt::trace_pixel(s, p, cam, ix, iy);
      const long o = static_cast<long>(iy) * xres + ix;
      out_r[o] = c.r;
      out_g[o] = c.g;
      out_b[o] = c.b;
    }
  }
}

// The texture fetch alone (K1a), for the tests: texture ids, u and v (m
// each) -> colours (3m), with the atlas arguments as above.
extern "C" void rt_fetch_texture_host(int m, const int* tid, const float* u, const float* v,
                                      const void* tex, const int* tex_meta, int n_tex,
                                      int tex_stride, int tex_len, float* rgb) {
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_len};
  for (int i = 0; i < m; ++i) {
    const rt::C3 c = rt::fetch_texture(tx, tid[i], u[i], v[i]);
    rgb[3 * i] = c.r, rgb[3 * i + 1] = c.g, rgb[3 * i + 2] = c.b;
  }
}
