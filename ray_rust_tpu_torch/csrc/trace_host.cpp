// Host build of the trace kernel's per-pixel body (trace_body.cuh): a plain
// loop over the kernel's 16x16 tiles on the CPU, so the kernel's logic can
// be tested against the plain PyTorch version where there is no card. Same
// arguments as rt_trace_fwd in trace_fwd.cu (the window too: its tiles
// start at the window's global origin), minus the device and stream;
// the tables are always read where they lie (as by the kernel's global-table
// build), and with ``cull`` each tile first builds K1b's two candidate
// masks with the kernel's own cull_object, object by object in place of the
// warps' ballots. Build with ``g++ -std=c++17 -O2 -ffp-contract=off -shared
// -fPIC`` (and -DRT_COUNT_OPS to add the operation count to ops_total[0],
// the texel bytes read to ops_total[1], the shading, sky and camera-ray
// operations to ops_total[2], and the cull's counts to ops_total[3..7],
// trace_body.cuh; that build also exports rt_trace_tasks_host, which gives
// the most tasks a pixel's stack held).

#define RT_COUNT_SHADING
#include <vector>

#include "trace_body.cuh"

namespace {

// K1b's masks of the tile at (col0, row0): one word a 32 objects.
void build_masks(const rt::SceneView& s, const rt::Params& p, const float* cam, int col0,
                 int row0, unsigned* prim, unsigned* shadow) {
  const rt::CullTile ct = rt::cull_tile(p, cam, s.light, col0, row0, rt::CULL_TILE, rt::CULL_TILE);
  RT_COUNT(s, rt::OPS_CULL_TILE);
  for (int w = 0; w < (s.n + 31) / 32; ++w) prim[w] = shadow[w] = 0u;
  for (int i = 0; i < s.n; ++i) {
    bool a, b;
    const int kind = s.i32[i * rt::I32_COLS];
    rt::cull_object(ct, s.f32 + i * rt::F32_COLS, kind, &a, &b);
    RT_COUNT(s, kind == rt::KIND_SPHERE ? rt::OPS_CULL_SPHERE : 0);
    RT_COUNT_SLOT(s, 3, 1);
    prim[i / 32] |= static_cast<unsigned>(a) << (i % 32);
    shadow[i / 32] |= static_cast<unsigned>(b) << (i % 32);
  }
}

template <bool CULL, int STACK>
void render(const rt::SceneView& s, const rt::Params& p, const float* cam, float* out_r,
            float* out_g, float* out_b) {
  const int words = (s.n + 31) / 32;
  std::vector<unsigned> prim(words), shadow(words);
  rt::FwdRecord<CULL, STACK> rec;
  rec.prim = prim.data();
  rec.shadow = shadow.data();
  for (int ty = 0; ty < p.h; ty += rt::CULL_TILE) {  // the tiles' corners in the window
    for (int tx = 0; tx < p.w; tx += rt::CULL_TILE) {
      if (CULL) build_masks(s, p, cam, p.col0 + tx, p.row0 + ty, prim.data(), shadow.data());
      for (int ly = ty; ly < ty + rt::CULL_TILE && ly < p.h; ++ly) {
        for (int lx = tx; lx < tx + rt::CULL_TILE && lx < p.w; ++lx) {
          rt::C3 c = rt::trace_pixel(s, p, cam, p.col0 + lx, p.row0 + ly, rec);
          const long o = static_cast<long>(ly) * p.w + lx;
          out_r[o] = c.r;
          out_g[o] = c.g;
          out_b[o] = c.b;
        }
      }
    }
  }
}

rt::Params params(int xres, int yres, float sx, float sy, int max_reflections,
                  int refraction_cap, int bg) {
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  return p;
}

rt::SceneView view(const float* f32t, const int* i32t, const float* light, int n,
                   unsigned long long* ops_total) {
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
  return s;
}

// The task stack as rt_trace_fwd sizes it: 64 where rt::stack_tasks > 16.
// ``tasks`` (the counting build's, else null) receives the most tasks a
// pixel's stack held.
void trace_host(const float* f32t, const int* i32t, const float* cam, const float* light, int n,
                int xres, int yres, int row0, int col0, int h, int w, float sx, float sy,
                int max_reflections, int refraction_cap, int bg, const void* tex,
                const int* tex_meta, int n_tex, int tex_stride, int tex_texels, int cull,
                float* out_r, float* out_g, float* out_b, unsigned long long* ops_total,
                unsigned long long* tasks) {
  rt::SceneView s = view(f32t, i32t, light, n, ops_total);
#ifdef RT_COUNT_OPS
  s.tasks = tasks;
#else
  (void)tasks;
#endif
  s.tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride, tex_texels};
  rt::Params p = params(xres, yres, sx, sy, max_reflections, refraction_cap, bg);
  p.row0 = row0;
  p.col0 = col0;
  p.h = h;
  p.w = w;
  const bool deep = rt::stack_tasks(max_reflections, refraction_cap) > rt::STACK_CAP;
  if (cull) {
    deep ? render<true, rt::STACK_CAP_DEEP>(s, p, cam, out_r, out_g, out_b)
         : render<true, rt::STACK_CAP>(s, p, cam, out_r, out_g, out_b);
  } else {
    deep ? render<false, rt::STACK_CAP_DEEP>(s, p, cam, out_r, out_g, out_b)
         : render<false, rt::STACK_CAP>(s, p, cam, out_r, out_g, out_b);
  }
}

}  // namespace

extern "C" void rt_trace_host(const float* f32t, const int* i32t, const float* cam,
                              const float* light, int n, int xres, int yres, int row0,
                              int col0, int h, int w, float sx, float sy,
                              int max_reflections, int refraction_cap, int bg,
                              const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                              int tex_texels, int cull, float* out_r, float* out_g,
                              float* out_b, unsigned long long* ops_total) {
  trace_host(f32t, i32t, cam, light, n, xres, yres, row0, col0, h, w, sx, sy, max_reflections,
             refraction_cap, bg, tex, tex_meta, n_tex, tex_stride, tex_texels, cull, out_r, out_g,
             out_b, ops_total, nullptr);
}

#ifdef RT_COUNT_OPS
// rt_trace_host, and the most tasks any pixel's stack held into *tasks.
extern "C" void rt_trace_tasks_host(const float* f32t, const int* i32t, const float* cam,
                                    const float* light, int n, int xres, int yres, int row0,
                                    int col0, int h, int w, float sx, float sy,
                                    int max_reflections, int refraction_cap, int bg,
                                    const void* tex, const int* tex_meta, int n_tex,
                                    int tex_stride, int tex_texels, int cull, float* out_r,
                                    float* out_g, float* out_b, unsigned long long* ops_total,
                                    unsigned long long* tasks) {
  *tasks = 0;
  trace_host(f32t, i32t, cam, light, n, xres, yres, row0, col0, h, w, sx, sy, max_reflections,
             refraction_cap, bg, tex, tex_meta, n_tex, tex_stride, tex_texels, cull, out_r, out_g,
             out_b, ops_total, tasks);
}
#endif

// K1b's two candidate masks of the tile whose top-left pixel is (col0,
// row0), for the tests: ceil(n/32) words each.
extern "C" void rt_cull_masks_host(const float* f32t, const int* i32t, const float* cam,
                                   const float* light, int n, int xres, int yres, float sx,
                                   float sy, int col0, int row0, unsigned* prim,
                                   unsigned* shadow) {
  unsigned long long counts[8] = {};  // the counting build's, dropped
  const rt::SceneView s = view(f32t, i32t, light, n, counts);
  const rt::Params p = params(xres, yres, sx, sy, 1, 0, 0);
  build_masks(s, p, cam, col0, row0, prim, shadow);
}

// The texture fetch alone (K1a), for the tests: texture ids, u and v (m
// each) -> colours (3m), with the atlas arguments as above.
extern "C" void rt_fetch_texture_host(int m, const int* tid, const float* u, const float* v,
                                      const void* tex, const int* tex_meta, int n_tex,
                                      int tex_stride, int tex_texels, float* rgb) {
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  for (int i = 0; i < m; ++i) {
    const rt::C3 c = rt::fetch_texture(tx, tid[i], u[i], v[i]);
    rgb[3 * i] = c.r, rgb[3 * i + 1] = c.g, rgb[3 * i + 2] = c.b;
  }
}

// The atlas offsets of m lookups (texel_index, 64-bit), for the tests: no
// texel is read, so the atlas need not exist (an atlas of 2^31 texels or
// more is 32 GiB); the meta rows and the sizes as above.
extern "C" void rt_texel_index_host(int m, const int* tid, const float* u, const float* v,
                                    const int* tex_meta, int n_tex, int tex_stride,
                                    int tex_texels, long long* out) {
  const rt::TexArgs tx = {nullptr, tex_meta, n_tex, tex_stride, tex_texels};
  for (int i = 0; i < m; ++i) {
    bool bilin;
    float fu, fv;
    out[i] = rt::texel_index(tx, tid[i], u[i], v[i], &bilin, &fu, &fv);
  }
}
