// Host build of the march backward's per-pixel body (march_bwd_body.cuh): a
// plain loop over the pixels on the CPU, so the kernel's adjoint can be
// tested against torch autograd of the plain PyTorch version where there is
// no card. Same arguments as rt_march_bwd in march_bwd.cu (the window, each
// pixel at its global place in the frame, and the texture atlas: the
// textured body where ``n_tex`` > 0), minus the device and stream; it
// returns 0, or 1 (cudaErrorInvalidValue) for a window with no pixel or past
// the frame, or rt::FIXED_OVERFLOW. It adds each term to its int64 block in
// the kernels' fixed point (fixed_sum.cuh: host_fixed_sum).
// rt_march_bwd_buf_host is rt_march_bwd_buf's (march_bwd_buf.cu), with
// its records in a buffer the caller passes, the window band by band, and
// its record pass the deep march.
// Build with ``g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC`` (and
// -DRT_COUNT_OPS to count into ops_total[0..5] as march_host.cpp does).

#include "fixed_sum.cuh"
#include "march_bwd_body.cuh"

namespace {

// Each term into the int64 block in the kernels' fixed point
// (fixed_sum.cuh: host_fixed_sum).
struct HostAcc : rt::FixedTerms {
  long long* block;
  HostAcc(long long* b, const rt::FixedTerms& t) : rt::FixedTerms(t), block(b) {}
  void add(int row, int col, float v) {
    put(block, row * rt::GRAD_COLS + col, take(row * rt::GRAD_COLS + col, v));
  }
};

// The host loop over the window's pixels, band by band of ``band_rows`` x
// ``band_cols`` (0: the window; rt::launch_bwd's bands): ``pixel(s, pb, ix,
// iy, g, acc)`` runs one pixel's body in band ``pb``; returns
// rt_march_bwd_host's code.
template <class P, class F>
int host_loop(const float* f32t, const int* i32t, const float* light, int n, const P& p,
              const void* tex, const int* tex_meta, int n_tex, int tex_stride, int tex_texels,
              const float* g_r, const float* g_g, const float* g_b, float* out_block,
              float* prim_r, float* prim_g, float* prim_b, unsigned long long* ops_total,
              F&& pixel, int band_rows = 0, int band_cols = 0) {
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
  const int br = band_rows > 0 ? band_rows : p.h, bc = band_cols > 0 ? band_cols : p.w;
  if (!rt::window_ok(p) || (br > 1 && bc < p.w)) return 1;
  const long long pixels = static_cast<long long>(p.h) * p.w;
#ifdef RT_COUNT_OPS
  std::vector<unsigned long long> again(8);  // a second run's counts
  int runs = 0;
#endif
  return rt::host_fixed_sum(
      out_block, (n + 1) * rt::GRAD_COLS, rt::planes_gbits(g_r, g_g, g_b, pixels),
      [&](long long* q, const rt::FixedTerms& t) {
        HostAcc acc(q, t);
#ifdef RT_COUNT_OPS
        unsigned long long* ops = runs++ == 0 ? ops_total : again.data();
        s.ops = ops;
#else
        unsigned long long* ops = ops_total;
        (void)ops;
#endif
        for (int r = 0; r < p.h; r += br) {
          for (int c = 0; c < p.w; c += bc) {
            P pb = p;
            pb.row0 = p.row0 + r;
            pb.col0 = p.col0 + c;
            pb.h = std::min(br, p.h - r);
            pb.w = std::min(bc, p.w - c);
            for (int ly = 0; ly < pb.h; ++ly) {  // the pixel in the band
              for (int lx = 0; lx < pb.w; ++lx) {
                const long o = static_cast<long>(r + ly) * p.w + c + lx;
                RT_PIXEL_COUNT_BEGIN(ops);
                const rt::C3 col = pixel(s, pb, pb.col0 + lx, pb.row0 + ly,
                                         rt::c3(g_r[o], g_g[o], g_b[o]), acc);
                RT_PIXEL_COUNT_END(ops);
                if (prim_r != nullptr) {
                  prim_r[o] = col.r;
                  prim_g[o] = col.g;
                  prim_b[o] = col.b;
                }
              }
            }
          }
        }
        return static_cast<rt::FixedTerms>(acc);
      });
}

rt::MarchParams params(int xres, int yres, int row0, int col0, int h, int w, float sx, float sy,
                       int refraction_cap, int bg, int max_laps, int max_iter, float eps,
                       float far_away, int glow_on, float glow, int floor_skip) {
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
  return p;
}

}  // namespace

extern "C" int rt_march_bwd_host(const float* f32t, const int* i32t, const float* cam,
                                 const float* light, int n, int xres, int yres, int row0,
                                 int col0, int h, int w, float sx, float sy, int refraction_cap,
                                 int bg, int max_laps, int max_iter, float eps, float far_away,
                                 int glow_on, float glow, int floor_skip, float cutoff,
                                 const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                                 int tex_texels, const float* g_r, const float* g_g,
                                 const float* g_b, float* out_block, float* prim_r,
                                 float* prim_g, float* prim_b, unsigned long long* ops_total) {
  const rt::MarchParams p = params(xres, yres, row0, col0, h, w, sx, sy, refraction_cap, bg,
                                   max_laps, max_iter, eps, far_away, glow_on, glow, floor_skip);
  return host_loop(f32t, i32t, light, n, p, tex, tex_meta, n_tex, tex_stride, tex_texels, g_r, g_g,
                   g_b, out_block, prim_r, prim_g, prim_b, ops_total,
                   [&](const rt::SceneView& s, const rt::MarchParams&, int ix, int iy,
                       rt::C3 g, HostAcc& acc) {
                     return n_tex > 0
                                ? rt::march_pixel_grad<true>(s, p, cutoff, cam, ix, iy, g, acc)
                                : rt::march_pixel_grad<false>(s, p, cutoff, cam, ix, iy, g, acc);
                   });
}

// rt_march_bwd_buf's twin (march_bwd_buf.cu): the textured body with the
// records of ``site_cap`` laps a pixel in ``buf``, laid out as the kernel
// lays them out.
extern "C" int rt_march_bwd_buf_host(const float* f32t, const int* i32t, const float* cam,
                                     const float* light, int n, int xres, int yres, int row0,
                                     int col0, int h, int w, float sx, float sy,
                                     int refraction_cap, int bg, int max_laps, int max_iter,
                                     float eps, float far_away, int glow_on, float glow,
                                     int floor_skip, float cutoff, const void* tex,
                                     const int* tex_meta, int n_tex, int tex_stride,
                                     int tex_texels, const float* g_r, const float* g_g,
                                     const float* g_b, float* out_block, float* prim_r,
                                     float* prim_g, float* prim_b, int site_cap, unsigned* buf,
                                     int band_rows, int band_cols,
                                     unsigned long long* ops_total) {
  if (site_cap < 1 || buf == nullptr || refraction_cap > rt::MARCH_FRAMES_DEEP) return 1;
  rt::RecBuf<rt::MarchParams> p;
  static_cast<rt::MarchParams&>(p) = params(xres, yres, row0, col0, h, w, sx, sy,
                                            refraction_cap, bg, max_laps, max_iter, eps,
                                            far_away, glow_on, glow, floor_skip);
  p.buf = buf;
  p.cap = site_cap;
  return host_loop(f32t, i32t, light, n, p, tex, tex_meta, n_tex, tex_stride, tex_texels, g_r, g_g,
                   g_b, out_block, prim_r, prim_g, prim_b, ops_total,
                   [&](const rt::SceneView& s, const rt::RecBuf<rt::MarchParams>& pb, int ix,
                       int iy, rt::C3 g, HostAcc& acc) {
                     return rt::march_pixel_grad_buf<true>(s, pb, cutoff, cam, ix, iy, g, acc);
                   },
                   band_rows, band_cols);
}

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed), as the CUDA libraries' rt_fixed_stats.
extern "C" void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

// The name of a launcher's return code (bwd_kernel.cuh: error_string).
extern "C" const char* rt_error_string(int code) {
  return code == rt::FIXED_OVERFLOW ? "the fixed-point cotangent sum would overflow int64"
                                    : (code == 1 ? "invalid argument" : "unknown error");
}
