// Host build of the trace backward's per-pixel body (trace_bwd_body.cuh): a
// plain loop over the pixels on the CPU, so the kernel's adjoint can be
// tested against torch autograd of the plain PyTorch version where there is
// no card. Same arguments as rt_trace_bwd in trace_bwd.cu (the window too:
// the loop covers it, each pixel at its global place in the frame), minus
// the device and stream; it returns 0, or 1 (cudaErrorInvalidValue) for a
// window with no pixel or past the frame; a record cap the kernel is not
// built for leaves NaN in the block. It reads the tables where they lie and
// adds each cotangent straight to its int64 block, as the -DRT_GLOBAL_TABLES
// build does, in the kernels' fixed point (fixed_sum.cuh: host_fixed_sum,
// the same terms, scale and counts). Build with ``g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC``
// (and -DRT_COUNT_OPS to add to ops_total: [0] the operation count, [1] the
// texel bytes of the record pass's texture fetches, [2] the accumulator's
// adds, [3] the distinct (warp, block entry) pairs among them, a warp being
// 32 pixels of a row, [4] the sites, [5] the most sites of one pixel).
//
// The host accumulator adds each nonzero entry as it comes, lane by lane,
// as the kernel's accumulator did before it summed over a warp; the pairs
// are the fewest adds a warp-aggregated scatter can reach. Its integers are
// the kernel's: a lane there turns the same terms (its pixel's camera and
// light sums once, at the flush) into integers before it sums.
//
// rt_fixed_sum_host sums given terms as the kernels do, rt_fixed_split_host
// gives the split a second run takes for a count of n bits, and
// rt_fixed_stats the last launch's scale, counts and split (fixed_sum.cuh:
// last_fixed), for the tests.
//
// rt_trace_bwd_buf_host is rt_trace_bwd_buf's twin: the records of every
// pixel of a band in ``buf``, laid out as the kernel lays them out, the
// window band by band.
//
// The rt_*_adj functions expose single adjoint steps for the tests, each
// over ``m`` cases laid out as flat arrays.

#include <vector>

#include "fixed_sum.cuh"
#include "trace_bwd_body.cuh"

namespace {

struct HostAcc : rt::FixedTerms {
  long long* block;
#ifdef RT_COUNT_OPS
  unsigned long long* ops;
  std::vector<char> seen;  // entries this warp has added to
  std::vector<int> touched;

  void new_warp() {
    for (int a : touched) seen[a] = 0;
    touched.clear();
  }
#endif

  HostAcc(long long* b, const rt::FixedTerms& t) : rt::FixedTerms(t), block(b) {}

  void add(int row, int col, float v) {
    const int a = row * rt::GRAD_COLS + col;
    put(block, a, take(a, v));
#ifdef RT_COUNT_OPS
    ++ops[2];
    if (!seen[a]) {
      seen[a] = 1;
      touched.push_back(a);
      ++ops[3];
    }
#endif
  }
  void add_row(int row, const float (&g)[rt::F32_COLS]) {
    for (int k = 0; k < rt::F32_COLS; ++k)
      if (g[k] != 0.0f) add(row, k, g[k]);
  }
  void add_cam(int row, const float (&g)[rt::CAM_GRADS]) {
    for (int k = 0; k < rt::CAM_GRADS; ++k)
      if (g[k] != 0.0f) add(row, k, g[k]);
  }
};

// The host loop over the window's pixels, band by band of ``band_rows`` x
// ``band_cols`` (0: the window; rt::launch_bwd's bands): ``pixel(s, pb, ix,
// iy, g, acc)`` runs one pixel's body in band ``pb``; returns
// rt_trace_bwd_host's code.
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
        s.ops = acc.ops = runs++ == 0 ? ops_total : again.data();
        acc.seen.assign(static_cast<size_t>(n + 1) * rt::GRAD_COLS, 0);
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
#ifdef RT_COUNT_OPS
                if (lx % 32 == 0) acc.new_warp();
#endif
                const long o = static_cast<long>(r + ly) * p.w + c + lx;
                const rt::C3 g = rt::c3(g_r[o], g_g[o], g_b[o]);
                rt::C3 col = pixel(s, pb, pb.col0 + lx, pb.row0 + ly, g, acc);
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

rt::Params params(int xres, int yres, int row0, int col0, int h, int w, float sx, float sy,
                  int max_reflections, int refraction_cap, int bg) {
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.row0 = row0;
  p.col0 = col0;
  p.h = h;
  p.w = w;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  return p;
}

}  // namespace

extern "C" {

int rt_trace_bwd_host(const float* f32t, const int* i32t, const float* cam,
                      const float* light, int n, int xres, int yres, int row0, int col0, int h,
                      int w, float sx, float sy, int max_reflections, int refraction_cap, int bg,
                      float cutoff, int site_cap, const void* tex, const int* tex_meta,
                      int n_tex, int tex_stride, int tex_texels, const float* g_r,
                      const float* g_g, const float* g_b, float* out_block, float* prim_r,
                      float* prim_g, float* prim_b, unsigned long long* ops_total) {
  const rt::Params p = params(xres, yres, row0, col0, h, w, sx, sy, max_reflections,
                              refraction_cap, bg);
  if (!rt::window_ok(p)) return 1;
  // the kernel's choice of the deep task stack (trace_bwd.cu)
  const bool deep = rt::stack_tasks(max_reflections, refraction_cap) > rt::STACK_CAP &&
                    site_cap > rt::STACK_CAP;
  int rc = 0;
  const int cap_rc = rt::with_site_cap(site_cap, [&](auto cap) {
    constexpr int C = decltype(cap)::value;
    rc = host_loop(f32t, i32t, light, n, p, tex, tex_meta, n_tex, tex_stride, tex_texels, g_r, g_g,
                   g_b, out_block, prim_r, prim_g, prim_b, ops_total,
                   [&](const rt::SceneView& s, const rt::Params&, int ix, int iy, rt::C3 g,
                       HostAcc& acc) {
                     return deep ? rt::trace_pixel_grad<C, rt::STACK_CAP_DEEP>(s, p, cutoff,
                                                                               cam, ix, iy, g,
                                                                               acc)
                                 : rt::trace_pixel_grad<C>(s, p, cutoff, cam, ix, iy, g, acc);
                   });
    return 0;
  });
  if (cap_rc != 0) out_block[0] = nanf("");
  return rc;
}

int rt_trace_bwd_buf_host(const float* f32t, const int* i32t, const float* cam,
                          const float* light, int n, int xres, int yres, int row0, int col0,
                          int h, int w, float sx, float sy, int max_reflections,
                          int refraction_cap, int bg, float cutoff, int site_cap,
                          const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                          int tex_texels, const float* g_r, const float* g_g, const float* g_b,
                          float* out_block, float* prim_r, float* prim_g, float* prim_b,
                          unsigned* buf, int band_rows, int band_cols,
                          unsigned long long* ops_total) {
  rt::RecBuf<rt::Params> p;
  static_cast<rt::Params&>(p) = params(xres, yres, row0, col0, h, w, sx, sy, max_reflections,
                                       refraction_cap, bg);
  p.buf = buf;
  p.cap = site_cap;
  const int tasks = rt::stack_tasks(max_reflections, refraction_cap);
  if (tasks > rt::STACK_CAP_DEEP || site_cap < 1 || buf == nullptr) return 1;
  return host_loop(f32t, i32t, light, n, p, tex, tex_meta, n_tex, tex_stride, tex_texels, g_r, g_g,
                   g_b, out_block, prim_r, prim_g, prim_b, ops_total,
                   [&](const rt::SceneView& s, const rt::RecBuf<rt::Params>& pb, int ix,
                       int iy, rt::C3 g, HostAcc& acc) {
                     return tasks > rt::STACK_CAP
                                ? rt::trace_pixel_grad_buf<rt::STACK_CAP_DEEP>(s, pb, cutoff, cam,
                                                                               ix, iy, g, acc)
                                : rt::trace_pixel_grad_buf<rt::STACK_CAP>(s, pb, cutoff, cam, ix,
                                                                          iy, g, acc);
                   },
                   band_rows, band_cols);
}

// The kernels' sum of ``m`` terms ``x`` at block entries ``entry`` (of
// ``entries``), in the order given, added to ``out``: their launch's
// fixed point (fixed_sum.cuh: host_fixed_sum) at the scale of the largest
// |g| ``gmax``, or ``forced`` (when not FIXED_FREE = INT_MIN: no retry).
// Returns 0 or FIXED_OVERFLOW, the scale taken in *scale.
int rt_fixed_sum_host(int m, const int* entry, const float* x, int entries, float gmax,
                      int forced, float* out, int* scale) {
  return rt::host_fixed_sum(
      out, entries, rt::finite_abs_bits(gmax),
      [&](long long* lo, const rt::FixedTerms& t) {
        rt::FixedTerms acc = t;
        for (int i = 0; i < m; ++i) acc.put(lo, entry[i], acc.take(entry[i], x[i]));
        return acc;
      },
      forced, scale);
}

// The split of a second run whose count takes ``n`` bits (fixed_sum.cuh:
// retry_split): out[0] the lo digit's width L, out[1] the bound Q of a
// term's q (|q| < 2^Q; the scale it takes for terms below 2^0). Returns 0,
// or FIXED_OVERFLOW (and nothing set) where no split holds.
int rt_fixed_split_host(int n, int* out) {
  int f = 0, lo_bits = 0;
  if (!rt::retry_split(n, 126, &f, &lo_bits)) return rt::FIXED_OVERFLOW;
  out[0] = lo_bits;
  out[1] = f;
  return 0;
}

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed), as the CUDA libraries' rt_fixed_stats.
void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

// The name of a launcher's return code (bwd_kernel.cuh: error_string):
// 1 for a call the loop does not take, FIXED_OVERFLOW.
const char* rt_error_string(int code) {
  return code == rt::FIXED_OVERFLOW ? "the fixed-point cotangent sum would overflow int64"
                                    : (code == 1 ? "invalid argument" : "unknown error");
}

// light (3), d (3m), g (3m) -> g_light (3m), g_d (3m): default sky.
void rt_sky_adj(int m, const float* light, const float* d, const float* g, float* g_light,
                float* g_d) {
  rt::V3 l = rt::v3(light[0], light[1], light[2]);
  for (int i = 0; i < m; ++i) {
    const float* di = d + 3 * i;
    const float* gi = g + 3 * i;
    rt::V3 gl = rt::v3(0.0f, 0.0f, 0.0f), gd = rt::v3(0.0f, 0.0f, 0.0f);
    rt::background_adj(rt::BG_DEFAULT_SKY, l, rt::v3(di[0], di[1], di[2]),
                       rt::c3(gi[0], gi[1], gi[2]), &gl, &gd);
    g_light[3 * i] = gl.x, g_light[3 * i + 1] = gl.y, g_light[3 * i + 2] = gl.z;
    g_d[3 * i] = gd.x, g_d[3 * i + 1] = gd.y, g_d[3 * i + 2] = gd.z;
  }
}

// eye (3m), n (3m), refraction (m), g_ray (3m) -> g_eye (3m), g_n (3m),
// g_refraction (m): the refraction bend.
void rt_bend_adj(int m, const float* eye, const float* n, const float* refr, const float* g_ray,
                 float* g_eye, float* g_n, float* g_refr) {
  for (int i = 0; i < m; ++i) {
    const float* e = eye + 3 * i;
    const float* nn = n + 3 * i;
    const float* gr = g_ray + 3 * i;
    rt::V3 ge = rt::v3(0.0f, 0.0f, 0.0f), gn = rt::v3(0.0f, 0.0f, 0.0f);
    float gf = 0.0f;
    rt::bend_adj(rt::v3(e[0], e[1], e[2]), rt::v3(nn[0], nn[1], nn[2]), refr[i],
                 rt::v3(gr[0], gr[1], gr[2]), &ge, &gn, &gf);
    g_eye[3 * i] = ge.x, g_eye[3 * i + 1] = ge.y, g_eye[3 * i + 2] = ge.z;
    g_n[3 * i] = gn.x, g_n[3 * i + 1] = gn.y, g_n[3 * i + 2] = gn.z;
    g_refr[i] = gf;
  }
}

// The camera rays of the window (row0, col0, h, w) of an xres x yres image,
// at their global pixels: cam (8), g_eye (3 * h * w, pixel-major) -> g_rot
// (4): the summed rotation cotangent.
void rt_camera_ray_adj(int xres, int yres, int row0, int col0, int h, int w, float sx,
                       float sy, const float* cam, const float* g_eye, float* g_rot) {
  for (int k = 0; k < 4; ++k) g_rot[k] = 0.0f;
  for (int ly = 0; ly < h; ++ly) {
    for (int lx = 0; lx < w; ++lx) {
      const float* ge = g_eye + 3 * (static_cast<long>(ly) * w + lx);
      rt::Q4 gq = rt::camera_ray_adj(xres, yres, sx, sy, cam, col0 + lx, row0 + ly,
                                     rt::v3(ge[0], ge[1], ge[2]));
      g_rot[0] += gq.x, g_rot[1] += gq.y, g_rot[2] += gq.z, g_rot[3] += gq.w;
    }
  }
}

// ri (m), pn (m), g (m) -> g_ri (m), g_pn (m): the Phong power.
void rt_pow_adj(int m, const float* ri, const float* pn, const float* g, float* g_ri,
                float* g_pn) {
  for (int i = 0; i < m; ++i) {
    g_ri[i] = 0.0f;
    g_pn[i] = 0.0f;
    rt::pow_adj(ri[i], pn[i], g[i], &g_ri[i], &g_pn[i]);
  }
}

// tid, u, v (m), g (3m), the atlas as rt_trace_bwd_host's -> gu, gv (m):
// the texture fetch's adjoint.
void rt_fetch_texture_adj(int m, const int* tid, const float* u, const float* v, const float* g,
                          const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                          int tex_texels, float* gu, float* gv) {
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  for (int i = 0; i < m; ++i) {
    gu[i] = 0.0f;
    gv[i] = 0.0f;
    rt::fetch_texture_adj(tx, tid[i], u[i], v[i], rt::c3(g[3 * i], g[3 * i + 1], g[3 * i + 2]),
                          &gu[i], &gv[i]);
  }
}

}  // extern "C"
