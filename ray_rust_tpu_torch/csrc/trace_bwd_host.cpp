// Host build of the trace backward's per-pixel body (trace_bwd_body.cuh): a
// plain loop over the pixels on the CPU, so the kernel's adjoint can be
// tested against torch autograd of the plain PyTorch version where there is
// no card. Same arguments as rt_trace_bwd in trace_bwd.cu, minus the device
// and stream; a record cap the kernel is not built for leaves NaN in the
// block. It reads the tables where they lie and adds each cotangent straight
// to the block, as the -DRT_GLOBAL_TABLES build does. Build with ``g++
// -std=c++17 -O2 -ffp-contract=off -shared -fPIC`` (and -DRT_COUNT_OPS to add
// to ops_total: [0] the operation count, [1] the texel bytes of the record
// pass's texture fetches, [2] the accumulator's adds, [3] the distinct (warp,
// block entry) pairs among them, a warp being 32 pixels of a row, [4] the
// sites, [5] the most sites of one pixel).
//
// The host accumulator adds each nonzero entry as it comes, lane by lane,
// as the kernel's accumulator did before it summed over a warp; the pairs
// are the fewest adds a warp-aggregated scatter can reach.
//
// The rt_*_adj functions expose single adjoint steps for the tests, each
// over ``m`` cases laid out as flat arrays.

#include <vector>

#include "trace_bwd_body.cuh"

namespace {

struct HostAcc {
  float* block;
#ifdef RT_COUNT_OPS
  unsigned long long* ops;
  std::vector<char> seen;  // entries this warp has added to
  std::vector<int> touched;

  void new_warp() {
    for (int a : touched) seen[a] = 0;
    touched.clear();
  }
#endif

  void add(int row, int col, float v) {
    const int a = row * rt::GRAD_COLS + col;
    block[a] += v;
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

}  // namespace

extern "C" {

void rt_trace_bwd_host(const float* f32t, const int* i32t, const float* cam,
                       const float* light, int n, int xres, int yres, float sx, float sy,
                       int max_reflections, int refraction_cap, int bg, float cutoff,
                       int site_cap, const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                       int tex_len, const float* g_r, const float* g_g, const float* g_b,
                       float* out_block, float* prim_r, float* prim_g, float* prim_b,
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
  HostAcc acc;
  acc.block = out_block;
#ifdef RT_COUNT_OPS
  acc.ops = ops_total;
  acc.seen.assign(static_cast<size_t>(n + 1) * rt::GRAD_COLS, 0);
#endif
  const int r = max_reflections > 1 ? max_reflections : 1;
  // the kernel's choice of the deep task stack (trace_bwd.cu)
  const bool deep = 1 + r * (r - 1) / 2 > rt::STACK_CAP && site_cap > rt::STACK_CAP;
  const int rc = rt::with_site_cap(site_cap, [&](auto cap) {
    for (int iy = 0; iy < yres; ++iy) {
      for (int ix = 0; ix < xres; ++ix) {
#ifdef RT_COUNT_OPS
        if (ix % 32 == 0) acc.new_warp();
#endif
        const long o = static_cast<long>(iy) * xres + ix;
        constexpr int C = decltype(cap)::value;
        const rt::C3 g = rt::c3(g_r[o], g_g[o], g_b[o]);
        rt::C3 c = deep ? rt::trace_pixel_grad<C, rt::STACK_CAP_DEEP>(s, p, cutoff, cam, ix, iy, g,
                                                                       acc)
                        : rt::trace_pixel_grad<C>(s, p, cutoff, cam, ix, iy, g, acc);
        if (prim_r != nullptr) {
          prim_r[o] = c.r;
          prim_g[o] = c.g;
          prim_b[o] = c.b;
        }
      }
    }
    return 0;
  });
  if (rc != 0) out_block[0] = nanf("");
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

// The camera rays of an xres x yres image: cam (8), g_eye (3 * xres * yres,
// pixel-major) -> g_rot (4): the summed rotation cotangent.
void rt_camera_ray_adj(int xres, int yres, float sx, float sy, const float* cam,
                       const float* g_eye, float* g_rot) {
  for (int k = 0; k < 4; ++k) g_rot[k] = 0.0f;
  for (int iy = 0; iy < yres; ++iy) {
    for (int ix = 0; ix < xres; ++ix) {
      const float* ge = g_eye + 3 * (static_cast<long>(iy) * xres + ix);
      rt::Q4 gq =
          rt::camera_ray_adj(xres, yres, sx, sy, cam, ix, iy, rt::v3(ge[0], ge[1], ge[2]));
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
                          int tex_len, float* gu, float* gv) {
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_len};
  for (int i = 0; i < m; ++i) {
    gu[i] = 0.0f;
    gv[i] = 0.0f;
    rt::fetch_texture_adj(tx, tid[i], u[i], v[i], rt::c3(g[3 * i], g[3 * i + 1], g[3 * i + 2]),
                          &gu[i], &gv[i]);
  }
}

}  // extern "C"
