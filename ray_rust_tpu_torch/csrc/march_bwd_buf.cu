// March-mode backward (K4) past 35 laps, for Hopper (sm_90a), one thread per
// pixel.
//
// The kernel of march_bwd.cu with each pixel's records in device memory
// rather than in its thread's local arrays, for configurations whose laps
// outrun rt::MARCH_SITE_CAP (35: raymarch_max_reflections=7 at the default
// refraction_unroll=4 needs 39). A lap's record and a frame's take 192 bytes
// (march_bwd_body.cuh: MSite, MFrame), so the wrapper
// (ops/kernel_march_bwd.py) allocates a buffer of count_sites(cfg) * 192
// bytes a pixel for a band of the frame's rows within a budget, and the
// launcher runs the frame band by band (bwd_kernel.cuh: launch_bwd). The buffer is
// record-major and pixel-minor (trace_bwd_body.cuh: RecBuf, BufRecs): word k
// of a pixel's record i lies at (i * W + k) * h * w plus the pixel's place
// in the band, so the lanes of a warp, a row's neighbouring pixels, read
// and write consecutive words. The body is march_bwd.cu's, record for
// record: the same recorder and sweep read and write the records through
// their store, so the cotangents and the image are the local-array
// kernel's.
//
// Its record pass is the deep march (march_body.cuh: raymarch_deep), the
// recursive body's traversal on an explicit stack of 64 raymarch frames,
// so it also takes every refraction cap past 10 up to 64 (the local
// instances' chain of inlined levels stops at 10): the wrapper launches it
// for those at any lap count. Its image and records are the recursive
// body's wherever that one takes the cap.
//
// One instance, in a library of its own: the march backward's instances
// take three minutes of nvcc each, and this one compiles beside them. It
// is the textured body (it reads the atlas where the scene has one and is
// the untextured body, value for value, where it has none) and reads the
// tables from global memory (GLOBAL_TABLES, as the "_global" builds), which
// takes every scene size the forward takes.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_march_bwd.py).

#define RT_GLOBAL_TABLES
#include "bwd_kernel.cuh"
#include "march_bwd_body.cuh"

namespace {

struct MarchBufBody : rt::BwdFrame {
  static constexpr bool TEXTURED = true;
  template <class Acc>
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s,
                                               const rt::RecBuf<rt::MarchParams>& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, Acc& acc) {
    return rt::march_pixel_grad_buf<true>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// rt_march_bwd (march_bwd.cu) with the records of ``site_cap`` laps a pixel
// (any cap of at least 1) in ``buf``: 48 * site_cap words for each pixel of
// a band of ``band_rows`` x ``band_cols``, which the caller allocates and
// need not clear; the window runs band by band (rt::launch_bwd). Refraction
// caps past rt::MARCH_FRAMES_DEEP return cudaErrorInvalidValue.
int rt_march_bwd_buf(const float* f32t, const int* i32t, const float* cam, const float* light,
                     int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                     float sy, int refraction_cap, int bg, int max_laps, int max_iter, float eps,
                     float far_away, int glow_on, float glow, int floor_skip, float cutoff,
                     const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                     int tex_texels, const float* g_r, const float* g_g, const float* g_b,
                     float* out_block, float* prim_r, float* prim_g, float* prim_b,
                     int site_cap, unsigned* buf, int band_rows, int band_cols, int device,
                     void* stream) {
  if (site_cap < 1 || buf == nullptr || refraction_cap > rt::MARCH_FRAMES_DEEP)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::RecBuf<rt::MarchParams> p;
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
  p.buf = buf;
  p.cap = site_cap;
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  return rt::launch_bwd<MarchBufBody>(f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g, g_b,
                                      out_block, prim_r, prim_g, prim_b, device, stream,
                                      band_rows, band_cols);
}

const char* rt_error_string(int code) { return rt::error_string(code); }

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed).
void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

}  // extern "C"
