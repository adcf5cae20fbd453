// Trace-mode backward (K2) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_grads_site
// (the body _make_site_bwd_kernel), textured sites included: from the packed
// scene tables and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image itself. The per-pixel program lives in
// trace_bwd_body.cuh. A launch covers a window of the frame at its global
// origin, as K1's does (bwd_kernel.cuh), so the multi-device layer
// differentiates a frame as windows.
//
// What bounds it: per-thread arithmetic, not bytes. It reads the tables and
// three f32 planes and writes an (n+1, 20) block and at most three planes,
// while each pixel re-runs the forward's raycasts (O(objects) each) and then
// walks its saved sites backwards. The frame (bwd_kernel.cuh) stages the
// tables in shared memory as the forward kernel does and sums each block's
// cotangents in a shared (n+1, 20) block before one global atomicAdd per
// nonzero entry, every sum across threads in 64-bit fixed point
// (fixed_sum.cuh), so a launch repeats itself bit for bit.
//
// The scatter into that block is K2's own (WarpAcc). At 1920x1080 a frame
// adds 13 entries a pixel, and the lanes of a warp mostly add to the same
// few entries: every pixel's 10 camera and light cotangents go to one row,
// and neighbouring pixels hit the same object. Added lane by lane, as the
// march backward and the re-trace still add (SharedAcc), those shared
// atomics queue up on one word, and they took 1.5 ms of K2's 1.79 ms on an
// H100 (PERF.md §6). So a warp sums first: each lane keeps its camera and
// light cotangents in registers until the frame's flush, where the warp
// reduces them with shuffles and one lane adds the 10 sums; at a hit, the
// lanes that arrive together group by winner (__match_any_sync) and each
// group sums its row with shuffles before its first lane adds it. Which
// lanes arrive together is the scheduler's, so each lane turns its terms
// into integers first and the shuffles sum integers. The JAX
// kernel's pruned replay variants are not carried over: they let one
// lockstep TPU tile skip masked work, and a CUDA thread already walks only
// its own sites. Built with --fmad=false, as the forward kernel.
//
// The records are sized from the config: the kernel is built for each cap
// of rt::with_site_cap, and the wrapper launches the smallest cap at or
// above the config's site count. Past the largest cap (192 sites: 7
// reflections at refraction_unroll=None need 319) rt_trace_bwd_buf launches
// BufTraceBody, whose records lie in a buffer in device memory
// (trace_bwd_body.cuh: RecBuf) that the wrapper sizes from the site count
// and a budget, launching the frame in row bands through the window so the
// buffer stays within it. Its record pass runs the forward's task stack: 16
// tasks, or 64 (DeepTraceBody, BufTraceBody<64>) where rt::stack_tasks
// needs more (a refraction cap past 17, with more than 16 sites). The
// -DRT_GLOBAL_TABLES build (bwd_kernel.cuh) holds the same seven instances.
// K1b's cull is not compiled in: the record pass scans every object, as the
// JAX kernel's does.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace_bwd.py).

#include "bwd_kernel.cuh"

namespace {

__device__ __forceinline__ unsigned lane_id() {
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// The warp-aggregated accumulator: the sums of a warp's lanes, one shared
// int64 atomicAdd per nonzero entry and group of lanes. Each lane turns its
// own terms into integers (rt::FixedTerms) and splits them into their two
// digits before any sum, so a group's shuffle tree sums integers, and
// whichever lanes arrive together the block gets the same sum; the hi
// digits (terms past the lo digit) take a tree of their own where a
// lane of the group has one. The body that calls it is __host__
// __device__, so are its methods; their intrinsics and atomics are compiled
// for the device only (the host build has its own accumulator).
struct WarpAcc : rt::FixedTerms {
  long long* block;
  float cam[rt::CAM_GRADS] = {};  // this lane's camera and light cotangents

  __host__ __device__ WarpAcc(long long* b, const rt::FixedTerms& t, int)
      : rt::FixedTerms(t), block(b) {}

  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    const int e = row * rt::GRAD_COLS + col;
    put(block, e, take(e, v));
#endif
  }

  // The lanes that call this together group by ``row``; each group sums
  // ``g`` over its lanes and its first lane adds the sum to the row.
  __host__ __device__ void add_row(int row, float (&g)[rt::F32_COLS]) {
#ifdef __CUDA_ARCH__
    const unsigned mask = __activemask();
    const unsigned peers = __match_any_sync(mask, row);
    const unsigned lane = lane_id();
    // the next lane of this lane's group, then (by doubling) the one d
    // lanes on: a shuffle-down tree over the group's ranks, its sources
    // (5 bits a step) and whether this lane adds at each step kept for the
    // 19 columns' sums
    const unsigned above = peers & ~((2u << lane) - 1u);
    int next = above ? __ffs(above) - 1 : -1;
    const int group_max = __reduce_max_sync(mask, __popc(peers));
    unsigned srcs = 0, adds = 0;
    int steps = 0;
    for (int d = 1; d < group_max; d <<= 1, ++steps) {
      const int src = next >= 0 ? next : static_cast<int>(lane);
      srcs |= static_cast<unsigned>(src) << (5 * steps);
      adds |= (next >= 0 ? 1u : 0u) << steps;
      next = __shfl_sync(mask, next, src);
    }
    const bool first = (peers & ((1u << lane) - 1u)) == 0;  // the group's first lane
#pragma unroll
    for (int k = 0; k < rt::F32_COLS; ++k) {
      const int e = row * rt::GRAD_COLS + k;
      const long long q = take(e, g[k]);
      if (!__any_sync(mask, q != 0)) continue;  // a column no lane of the group adds to
      long long lo = lo_digit(q), hi = hi_digit(q, lo);
      const bool his = __any_sync(mask, hi != 0);
      for (int j = 0; j < steps; ++j) {
        const int src = (srcs >> (5 * j)) & 31u;
        const long long v = __shfl_sync(mask, lo, src);
        const long long w = his ? __shfl_sync(mask, hi, src) : 0;
        if ((adds >> j) & 1u) {
          lo += v;
          hi += w;
        }
      }
      if (first && lo != 0) rt::add_digit(&block[e], lo);
      if (first && hi != 0) rt::add_digit(&this->hi[e], hi);
    }
#endif
  }

  // ``row`` is always the camera row n, where flush adds the warp's sums.
  __host__ __device__ void add_cam(int, const float (&g)[rt::CAM_GRADS]) {
#pragma unroll
    for (int k = 0; k < rt::CAM_GRADS; ++k) cam[k] += g[k];
  }

  // Every lane of the warp: the warp's camera and light sums to row n.
  __device__ void flush(int n) {
#pragma unroll
    for (int k = 0; k < rt::CAM_GRADS; ++k) {
      const int e = n * rt::GRAD_COLS + k;
      const long long q = take(e, cam[k]);
      long long lo = lo_digit(q), hi = hi_digit(q, lo);
      const bool his = __any_sync(0xffffffffu, hi != 0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, o);
        if (his) hi += __shfl_xor_sync(0xffffffffu, hi, o);
      }
      if (lane_id() == 0 && lo != 0) rt::add_digit(&block[e], lo);
      if (lane_id() == 0 && hi != 0) rt::add_digit(&this->hi[e], hi);
    }
  }
};

// The frame's launch shape (32x8 threads, two blocks an SM: 119 registers,
// no spills) with K2's own accumulator. In a sweep on an H100 (PERF.md §6)
// 32x8 at one to three blocks, 16x16 and 32x16 lay within 3% of each other
// at 1920x1080; four blocks (64 registers, spills) and 64x4, 32x4 or 32x2
// blocks were 8-34% slower.
template <int CAP>
struct TraceBody : rt::BwdFrame {
  static constexpr bool TEXTURED = true;
  using Acc = WarpAcc;
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::Params& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, WarpAcc& acc) {
    return rt::trace_pixel_grad<CAP>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

// TraceBody with the deep task stack (more than 16 tasks, rt::stack_tasks).
template <int CAP>
struct DeepTraceBody : TraceBody<CAP> {
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::Params& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, WarpAcc& acc) {
    return rt::trace_pixel_grad<CAP, rt::STACK_CAP_DEEP>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

// TraceBody with its records in the launch's buffer (any cap), its task
// stack of STACK tasks.
template <int STACK>
struct BufTraceBody : TraceBody<rt::STACK_CAP> {
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s,
                                               const rt::RecBuf<rt::Params>& p, float cutoff,
                                               const float* cam, int ix, int iy, rt::C3 g,
                                               WarpAcc& acc) {
    return rt::trace_pixel_grad_buf<STACK>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

rt::Params trace_params(int xres, int yres, int row0, int col0, int h, int w, float sx, float sy,
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

// Shared memory the launch needs for n objects and n_tex textures, in bytes.
size_t rt_trace_bwd_smem(int n, int n_tex) { return rt::bwd_smem(n, n_tex); }

// Launch the trace backward with room for ``site_cap`` sites a pixel (one
// of rt::with_site_cap's caps, else cudaErrorInvalidValue) on ``stream`` of
// ``device`` (rt::launch_bwd) over the window of rt_trace_fwd (trace_fwd.cu):
// rows row0 .. row0+h-1 and columns col0 .. col0+w-1 of the xres x yres
// frame, the cotangent and primal planes h x w (cudaErrorInvalidValue for a
// window with no pixel or past the frame); the texture arguments as
// rt_trace_fwd's.
int rt_trace_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                 float sy, int max_reflections, int refraction_cap, int bg, float cutoff,
                 int site_cap, const void* tex, const int* tex_meta, int n_tex, int tex_stride,
                 int tex_texels, const float* g_r, const float* g_g, const float* g_b,
                 float* out_block, float* prim_r, float* prim_g, float* prim_b, int device,
                 void* stream) {
  const rt::Params p = trace_params(xres, yres, row0, col0, h, w, sx, sy, max_reflections,
                                    refraction_cap, bg);
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  const int tasks = rt::stack_tasks(max_reflections, refraction_cap);
  if (tasks > rt::STACK_CAP_DEEP) return static_cast<int>(cudaErrorInvalidValue);
  // and at most the sites: a task holds one
  const bool deep = tasks > rt::STACK_CAP && site_cap > rt::STACK_CAP;
  const int rc = rt::with_site_cap(site_cap, [&](auto cap) {
    constexpr int C = decltype(cap)::value;
    if constexpr (C > rt::STACK_CAP) {
      if (deep)
        return rt::launch_bwd<DeepTraceBody<C>>(f32t, i32t, cam, light, n, p, tx, cutoff, g_r,
                                                g_g, g_b, out_block, prim_r, prim_g, prim_b,
                                                device, stream);
    }
    return rt::launch_bwd<TraceBody<C>>(f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g, g_b,
                                        out_block, prim_r, prim_g, prim_b, device, stream);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

// rt_trace_bwd with the records of ``site_cap`` sites a pixel (any cap of
// at least 1) in ``buf``: 26 * site_cap words for each pixel of a band of
// ``band_rows`` x ``band_cols`` (trace_bwd_body.cuh: RecBuf, rec_stores),
// which the caller allocates and need not clear; the window runs band by
// band (rt::launch_bwd).
int rt_trace_bwd_buf(const float* f32t, const int* i32t, const float* cam, const float* light,
                     int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                     float sy, int max_reflections, int refraction_cap, int bg, float cutoff,
                     int site_cap, const void* tex, const int* tex_meta, int n_tex,
                     int tex_stride, int tex_texels, const float* g_r, const float* g_g,
                     const float* g_b, float* out_block, float* prim_r, float* prim_g,
                     float* prim_b, unsigned* buf, int band_rows, int band_cols, int device,
                     void* stream) {
  rt::RecBuf<rt::Params> p;
  static_cast<rt::Params&>(p) = trace_params(xres, yres, row0, col0, h, w, sx, sy,
                                             max_reflections, refraction_cap, bg);
  p.buf = buf;
  p.cap = site_cap;
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_texels};
  const int tasks = rt::stack_tasks(max_reflections, refraction_cap);
  if (tasks > rt::STACK_CAP_DEEP || site_cap < 1 || buf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tasks > rt::STACK_CAP)
    return rt::launch_bwd<BufTraceBody<rt::STACK_CAP_DEEP>>(
        f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g, g_b, out_block, prim_r, prim_g,
        prim_b, device, stream, band_rows, band_cols);
  return rt::launch_bwd<BufTraceBody<rt::STACK_CAP>>(f32t, i32t, cam, light, n, p, tx, cutoff,
                                                     g_r, g_g, g_b, out_block, prim_r, prim_g,
                                                     prim_b, device, stream, band_rows,
                                                     band_cols);
}

const char* rt_error_string(int code) { return rt::error_string(code); }

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed).
void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

}  // extern "C"
