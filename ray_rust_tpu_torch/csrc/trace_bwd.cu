// Trace-mode backward (K2) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_grads_site
// (the body _make_site_bwd_kernel), textured sites included: from the packed
// scene tables and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image itself. The per-pixel program lives in
// trace_bwd_body.cuh.
//
// What bounds it: per-thread arithmetic, not bytes. It reads the tables and
// three f32 planes and writes an (n+1, 20) block and at most three planes,
// while each pixel re-runs the forward's raycasts (O(objects) each) and then
// walks its saved sites backwards. The frame (bwd_kernel.cuh) stages the
// tables in shared memory as the forward kernel does and sums each block's
// cotangents in a shared (n+1, 20) block before one global atomicAdd per
// nonzero entry.
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
// group sums its row with shuffles before its first lane adds it. The JAX
// kernel's pruned replay variants are not carried over: they let one
// lockstep TPU tile skip masked work, and a CUDA thread already walks only
// its own sites. Built with --fmad=false, as the forward kernel.
//
// The records are sized from the config: the kernel is built for each cap
// of rt::with_site_cap, and the wrapper launches the smallest cap at or
// above the config's site count. Its record pass runs the forward's task
// stack: 16 tasks, or 64 (DeepTraceBody) where max_reflections needs more
// (1 + R(R-1)/2 > 16, with more than 16 sites). The -DRT_GLOBAL_TABLES build
// (bwd_kernel.cuh) holds the same five instances. K1b's cull
// is not compiled in: the record pass scans every object, as the JAX
// kernel's does.
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
// atomicAdd per nonzero entry and group of lanes. The body that calls it is
// __host__ __device__, so are its methods; their intrinsics and atomics are
// compiled for the device only (the host build has its own accumulator).
struct WarpAcc {
  float* block;
  float cam[rt::CAM_GRADS] = {};  // this lane's camera and light cotangents

  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(&block[row * rt::GRAD_COLS + col], v);
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
    // lanes on: a shuffle-down tree over the group's ranks
    const unsigned above = peers & ~((2u << lane) - 1u);
    int next = above ? __ffs(above) - 1 : -1;
    const int group_max = __reduce_max_sync(mask, __popc(peers));
    for (int d = 1; d < group_max; d <<= 1) {
      const int src = next >= 0 ? next : static_cast<int>(lane);
#pragma unroll
      for (int k = 0; k < rt::F32_COLS; ++k) {
        const float v = __shfl_sync(mask, g[k], src);
        if (next >= 0) g[k] += v;
      }
      next = __shfl_sync(mask, next, src);
    }
    if ((peers & ((1u << lane) - 1u)) == 0) {  // the group's first lane
#pragma unroll
      for (int k = 0; k < rt::F32_COLS; ++k)
        if (g[k] != 0.0f) atomicAdd(&block[row * rt::GRAD_COLS + k], g[k]);
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
      float v = cam[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      cam[k] = v;
    }
    if (lane_id() == 0) {
#pragma unroll
      for (int k = 0; k < rt::CAM_GRADS; ++k)
        if (cam[k] != 0.0f) atomicAdd(&block[n * rt::GRAD_COLS + k], cam[k]);
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

// TraceBody with the deep task stack (max_reflections 7 to 11).
template <int CAP>
struct DeepTraceBody : TraceBody<CAP> {
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::Params& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, WarpAcc& acc) {
    return rt::trace_pixel_grad<CAP, rt::STACK_CAP_DEEP>(s, p, cutoff, cam, ix, iy, g, acc);
  }
};

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects and n_tex textures, in bytes.
size_t rt_trace_bwd_smem(int n, int n_tex) { return rt::bwd_smem(n, n_tex); }

// Launch the trace backward with room for ``site_cap`` sites a pixel (one
// of rt::with_site_cap's caps, else cudaErrorInvalidValue) on ``stream`` of
// ``device`` (rt::launch_bwd); the texture arguments as rt_trace_fwd's
// (trace_fwd.cu).
int rt_trace_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int max_reflections,
                 int refraction_cap, int bg, float cutoff, int site_cap, const void* tex,
                 const int* tex_meta, int n_tex, int tex_stride, int tex_len, const float* g_r,
                 const float* g_g, const float* g_b, float* out_block, float* prim_r,
                 float* prim_g, float* prim_b, int device, void* stream) {
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_len};
  const int r = max_reflections > 1 ? max_reflections : 1;
  const int tasks = 1 + r * (r - 1) / 2;  // and at most the sites: a task holds one
  if (tasks > rt::STACK_CAP_DEEP) return static_cast<int>(cudaErrorInvalidValue);
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

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
