// Re-trace gradient oracle (K5) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads (the
// body _make_bwd_kernel): from the packed scene tables of an untextured
// trace-mode scene and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image, by differentiating a re-trace of each
// pixel. It is the second, independent derivation of what the trace
// backward (K2, trace_bwd.cu) computes by replaying recorded sites, and the
// oracle K2 is held against at full size. The per-pixel program lives in
// trace_retrace_body.cuh: the forward's float trace, which gives the image
// and the pixel's winners, then the forward's own trace body in
// forward-mode numbers (dual.cuh) over the pixel's live entries,
// RETRACE_LANES of them a pass. One launch computes the whole cotangent.
//
// The JAX kernel's tile probe (_probe_case) and its three pre-differentiated
// program variants exist to skip a tile's dead work under a SIMD tile's
// shared control flow; a CUDA thread already stops at its own last bounce
// and its own last sub-trace, so they have no counterpart here.
//
// What bounds it: per-thread arithmetic. A Dual pass re-runs the forward's
// traversal with every value carrying L tangents (a product costs 1 + 3L
// operations), its task stack of Dual rays in local memory, and a warp runs
// as long as its longest lane. So the design cuts the passes: a pixel's
// trace reads seeded entries only at its winners' rows, the camera row and
// the light, and seeding only those 10 + 19 w entries (w winners), not all
// 19 N + 10, takes the default scene at 1920x1080 from 53 passes a pixel to
// 12.0 on average, 12.3 for a warp's longest lane (the host counts, PERF.md
// §6).
//
// The scatter is K5's own (RetraceAcc), so a fault in K2's cannot reach its
// oracle. The camera's and the light's 10 entries come once a pixel: each
// thread stores them in its own slot of a shared staging array, which the
// frame's flush sums over the block without atomics. The objects' entries
// go to the frame's shared (n+1, 20) block: where the lanes of a pass all
// add to one entry (__match_all_sync), a shuffle sum and one shared
// atomicAdd, else one per lane. Every term is a 64-bit fixed-point integer
// before it is summed (fixed_sum.cuh), so the sums are the same whichever
// lanes arrive together. Lane by lane those adds took 1.4 of 4.7 ms
// on an H100; summed first, 0.23 of 3.5 ms (PERF.md §6). The frame is the
// one the backwards share (bwd_kernel.cuh): tables in shared memory, one
// global atomic per nonzero entry a block. The launch shape is the frame's,
// 32x8 threads and two blocks an SM: at 128 registers with 8 bytes of
// spills, with two lanes, it beat one block (143 registers) and three (80,
// with spills) and every shape at one or four lanes. Built with --fmad=false, as the forward kernel, so
// the value pass is the forward's image bit for bit. Both traversals run
// the forward's task stack: 16 tasks, or 64 (RetraceBody<64>) where
// rt::stack_tasks needs more, as K1 and K2 pick theirs.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace_retrace.py).

#include "bwd_kernel.cuh"
#include "trace_retrace_body.cuh"

namespace {

constexpr int THREADS = rt::BwdFrame::BLOCK_X * rt::BwdFrame::BLOCK_Y;

// The block's camera and light cotangents, one slot a thread and entry, as
// the thread's fixed-point digits (lo, then hi).
__shared__ long long scene_stage[2 * rt::SCENE_ENTRIES * THREADS];

// K5's accumulator: object entries into the shared block, the camera and
// light entries staged per thread and summed at the flush. Each thread
// turns its own terms into integers (rt::FixedTerms) and splits them into
// their two digits before any sum, so the sums are the same whichever lanes
// arrive together. The body that calls it is __host__ __device__, so are
// its methods; their shared memory, warp intrinsics and atomics are
// compiled for the device only.
struct RetraceAcc : rt::FixedTerms {
  long long* block;
  int n;

  __host__ __device__ static int tid() {
#ifdef __CUDA_ARCH__
    return threadIdx.y * blockDim.x + threadIdx.x;
#else
    return 0;
#endif
  }

#ifdef __CUDA_ARCH__
  // The sum of v over the lanes of ``active`` (any set of lanes), in its
  // first lane: each lane adds the partial sum of the lane after it, whose
  // pointer then jumps twice as far, so ceil(log2 n) shuffles for n lanes.
  __device__ static long long sum_lanes(unsigned active, long long v) {
    const unsigned lane = tid() & 31;
    const unsigned after = active & ~((2u << lane) - 1u);
    int next = after ? __ffs(after) - 1 : -1;
    const int cnt = __popc(active);
    for (int d = 1; d < cnt; d <<= 1) {
      const int src = next >= 0 ? next : static_cast<int>(lane);
      const long long w = __shfl_sync(active, v, src);
      const int jump = __shfl_sync(active, next, src);
      if (next >= 0) {
        v += w;
        next = jump;
      }
    }
    return v;
  }
#endif

  // A thread outside the image stages zeros.
  __host__ __device__ RetraceAcc(long long* b, const rt::FixedTerms& t, int rows)
      : rt::FixedTerms(t), block(b), n(rows) {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int e = 0; e < 2 * rt::SCENE_ENTRIES; ++e) scene_stage[e * THREADS + tid()] = 0;
#endif
  }

  // Every lane of a pass calls it, zero or not. Where the lanes that arrive
  // together all add to one entry (a warp inside one object's pixels), they
  // sum over the warp first and one lane adds; otherwise each adds its own.
  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    const int entry = row * rt::GRAD_COLS + col;
    const long long q = take(entry, v);
    const unsigned active = __activemask();
    int uniform;
    __match_all_sync(active, entry, &uniform);
    if (uniform) {
      long long lo = lo_digit(q), h = hi_digit(q, lo);
      lo = sum_lanes(active, lo);
      if (__any_sync(active, h != 0)) h = sum_lanes(active, h);
      const bool first = (active & ((1u << (tid() & 31)) - 1u)) == 0;
      if (first && lo != 0) rt::add_digit(&block[entry], lo);
      if (first && h != 0) rt::add_digit(&hi[entry], h);
    } else {
      put(block, entry, q);
    }
#endif
  }

  // Local entry e < SCENE_ENTRIES, once a pixel.
  __host__ __device__ void add_scene(int e, float v) {
#ifdef __CUDA_ARCH__
    const long long q = take(n * rt::GRAD_COLS + e, v), lo = lo_digit(q);
    scene_stage[e * THREADS + tid()] = lo;
    scene_stage[(rt::SCENE_ENTRIES + e) * THREADS + tid()] = hi_digit(q, lo);
#endif
  }

  // Every thread of the block: each warp sums the staged slots of its
  // entries over the block and one lane adds the sums to row n.
  __device__ void flush(int) {
    __syncthreads();
    const int lane = tid() & 31;
    for (int e = tid() >> 5; e < rt::SCENE_ENTRIES; e += THREADS / 32) {
      long long lo = 0, h = 0;
#pragma unroll
      for (int j = lane; j < THREADS; j += 32) {
        lo += scene_stage[e * THREADS + j];
        h += scene_stage[(rt::SCENE_ENTRIES + e) * THREADS + j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, o);
        h += __shfl_xor_sync(0xffffffffu, h, o);
      }
      if (lane == 0) {
        block[n * rt::GRAD_COLS + e] += lo;
        if (h != 0) rt::add_digit(&hi[n * rt::GRAD_COLS + e], h);
      }
    }
  }
};

// The frame's launch shape (32x8 threads, two blocks an SM: the lane and
// shape sweep's best, PERF.md §6) with K5's own accumulator.
// STACK: the task stack of both traversals, rt::STACK_CAP or, where
// rt::stack_tasks needs more, rt::STACK_CAP_DEEP.
template <int STACK>
struct RetraceBody : rt::BwdFrame {
  static constexpr bool TEXTURED = false;
  using Acc = RetraceAcc;
  __device__ __forceinline__ static rt::C3 run(const rt::SceneView& s, const rt::Params& p,
                                               float cutoff, const float* cam, int ix, int iy,
                                               rt::C3 g, RetraceAcc& acc) {
    unsigned long long winners;
    return rt::retrace_pixel<rt::RETRACE_LANES, STACK>(s, p, cutoff, cam, ix, iy, g, acc,
                                                       winners);
  }
};
static_assert(rt::BwdFrame::BLOCK_X * rt::BwdFrame::BLOCK_Y == THREADS,
              "one stage slot a thread");

}  // namespace

extern "C" {

// Tangent lanes of one Dual pass.
int rt_trace_retrace_lanes() { return rt::RETRACE_LANES; }

// Launch the re-trace gradient, every entry of the block in one launch, on
// ``stream`` of ``device`` (rt::launch_bwd); the render arguments and the
// cutoff as rt_trace_bwd's (trace_bwd.cu), without textures.
int rt_trace_retrace(const float* f32t, const int* i32t, const float* cam, const float* light,
                     int n, int xres, int yres, float sx, float sy, int max_reflections,
                     int refraction_cap, int bg, float cutoff, const float* g_r,
                     const float* g_g, const float* g_b, float* out_block, float* prim_r,
                     float* prim_g, float* prim_b, int device, void* stream) {
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.h = yres;  // the whole frame (rt::launch_bwd's window)
  p.w = xres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  const rt::TexArgs tx = {nullptr, nullptr, 0, 0, 0};
  const int tasks = rt::stack_tasks(max_reflections, refraction_cap);
  if (tasks > rt::STACK_CAP_DEEP) return static_cast<int>(cudaErrorInvalidValue);
  if (tasks > rt::STACK_CAP)
    return rt::launch_bwd<RetraceBody<rt::STACK_CAP_DEEP>>(f32t, i32t, cam, light, n, p, tx,
                                                           cutoff, g_r, g_g, g_b, out_block,
                                                           prim_r, prim_g, prim_b, device,
                                                           stream);
  return rt::launch_bwd<RetraceBody<rt::STACK_CAP>>(f32t, i32t, cam, light, n, p, tx, cutoff,
                                                    g_r, g_g, g_b, out_block, prim_r, prim_g,
                                                    prim_b, device, stream);
}

const char* rt_error_string(int code) { return rt::error_string(code); }

// The last launch's fixed-point scale, counts and split (fixed_sum.cuh:
// last_fixed).
void rt_fixed_stats(int* out) {
  for (int k = 0; k < rt::FIXED_STATS; ++k) out[k] = rt::last_fixed()[k];
}

}  // extern "C"
