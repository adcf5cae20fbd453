// Fused Whitted trace forward for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_trace.py:render_color_pallas (the body
// _make_kernel): it computes the same image, written afresh for the card
// rather than carried over tile by tile. The per-pixel program lives in
// trace_body.cuh.
//
// What bounds it: per-thread arithmetic and divergence, not bytes. A 1080p
// image is 24 MB of output and the scene 92 B an object, while each pixel
// runs a data-dependent tree of bounces, shadow rays and refraction
// sub-traces, each an O(objects) scan. The design is simple and right, not
// fast: the object tables and the texture meta rows are staged in shared
// memory once per block (the raycast reads the same row in every thread, a
// broadcast; the hit gather reads one row per thread), each thread branches
// on its own hits, and the refraction recursion is an explicit per-thread
// stack. Tables too large for the launch shape's share of an SM's shared
// memory (ops/kernel_trace.py: SHARED_TABLE_MAX objects) are read where the
// pack kernel wrote them, through the read-only path, by the kernels of a
// second build (-DRT_GLOBAL_TABLES, trace_body.cuh: GLOBAL_TABLES); nothing
// else changes. That build also reads the meta rows of a bank past
// TEXTURE_MAX = 1 024 textures where the pack wrote them (staged_meta), and
// the wrappers launch it for such a bank at any object count.
//
// K1b, the per-tile object cull (ray_rust_tpu/ops/pallas_trace.py:
// _build_candidates): in the instances that take it (CULL, launched above 64
// objects with RenderConfig.pallas_prefilter) the block is the tile. After
// the tables are staged each warp tests 32 objects at a time
// (trace_body.cuh: cull_object) and writes one __ballot_sync word of each
// of the tile's two candidate masks to shared memory, ceil(n/32) words
// each: index order for free, n/4 bytes a block, no prefix sum. The root
// trace's first raycast and its shadow ray then scan only their mask's set
// bits (trace_body.cuh: nearest_in), which gives the full scan's image bit
// for bit. A task stack of 64, where a refraction cap past 17 needs more
// than 16 tasks (trace_body.cuh: stack_tasks), is a second template
// argument (STACK). The texture atlas (K1a; 1 MB for one 256x256 texture)
// stays in global memory: a textured hit reads its texel's four taps in one
// 16-byte read-only load, and neighbouring pixels of a floor read
// neighbouring texels, which the L1 and L2 caches serve.
// A launch renders a window of the frame at its global origin (Params:
// row0, col0, h, w; the whole frame is 0, 0, yres, xres), as the JAX
// kernel's origin= and shape= do: the grid covers the window exactly and
// masks its ragged edge (there is no padding), the output planes are the
// window's, and the camera rays and K1b's tiles take global pixels, so the
// window is the whole frame's launch bit for bit. Built with --fmad=false,
// so each product and sum rounds on its own as in the plain PyTorch version
// (ops/trace.py); a later change may allow contraction for speed.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace.py).

#include <cuda_runtime.h>

#include "trace_body.cuh"

namespace {

// The launch shape: blocks of 16x16 pixels, five blocks an SM (48
// registers, 20 bytes of spill stores). On an H100 at 1920x1080 it beat
// the first design's 32x8 at four blocks an SM (60 registers, no spills)
// by 3.5% in turns, and 32x4, six blocks an SM and a task stack of 4 (the
// default config's need) by less or not at all (PERF.md §6). The block is
// also K1b's tile.
constexpr int BLOCK_X = rt::CULL_TILE;
constexpr int BLOCK_Y = rt::CULL_TILE;
constexpr int BLOCKS_PER_SM = 5;

template <bool CULL, int STACK>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, BLOCKS_PER_SM)
trace_fwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
                 const float* __restrict__ cam, const float* __restrict__ light,
                 int n, rt::Params p, rt::TexArgs tx, float* __restrict__ out_r,
                 float* __restrict__ out_g, float* __restrict__ out_b) {
  constexpr bool GLOBAL = rt::GLOBAL_TABLES;
  extern __shared__ float smem[];
  const int n_tab = GLOBAL ? 0 : n;  // objects staged in shared memory
  float* s_f32 = smem;
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n_tab * rt::F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n_tab * rt::I32_COLS);
  float* s_light = s_cam + rt::CAM_COLS;
  int* s_meta = reinterpret_cast<int*>(s_light + rt::LIGHT_COLS);
  const int n_meta = rt::staged_meta(tx.n_tex);  // meta rows staged in shared memory
  const int words = (n + 31) >> 5;
  unsigned* s_prim = reinterpret_cast<unsigned*>(s_meta + n_meta * rt::TEX_META_COLS);
  unsigned* s_shadow = s_prim + words;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if constexpr (!GLOBAL) {
    for (int k = tid; k < n * rt::F32_COLS; k += nthreads) s_f32[k] = f32t[k];
    for (int k = tid; k < n * rt::I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  }
  if (tid < rt::CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < rt::LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < n_meta * rt::TEX_META_COLS; k += nthreads) s_meta[k] = tx.meta[k];
  __syncthreads();

  rt::SceneView s;
  s.f32 = GLOBAL ? f32t : s_f32;
  s.i32 = GLOBAL ? i32t : s_i32;
  s.n = n;
  s.light = rt::v3(s_light[0], s_light[1], s_light[2]);
  s.tx = tx;
  if (n_meta == tx.n_tex) s.tx.meta = s_meta;
  rt::FwdRecord<CULL, STACK> rec;
  if constexpr (CULL) {  // K1b: the block's candidate masks, a warp a word
    const rt::CullTile ct = rt::cull_tile(p, s_cam, s.light, p.col0 + blockIdx.x * BLOCK_X,
                                          p.row0 + blockIdx.y * BLOCK_Y, BLOCK_X, BLOCK_Y);
    const int lane = tid & 31;
    for (int w = tid >> 5; w < words; w += nthreads >> 5) {  // whole warps: w is the warp's
      const int i = (w << 5) + lane;
      bool a = false, b = false;
      if (i < n) rt::cull_object(ct, s.f32 + i * rt::F32_COLS, s.i32[i * rt::I32_COLS], &a, &b);
      const unsigned wa = __ballot_sync(0xffffffffu, a), wb = __ballot_sync(0xffffffffu, b);
      if (lane == 0) {
        s_prim[w] = wa;
        s_shadow[w] = wb;
      }
    }
    __syncthreads();
    rec.prim = s_prim;
    rec.shadow = s_shadow;
  }

  const int lx = blockIdx.x * blockDim.x + threadIdx.x;  // the pixel in the window
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= p.w || ly >= p.h) return;
  rt::C3 c = rt::trace_pixel(s, p, s_cam, p.col0 + lx, p.row0 + ly, rec);
  const size_t o = static_cast<size_t>(ly) * p.w + lx;
  out_r[o] = c.r;
  out_g[o] = c.g;
  out_b[o] = c.b;
}

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects and n_tex textures, in bytes:
// the tables (in the shared-table build), the camera, the light, the meta
// rows it stages (rt::staged_meta), and with ``cull`` the two candidate
// masks.
size_t rt_trace_fwd_smem(int n, int n_tex, int cull) {
  const int n_tab = rt::GLOBAL_TABLES ? 0 : n;
  return sizeof(float) * (n_tab * rt::F32_COLS + rt::CAM_COLS + rt::LIGHT_COLS) +
         sizeof(int) * (n_tab * rt::I32_COLS + rt::staged_meta(n_tex) * rt::TEX_META_COLS) +
         (cull ? 2 * sizeof(unsigned) * ((n + 31) / 32) : 0);
}

// Launch the trace forward on ``stream`` of ``device``; returns the
// cudaError_t of the launch (0 = success). The frame is xres x yres; the
// launch renders its rows row0 .. row0+h-1 and columns col0 .. col0+w-1
// into h x w output planes. ``tex`` is the atlas of n_tex textures of
// ``tex_texels`` 16-byte texels each (Hmax * Wmax; the atlas may pass 2^31
// texels), ``tex_stride`` a row, and ``tex_meta`` its (n_tex, 4) table; null and zeros for an untextured scene. ``cull`` takes
// K1b's per-tile cull. The task stack holds 16 tasks where
// rt::stack_tasks(max_reflections, refraction_cap) is 16 or less, else 64,
// in either build; past 64 the launch returns cudaErrorInvalidValue.
int rt_trace_fwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, int row0, int col0, int h, int w, float sx,
                 float sy, int max_reflections, int refraction_cap, int bg, const void* tex,
                 const int* tex_meta, int n_tex, int tex_stride, int tex_texels, int cull,
                 float* out_r, float* out_g, float* out_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tasks = rt::stack_tasks(max_reflections, refraction_cap);
  if (tasks > rt::STACK_CAP_DEEP) return static_cast<int>(cudaErrorInvalidValue);
  const bool deep = tasks > rt::STACK_CAP;
  const size_t smem = rt_trace_fwd_smem(n, n_tex, cull);
  rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride, tex_texels};
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
  constexpr int D = rt::STACK_CAP_DEEP;
  constexpr int S = rt::STACK_CAP;
  auto kernel = deep ? (cull ? &trace_fwd_kernel<true, D> : &trace_fwd_kernel<false, D>)
                     : (cull ? &trace_fwd_kernel<true, S> : &trace_fwd_kernel<false, S>);
  if (smem > 48 * 1024) {  // above 48 KB a block may take dynamic shared memory only when asked
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((w + BLOCK_X - 1) / BLOCK_X, (h + BLOCK_Y - 1) / BLOCK_Y);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(f32t, i32t, cam, light, n, p,
                                                                    tx, out_r, out_g, out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
