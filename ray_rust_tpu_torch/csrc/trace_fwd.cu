// Fused Whitted trace forward for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_trace.py:render_color_pallas (the body
// _make_kernel): it computes the same image, written afresh for the card
// rather than carried over tile by tile. The per-pixel program lives in
// trace_body.cuh.
//
// What bounds it: per-thread arithmetic and divergence, not bytes. A 1080p
// image is 24 MB of output and the scene at most 512 objects * 92 B = 47 KB,
// while each pixel runs a data-dependent tree of bounces, shadow rays and
// refraction sub-traces, each an O(objects) scan. The design is simple and
// right, not fast: the object tables and the texture meta rows are staged in
// shared memory once per block (the raycast reads the same row in every
// thread, a broadcast; the hit gather reads one row per thread), each thread
// branches on its own hits, and the refraction recursion is an explicit
// per-thread stack. The texture atlas (K1a; 1 MB for one 256x256 texture)
// stays in global memory: a textured hit reads its texel's four taps in one
// 16-byte read-only load, and neighbouring pixels of a floor read
// neighbouring texels, which the L1 and L2 caches serve.
// The grid covers (H, W) exactly and masks the ragged edge; there is no
// padding. Built with --fmad=false, so each product and sum rounds on its
// own as in the plain PyTorch version (ops/trace.py); a later change may
// allow contraction for speed.
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
// default config's need) by less or not at all (PERF.md §6).
constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 16;
constexpr int BLOCKS_PER_SM = 5;

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, BLOCKS_PER_SM)
trace_fwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
                 const float* __restrict__ cam, const float* __restrict__ light,
                 int n, rt::Params p, rt::TexArgs tx, float* __restrict__ out_r,
                 float* __restrict__ out_g, float* __restrict__ out_b) {
  extern __shared__ float smem[];
  float* s_f32 = smem;
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n * rt::F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n * rt::I32_COLS);
  float* s_light = s_cam + rt::CAM_COLS;
  int* s_meta = reinterpret_cast<int*>(s_light + rt::LIGHT_COLS);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < n * rt::F32_COLS; k += nthreads) s_f32[k] = f32t[k];
  for (int k = tid; k < n * rt::I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  if (tid < rt::CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < rt::LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < tx.n_tex * rt::TEX_META_COLS; k += nthreads) s_meta[k] = tx.meta[k];
  __syncthreads();

  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= p.xres || iy >= p.yres) return;

  rt::SceneView s;
  s.f32 = s_f32;
  s.i32 = s_i32;
  s.n = n;
  s.light = rt::v3(s_light[0], s_light[1], s_light[2]);
  s.tx = tx;
  s.tx.meta = s_meta;
  rt::C3 c = rt::trace_pixel(s, p, s_cam, ix, iy);
  const size_t o = static_cast<size_t>(iy) * p.xres + ix;
  out_r[o] = c.r;
  out_g[o] = c.g;
  out_b[o] = c.b;
}

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects and n_tex textures, in bytes.
size_t rt_trace_fwd_smem(int n, int n_tex) {
  return sizeof(float) * (n * rt::F32_COLS + rt::CAM_COLS + rt::LIGHT_COLS) +
         sizeof(int) * (n * rt::I32_COLS + n_tex * rt::TEX_META_COLS);
}

// Launch the trace forward on ``stream`` of ``device``; returns the
// cudaError_t of the launch (0 = success). ``tex`` is the atlas of
// ``tex_len`` 16-byte texels, ``tex_stride`` a row, and ``tex_meta`` its
// (n_tex, 4) table; null and zeros for an untextured scene.
int rt_trace_fwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int max_reflections,
                 int refraction_cap, int bg, const void* tex, const int* tex_meta, int n_tex,
                 int tex_stride, int tex_len, float* out_r, float* out_g, float* out_b,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = rt_trace_fwd_smem(n, n_tex);
  if (smem > 48 * 1024) {  // above 48 KB a block may take dynamic shared memory only when asked
    err = cudaFuncSetAttribute(trace_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride, tex_len};
  rt::Params p;
  p.xres = xres;
  p.yres = yres;
  p.sx = sx;
  p.sy = sy;
  p.max_reflections = max_reflections;
  p.refraction_cap = refraction_cap;
  p.bg = bg;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((xres + BLOCK_X - 1) / BLOCK_X, (yres + BLOCK_Y - 1) / BLOCK_Y);
  trace_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      f32t, i32t, cam, light, n, p, tx, out_r, out_g, out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
