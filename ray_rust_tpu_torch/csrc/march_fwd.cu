// March-mode forward with glow for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_march.py:render_color_pallas_march (the
// body _make_kernel): it computes the same image, written afresh for the
// card. The per-pixel program lives in march_body.cuh; it shares vectors,
// the sky, uv maps, patterns, the normal and the camera ray with the trace
// kernel's body (trace_body.cuh).
//
// What bounds it: its slowest thread's serial SDF steps, not bytes or total
// work. A 720p image is 11 MB of output and the scene 92 B an object, while a
// pixel runs its marches one O(objects) sweep after another, and a block
// holds its SM slot until its last warp ends. With every march stepped, a
// horizon-grazing ray crawls to the 10 000-step cap (10 209 object passes for
// the longest 720p pixel), so the kernel's time barely grows with the pixel
// count. Two shortcuts of the JAX kernel cut that chain (march_body.cuh): the
// closed-form floor tail, which resolves a floor-won march's remaining steps
// at once, stall of the reference's f32 update included, and the
// never-converges shortcut, which ends a shadow march that no object can stop
// before its first step; the longest 720p pixel then takes 2 311 passes, a
// ray that crawls along a mirror sphere's rim. The design is otherwise
// simple: the object tables are staged in shared memory once per block (every
// thread of a warp reads the same row at once, a broadcast; tables too large
// for the launch shape's share of an SM are read from the pack kernel's words
// through the read-only path instead, in the -DRT_GLOBAL_TABLES build,
// ops/kernel_march.py: SHARED_TABLE_MAX), each thread runs its own march
// loops, and the refraction recursion is a chain of template instances, one
// per depth, inlined into one program. A textured hit (the JAX package's jnp
// path: its march kernel declines textures, pallas_march.py:60-73) reads the
// texture atlas as K1 does: the meta rows in shared memory beside the tables, one 16-byte
// read-only load a texel from global memory. Not carried over: the
// tile-wide while loop and tile skip, and the ray-parametric step form
// (pallas_march.py:85-97,127-147), which rounds differently and only saves
// arithmetic; warps diverge where their pixels' step counts differ. Built
// with --fmad=false, so each product and sum rounds on its own as in the
// plain PyTorch version (ops/trace.py:raymarch); with march_floor_skip off
// the kernel is that version bit for bit.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_march.py).

#include <cuda_runtime.h>

#include "march_body.cuh"

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
march_fwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
                 const float* __restrict__ cam, const float* __restrict__ light,
                 int n, rt::MarchParams p, rt::TexArgs tx, float* __restrict__ out_r,
                 float* __restrict__ out_g, float* __restrict__ out_b) {
  constexpr bool GLOBAL = rt::GLOBAL_TABLES;
  extern __shared__ float smem[];
  const int n_tab = GLOBAL ? 0 : n;  // objects staged in shared memory
  float* s_f32 = smem;
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n_tab * rt::F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n_tab * rt::I32_COLS);
  float* s_light = s_cam + rt::CAM_COLS;
  int* s_meta = reinterpret_cast<int*>(s_light + rt::LIGHT_COLS);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if constexpr (!GLOBAL) {
    for (int k = tid; k < n * rt::F32_COLS; k += nthreads) s_f32[k] = f32t[k];
    for (int k = tid; k < n * rt::I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  }
  if (tid < rt::CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < rt::LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < tx.n_tex * rt::TEX_META_COLS; k += nthreads) s_meta[k] = tx.meta[k];
  __syncthreads();

  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= p.xres || iy >= p.yres) return;

  rt::SceneView s;
  s.f32 = GLOBAL ? f32t : s_f32;
  s.i32 = GLOBAL ? i32t : s_i32;
  s.n = n;
  s.light = rt::v3(s_light[0], s_light[1], s_light[2]);
  s.tx = tx;
  s.tx.meta = s_meta;
  rt::C3 c = rt::march_pixel(s, p, s_cam, ix, iy);
  const size_t o = static_cast<size_t>(iy) * p.xres + ix;
  out_r[o] = c.r;
  out_g[o] = c.g;
  out_b[o] = c.b;
}

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects and n_tex textures, in bytes
// (the tables in the shared-table build only).
size_t rt_march_fwd_smem(int n, int n_tex) {
  const int n_tab = rt::GLOBAL_TABLES ? 0 : n;
  return sizeof(float) * (n_tab * rt::F32_COLS + rt::CAM_COLS + rt::LIGHT_COLS) +
         sizeof(int) * (n_tab * rt::I32_COLS + n_tex * rt::TEX_META_COLS);
}

// Launch the march forward on ``stream`` of ``device``; returns the
// cudaError_t of the launch (0 = success). The texture arguments are
// rt_trace_fwd's (trace_fwd.cu): null and zeros for an untextured scene.
int rt_march_fwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int refraction_cap, int bg,
                 int max_laps, int max_iter, float eps, float far_away, int glow_on,
                 float glow, int floor_skip, const void* tex, const int* tex_meta, int n_tex,
                 int tex_stride, int tex_len, float* out_r, float* out_g, float* out_b,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = rt_march_fwd_smem(n, n_tex);
  if (smem > 48 * 1024) {  // above 48 KB a block may take dynamic shared memory only when asked
    err = cudaFuncSetAttribute(march_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const rt::TexArgs tx = {static_cast<const rt::Texel4*>(tex), tex_meta, n_tex, tex_stride,
                          tex_len};
  rt::MarchParams p;
  p.xres = xres;
  p.yres = yres;
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
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((xres + BLOCK_X - 1) / BLOCK_X, (yres + BLOCK_Y - 1) / BLOCK_Y);
  march_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      f32t, i32t, cam, light, n, p, tx, out_r, out_g, out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
