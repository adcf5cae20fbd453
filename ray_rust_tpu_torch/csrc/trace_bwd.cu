// Trace-mode backward (K2) for Hopper (sm_90a), one thread per pixel.
//
// Replaces ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_grads_site
// (the body _make_site_bwd_kernel) for untextured scenes: from the packed
// scene tables and the cotangent planes of the image it computes the
// cotangent of every object's 19 table columns and of the camera and the
// light, and optionally the image itself. The per-pixel program lives in
// trace_bwd_body.cuh.
//
// What bounds it: per-thread arithmetic and local memory, not bytes. It
// reads the tables and three f32 planes and writes an (n+1, 20) block and
// at most three planes, while each pixel re-runs the forward's raycasts
// (O(objects) each) and then walks up to SITE_CAP saved sites backwards.
// The design is simple and right, not fast: the tables sit in shared memory
// as in the forward kernel; each block sums its cotangents in a shared
// (n+1, 20) block with shared-memory atomics, then adds it to the global
// block with one atomicAdd per nonzero entry, so a 1080p frame takes ~8k
// global atomics per entry rather than one per pixel, site and field. The
// summation order therefore changes from run to run. A warp-level reduction
// before the shared atomics, and the JAX kernel's pruned replay variants,
// are later work. Built with --fmad=false, as the forward kernel.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_trace_bwd.py).

#include <cuda_runtime.h>

#include "trace_bwd_body.cuh"

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// The block's shared accumulator, as trace_pixel_grad adds to it.
struct SharedAcc {
  float* block;
  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(&block[row * rt::GRAD_COLS + col], v);
#endif
  }
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_bwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
                 const float* __restrict__ cam, const float* __restrict__ light, int n,
                 rt::Params p, float cutoff, const float* __restrict__ g_r,
                 const float* __restrict__ g_g, const float* __restrict__ g_b,
                 float* __restrict__ out_block, float* __restrict__ prim_r,
                 float* __restrict__ prim_g, float* __restrict__ prim_b) {
  extern __shared__ float smem[];
  float* s_f32 = smem;
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n * rt::F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n * rt::I32_COLS);
  float* s_light = s_cam + rt::CAM_COLS;
  float* s_acc = s_light + rt::LIGHT_COLS;
  const int acc_len = (n + 1) * rt::GRAD_COLS;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < n * rt::F32_COLS; k += nthreads) s_f32[k] = f32t[k];
  for (int k = tid; k < n * rt::I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  if (tid < rt::CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < rt::LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < acc_len; k += nthreads) s_acc[k] = 0.0f;
  __syncthreads();

  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix < p.xres && iy < p.yres) {  // every thread reaches the barrier below
    rt::SceneView s;
    s.f32 = s_f32;
    s.i32 = s_i32;
    s.n = n;
    s.light = rt::v3(s_light[0], s_light[1], s_light[2]);
    const size_t o = static_cast<size_t>(iy) * p.xres + ix;
    SharedAcc acc = {s_acc};
    rt::C3 c = rt::trace_pixel_grad(s, p, cutoff, s_cam, ix, iy,
                                    rt::c3(g_r[o], g_g[o], g_b[o]), acc);
    if (prim_r != nullptr) {
      prim_r[o] = c.r;
      prim_g[o] = c.g;
      prim_b[o] = c.b;
    }
  }
  __syncthreads();
  for (int k = tid; k < acc_len; k += nthreads) {
    const float v = s_acc[k];
    if (v != 0.0f) atomicAdd(&out_block[k], v);
  }
}

}  // namespace

extern "C" {

// Shared memory the launch needs for n objects, in bytes: the tables and
// the block's accumulator.
size_t rt_trace_bwd_smem(int n) {
  return sizeof(float) * (n * rt::F32_COLS + rt::CAM_COLS + rt::LIGHT_COLS +
                          (n + 1) * rt::GRAD_COLS) +
         sizeof(int) * n * rt::I32_COLS;
}

// Launch the trace backward on ``stream`` of ``device``. ``out_block`` is
// (n+1, 20) f32 and must hold zeros; the cotangents are added to it. The
// primal planes may be null. Returns the cudaError_t of the launch
// (0 = success).
int rt_trace_bwd(const float* f32t, const int* i32t, const float* cam, const float* light,
                 int n, int xres, int yres, float sx, float sy, int max_reflections,
                 int refraction_cap, int bg, float cutoff, const float* g_r, const float* g_g,
                 const float* g_b, float* out_block, float* prim_r, float* prim_g,
                 float* prim_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = rt_trace_bwd_smem(n);
  // above 48 KB a block may take dynamic shared memory only when asked
  err = cudaFuncSetAttribute(trace_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  trace_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      f32t, i32t, cam, light, n, p, cutoff, g_r, g_g, g_b, out_block, prim_r, prim_g, prim_b);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
