// The frame the gradient kernels share (trace_bwd.cu, march_bwd.cu and the
// re-trace oracle trace_retrace.cu): one thread per pixel, the scene tables
// staged in shared memory, each pixel's cotangents summed into a shared
// (n+1, 20) block through the body's accumulator, then the block added to
// the global one with one atomicAdd per nonzero entry, so a frame takes one
// global atomic per entry per block rather than one per pixel, site and
// field, and the summation order changes from run to run. Dynamic shared
// memory above 48 KB is asked for. In the -DRT_GLOBAL_TABLES build
// (trace_body.cuh: GLOBAL_TABLES), for scenes whose tables and block do not
// fit two blocks an SM, the body reads the tables from global memory and the
// accumulator adds straight to the global block (K2's WarpAcc after its warp
// sums, K4's SharedAcc lane by lane): more global atomics, and again a
// summation order that changes from run to run.
//
// A launch covers a window of the frame (``P``'s row0, col0, h, w; the whole
// frame is 0, 0, yres, xres), as the forward kernels' do: the grid covers
// the window and masks its ragged edge, the cotangent and primal planes are
// the window's, and the body takes the global pixel, so a window's
// cotangents are the whole frame's with the image cotangent zero outside it.
//
// ``Body::run(s, p, cutoff, cam, ix, iy, g, acc)`` is the per-pixel program
// at global pixel (ix, iy): it adds the pixel's cotangents through ``acc``
// and returns its colour. It
// must be forced inline: chip_smoke.py fails when ptxas reports a device
// function besides the kernel, and a plain __device__ run was left as one.
// ``Body::Acc`` is its accumulator, built as ``{block}`` on the shared block;
// every thread of the block, in the image or not, calls ``acc.flush(n)``
// after the body and before the block goes to global memory, so an
// accumulator may hold sums in registers and reduce them over whole warps
// there. ``Body::BLOCK_X``, ``BLOCK_Y`` and ``MIN_BLOCKS`` are its launch
// shape: the block, and the blocks an SM that __launch_bounds__ asks ptxas
// to fit (so at most 65536 / (BLOCK_X * BLOCK_Y * MIN_BLOCKS) registers a
// thread). Every body takes BwdFrame's shape; the trace backward and the
// re-trace bring their own accumulators.
// ``Body::TEXTURED`` says whether it reads the texture atlas (the trace
// backward, the march backward's textured instance); then the atlas's meta
// rows are staged in shared memory beside the tables (but for a bank past
// TEXTURE_MAX in the global-table build: trace_body.cuh, staged_meta). The
// march backward's untextured instance and the re-trace's are false, and
// the untextured march backward is the kernel it was before textures.
// ``P`` is the body's parameter struct.
#pragma once

#include <cuda_runtime.h>

#include "trace_bwd_body.cuh"

namespace rt {

// The block's shared accumulator, as the per-pixel program adds to it: one
// shared atomicAdd per entry and lane.
struct SharedAcc {
  float* block;
  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(&block[row * GRAD_COLS + col], v);
#endif
  }
  __device__ void flush(int) {}
};

// Shared memory a launch needs for n objects and n_tex textures, in bytes:
// the tables and the block's accumulator (in the shared-table build), the
// camera, the light and the texture meta rows.
inline size_t bwd_smem(int n, int n_tex = 0) {
  const int n_tab = GLOBAL_TABLES ? 0 : n;
  return sizeof(float) * (n_tab * F32_COLS + CAM_COLS + LIGHT_COLS +
                          (GLOBAL_TABLES ? 0 : (n + 1) * GRAD_COLS)) +
         sizeof(int) * (n_tab * I32_COLS + staged_meta(n_tex) * TEX_META_COLS);
}

// The launch shape of every body and the accumulator of the march backward:
// 32x8 threads and two blocks an SM, so at most 128 registers a thread (left
// to its heuristic, ptxas gave the march backward 255 registers and one
// block an SM, 37% slower on an H100 than at 128 with its spills, PERF.md
// §6), and the per-lane shared accumulator.
struct BwdFrame {
  static constexpr int BLOCK_X = 32;
  static constexpr int BLOCK_Y = 8;
  static constexpr int MIN_BLOCKS = 2;
  using Acc = SharedAcc;
};

template <class Body, class P>
__global__ void __launch_bounds__(Body::BLOCK_X * Body::BLOCK_Y, Body::MIN_BLOCKS)
bwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
           const float* __restrict__ cam, const float* __restrict__ light, int n, P p,
           TexArgs tx, float cutoff, const float* __restrict__ g_r,
           const float* __restrict__ g_g, const float* __restrict__ g_b,
           float* __restrict__ out_block,
           float* __restrict__ prim_r, float* __restrict__ prim_g, float* __restrict__ prim_b) {
  constexpr bool GLOBAL = GLOBAL_TABLES;
  extern __shared__ float smem[];
  const int n_tab = GLOBAL ? 0 : n;  // objects staged in shared memory
  float* s_f32 = smem;
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n_tab * F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n_tab * I32_COLS);
  float* s_light = s_cam + CAM_COLS;
  float* s_acc = s_light + LIGHT_COLS;
  const int acc_len = GLOBAL ? 0 : (n + 1) * GRAD_COLS;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if constexpr (!GLOBAL) {
    for (int k = tid; k < n * F32_COLS; k += nthreads) s_f32[k] = f32t[k];
    for (int k = tid; k < n * I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  }
  if (tid < CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < acc_len; k += nthreads) s_acc[k] = 0.0f;
  int* s_meta = reinterpret_cast<int*>(s_acc + acc_len);
  const int n_meta = staged_meta(tx.n_tex);  // meta rows staged in shared memory
  if constexpr (Body::TEXTURED) {
    for (int k = tid; k < n_meta * TEX_META_COLS; k += nthreads) s_meta[k] = tx.meta[k];
  }
  __syncthreads();

  const int lx = blockIdx.x * blockDim.x + threadIdx.x;  // the pixel in the window
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  typename Body::Acc acc = {GLOBAL ? out_block : s_acc};
  if (lx < p.w && ly < p.h) {  // every thread reaches the flush and the barrier
    SceneView s;
    s.f32 = GLOBAL ? f32t : s_f32;
    s.i32 = GLOBAL ? i32t : s_i32;
    s.n = n;
    s.light = v3(s_light[0], s_light[1], s_light[2]);
    if constexpr (Body::TEXTURED) {
      s.tx = tx;
      if (n_meta == tx.n_tex) s.tx.meta = s_meta;
    }
    const size_t o = static_cast<size_t>(ly) * p.w + lx;
    C3 c = Body::run(s, p, cutoff, s_cam, p.col0 + lx, p.row0 + ly, c3(g_r[o], g_g[o], g_b[o]),
                     acc);
    if (prim_r != nullptr) {
      prim_r[o] = c.r;
      prim_g[o] = c.g;
      prim_b[o] = c.b;
    }
  }
  acc.flush(n);
  if constexpr (!GLOBAL) {
    __syncthreads();
    for (int k = tid; k < acc_len; k += nthreads) {
      const float v = s_acc[k];
      if (v != 0.0f) atomicAdd(&out_block[k], v);
    }
  }
}

// Launch bwd_kernel<Body> on ``stream`` of ``device`` over the window of
// ``p``: the cotangent planes and the primal planes are the window's (h x
// w), and each pixel's program takes its global pixel (col0 + lx, row0 +
// ly) of the xres x yres frame, so a window's pixels differentiate as the
// whole frame's. ``out_block`` is (n+1, 20) f32 and must hold zeros; the
// cotangents are added to it. The primal planes may be null; ``tx`` is all
// zero for an untextured scene. Returns the cudaError_t of the launch (0 =
// success), cudaErrorInvalidValue for a window not window_ok.
template <class Body, class P>
int launch_bwd(const float* f32t, const int* i32t, const float* cam, const float* light, int n,
               const P& p, const TexArgs& tx, float cutoff, const float* g_r, const float* g_g,
               const float* g_b, float* out_block, float* prim_r, float* prim_g, float* prim_b,
               int device, void* stream) {
  if (!window_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem(n, Body::TEXTURED ? tx.n_tex : 0);
  // above 48 KB a block may take dynamic shared memory only when asked
  err = cudaFuncSetAttribute(bwd_kernel<Body, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(Body::BLOCK_X * Body::BLOCK_Y % 32 == 0, "whole warps: acc.flush may shuffle");
  dim3 block(Body::BLOCK_X, Body::BLOCK_Y);
  dim3 grid((p.w + Body::BLOCK_X - 1) / Body::BLOCK_X, (p.h + Body::BLOCK_Y - 1) / Body::BLOCK_Y);
  bwd_kernel<Body, P><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      f32t, i32t, cam, light, n, p, tx, cutoff, g_r, g_g, g_b, out_block, prim_r, prim_g,
      prim_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
