// The frame the gradient kernels share (trace_bwd.cu, march_bwd.cu,
// march_bwd_buf.cu and the re-trace oracle trace_retrace.cu): one thread per
// pixel, the scene tables staged in shared memory, each pixel's cotangents
// summed into a shared (n+1, 20) block through the body's accumulator, then
// the block added to the launch's global one with one atomicAdd per nonzero
// entry and digit, so a frame takes a global atomic per entry per block
// rather than per pixel, site and field. Every sum across threads is an int64 sum of
// fixed-point terms (fixed_sum.cuh), so it is exact and the same in any
// order: the same inputs and launch give the same block, bit for bit, on
// every launch. Dynamic shared memory above 48 KB is asked for. In the
// -DRT_GLOBAL_TABLES build (trace_body.cuh: GLOBAL_TABLES), for scenes whose
// tables and block do not fit two blocks an SM, the body reads the tables
// from global memory and the accumulator adds straight to the global int64
// block.
//
// A launch (launch_bwd) finds the largest finite |g| of the cotangent
// planes (fixed_gmax_kernel), runs the frame at the scale that gives
// (first_scale) with a 31-bit lo digit, reads the launch's counts back (one
// copy to the host and a wait), runs the frame once more at the scale and
// split its counts give (retry_split) where they do not fit, and adds the
// int64 block to the output block as floats (fixed_out_kernel).
// Its int64 blocks and counts live in a buffer kept for its device
// (fixed_scratch).
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
// ``Body::Acc`` is its accumulator, built as ``Acc(block, terms, n)`` on the
// int64 block (shared, or the launch's global one) with the thread's
// FixedTerms (its scale and split, the float output block for non-finite
// terms, its counts); every thread of the block, in the image or not, calls
// ``acc.flush(n)`` after the body and before the block goes to global memory, so an
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

#include <mutex>

#include "fixed_sum.cuh"
#include "trace_bwd_body.cuh"

namespace rt {

// The block's accumulator, as the per-pixel program adds to it: one int64
// atomicAdd per entry and lane to the lo digits (and one to the hi digits
// beside them for a term past the lo digit).
struct SharedAcc : FixedTerms {
  long long* block;
  __host__ __device__ SharedAcc(long long* b, const FixedTerms& t, int) : FixedTerms(t), block(b) {}
  __host__ __device__ void add(int row, int col, float v) {
#ifdef __CUDA_ARCH__
    const int e = row * GRAD_COLS + col;
    put(block, e, take(e, v));
#endif
  }
  __device__ void flush(int) {}
};

// Shared memory a launch needs for n objects and n_tex textures, in bytes:
// the block's int64 accumulators of lo and hi digits and the tables (in the
// shared-table build), the camera, the light and the texture meta rows.
inline size_t bwd_smem(int n, int n_tex = 0) {
  const int n_tab = GLOBAL_TABLES ? 0 : n;
  return sizeof(long long) * (GLOBAL_TABLES ? 0 : 2 * (n + 1) * GRAD_COLS) +
         sizeof(float) * (n_tab * F32_COLS + CAM_COLS + LIGHT_COLS) +
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

// The largest finite |g| of the three h*w cotangent planes, as float bits,
// into *out (which holds 0).
__global__ void fixed_gmax_kernel(const float* __restrict__ g_r, const float* __restrict__ g_g,
                                  const float* __restrict__ g_b, long long pixels,
                                  unsigned* out) {
  unsigned m = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < pixels;
       i += step) {
    m = max(m, max(finite_abs_bits(g_r[i]), max(finite_abs_bits(g_g[i]),
                                                finite_abs_bits(g_b[i]))));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(out, m);
}

// out[k] += the float of entry k's digit sums (hi[k], lo[k]) at scale f
// and lo digit width lo_bits, for its nonzero entries.
__global__ void fixed_out_kernel(const long long* __restrict__ lo,
                                 const long long* __restrict__ hi, int entries, int f,
                                 int lo_bits, float* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < entries && (lo[k] != 0 || hi[k] != 0)) out[k] += from_fixed(hi[k], lo[k], f, lo_bits);
}

template <class Body, class P>
__global__ void __launch_bounds__(Body::BLOCK_X * Body::BLOCK_Y, Body::MIN_BLOCKS)
bwd_kernel(const float* __restrict__ f32t, const int* __restrict__ i32t,
           const float* __restrict__ cam, const float* __restrict__ light, int n, P p,
           TexArgs tx, float cutoff, const float* __restrict__ g_r,
           const float* __restrict__ g_g, const float* __restrict__ g_b,
           float* __restrict__ out_block, long long* __restrict__ out_lo,
           long long* __restrict__ out_hi, FixedStats* __restrict__ stats, int forced,
           int lo_bits, float* __restrict__ prim_r, float* __restrict__ prim_g,
           float* __restrict__ prim_b) {
  constexpr bool GLOBAL = GLOBAL_TABLES;
  extern __shared__ long long smem[];
  __shared__ unsigned long long s_count;
  __shared__ int s_efield;
  const int n_tab = GLOBAL ? 0 : n;  // objects staged in shared memory
  long long* s_acc = smem;  // the lo digits, then the hi
  const int acc_len = GLOBAL ? 0 : (n + 1) * GRAD_COLS;
  long long* s_hi = s_acc + acc_len;
  float* s_f32 = reinterpret_cast<float*>(s_hi + acc_len);
  int* s_i32 = reinterpret_cast<int*>(s_f32 + n_tab * F32_COLS);
  float* s_cam = reinterpret_cast<float*>(s_i32 + n_tab * I32_COLS);
  float* s_light = s_cam + CAM_COLS;
  int* s_meta = reinterpret_cast<int*>(s_light + LIGHT_COLS);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if constexpr (!GLOBAL) {
    for (int k = tid; k < n * F32_COLS; k += nthreads) s_f32[k] = f32t[k];
    for (int k = tid; k < n * I32_COLS; k += nthreads) s_i32[k] = i32t[k];
  }
  if (tid < CAM_COLS) s_cam[tid] = cam[tid];
  if (tid < LIGHT_COLS) s_light[tid] = light[tid];
  for (int k = tid; k < 2 * acc_len; k += nthreads) s_acc[k] = 0;
  if (tid == 0) {
    s_count = 0;
    s_efield = 1;
  }
  const int n_meta = staged_meta(tx.n_tex);  // meta rows staged in shared memory
  if constexpr (Body::TEXTURED) {
    for (int k = tid; k < n_meta * TEX_META_COLS; k += nthreads) s_meta[k] = tx.meta[k];
  }
  __syncthreads();

  const int lx = blockIdx.x * blockDim.x + threadIdx.x;  // the pixel in the window
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  const int scale = forced != FIXED_FREE ? forced : first_scale(stats->gbits);
  typename Body::Acc acc(GLOBAL ? out_lo : s_acc,
                         FixedTerms(scale, lo_bits, out_block, GLOBAL ? out_hi : s_hi), n);
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
  // the launch's counts: the warp's, the block's, then one add a block
  const unsigned count = __reduce_add_sync(0xffffffffu, acc.count);
  const int efield = __reduce_max_sync(0xffffffffu, acc.efield);
  if ((tid & 31) == 0 && count != 0) {
    atomicAdd(&s_count, static_cast<unsigned long long>(count));
    atomicMax(&s_efield, efield);
  }
  __syncthreads();
  for (int k = tid; k < acc_len; k += nthreads) {
    const long long lo = s_acc[k], hi = s_hi[k];
    if (lo != 0) add_digit(&out_lo[k], lo);
    if (hi != 0) add_digit(&out_hi[k], hi);
  }
  if (tid == 0 && s_count != 0) {
    atomicAdd(&stats->count, s_count);
    atomicMax(&stats->efield, s_efield);
  }
}

// The launches' int64 digits and counts: one buffer a device, grown as a
// launch needs and kept, so a launch allocates nothing (a stream-ordered
// allocation a launch, released at its wait, cost ~0.9 ms on an H100).
// launch_bwd holds the lock while it uses the buffer, and a stream that
// takes it next waits for the event the last launch recorded after its
// last use (its conversion kernel, which runs on after the call returns).
inline std::mutex& fixed_scratch_lock() {
  static std::mutex m;
  return m;
}

inline cudaError_t fixed_scratch(int device, size_t bytes, cudaStream_t st, void** out,
                                 cudaEvent_t* done) {
  static void* ptr[64] = {};
  static size_t size[64] = {};
  static cudaEvent_t used[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (used[device] == nullptr) {
    const cudaError_t err = cudaEventCreateWithFlags(&used[device], cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  } else {
    const cudaError_t err = cudaStreamWaitEvent(st, used[device], 0);
    if (err != cudaSuccess) return err;
  }
  *done = used[device];
  if (size[device] < bytes) {
    if (ptr[device] != nullptr) cudaFree(ptr[device]);
    size[device] = 0;
    const cudaError_t err = cudaMalloc(&ptr[device], bytes);
    if (err != cudaSuccess) {
      ptr[device] = nullptr;
      return err;
    }
    size[device] = bytes;
  }
  *out = ptr[device];
  return cudaSuccess;
}

// Launch bwd_kernel<Body> on ``stream`` of ``device`` over the window of
// ``p``: the cotangent planes and the primal planes are the window's (h x
// w), and each pixel's program takes its global pixel (col0 + lx, row0 +
// ly) of the xres x yres frame, so a window's pixels differentiate as the
// whole frame's. ``out_block`` is (n+1, 20) f32; the cotangents are added to
// it. The primal planes may be null; ``tx`` is all zero for an untextured
// scene. ``band_rows`` x ``band_cols`` (0: the window's) cut the window into
// bands, launched one after another in stream order (the buffer instances,
// whose records fit one band at a time): runs of whole rows, or pieces of
// one row. Every band sums into the one int64 block at the window's scale,
// so a banded launch's block is the one launch's, bit for bit. The call
// returns once the block is added (it waits for the frame's counts).
// Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a window not window_ok or bands of several
// rows narrower than the window, or FIXED_OVERFLOW (a count past
// FIXED_SPLIT_BITS bits). last_fixed records a launch that returns 0.
template <class Body, class P>
int launch_bwd(const float* f32t, const int* i32t, const float* cam, const float* light, int n,
               const P& p, const TexArgs& tx, float cutoff, const float* g_r, const float* g_g,
               const float* g_b, float* out_block, float* prim_r, float* prim_g, float* prim_b,
               int device, void* stream, int band_rows = 0, int band_cols = 0) {
  const int br = band_rows > 0 ? band_rows : p.h, bc = band_cols > 0 ? band_cols : p.w;
  if (!window_ok(p) || (br > 1 && bc < p.w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem(n, Body::TEXTURED ? tx.n_tex : 0);
  // above 48 KB a block may take dynamic shared memory only when asked
  err = cudaFuncSetAttribute(bwd_kernel<Body, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(Body::BLOCK_X * Body::BLOCK_Y % 32 == 0, "whole warps: acc.flush may shuffle");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int entries = (n + 1) * GRAD_COLS;
  const long long pixels = static_cast<long long>(p.h) * p.w;
  const size_t q_bytes = 2 * sizeof(long long) * entries;  // the lo digits, then the hi
  const std::lock_guard<std::mutex> lock(fixed_scratch_lock());
  void* scratch = nullptr;
  cudaEvent_t done = nullptr;
  err = fixed_scratch(device, q_bytes + sizeof(FixedStats), st, &scratch, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long* lo = static_cast<long long*>(scratch);
  long long* hi = lo + entries;
  FixedStats* stats = reinterpret_cast<FixedStats*>(static_cast<char*>(scratch) + q_bytes);
  cudaMemsetAsync(scratch, 0, q_bytes + sizeof(FixedStats), st);
  const int gblocks = static_cast<int>(pixels / 256 + 1 < 1024 ? pixels / 256 + 1 : 1024);
  fixed_gmax_kernel<<<gblocks, 256, 0, st>>>(g_r, g_g, g_b, pixels, &stats->gbits);
  int forced = FIXED_FREE, runs = 0, scale = 0, first = 0, lo_bits = FIXED_LO_BITS;
  FixedStats h = {};
  for (;;) {
    for (int r = 0; r < p.h; r += br) {
      for (int c = 0; c < p.w; c += bc) {
        P pb = p;  // the band: its planes a contiguous run of the window's
        pb.row0 = p.row0 + r;
        pb.col0 = p.col0 + c;
        pb.h = br < p.h - r ? br : p.h - r;
        pb.w = bc < p.w - c ? bc : p.w - c;
        const size_t o = static_cast<size_t>(r) * p.w + c;
        dim3 block(Body::BLOCK_X, Body::BLOCK_Y);
        dim3 grid((pb.w + Body::BLOCK_X - 1) / Body::BLOCK_X,
                  (pb.h + Body::BLOCK_Y - 1) / Body::BLOCK_Y);
        bwd_kernel<Body, P><<<grid, block, smem, st>>>(
            f32t, i32t, cam, light, n, pb, tx, cutoff, g_r + o, g_g + o, g_b + o, out_block, lo,
            hi, stats, forced, lo_bits, prim_r ? prim_r + o : nullptr,
            prim_g ? prim_g + o : nullptr, prim_b ? prim_b + o : nullptr);
      }
    }
    ++runs;
    err = cudaMemcpyAsync(&h, stats, sizeof(h), cudaMemcpyDeviceToHost, st);
    if (err == cudaSuccess) err = cudaStreamSynchronize(st);
    if (err != cudaSuccess) break;
    if (runs == 1) first = scale = first_scale(h.gbits);
    if (fits(h.count, h.efield, scale, lo_bits)) break;
    if (runs > 1 || !retry_split(count_bits(h.count), h.efield, &scale, &lo_bits)) {
      err = static_cast<cudaError_t>(FIXED_OVERFLOW);
      break;
    }
    forced = scale;
    cudaMemsetAsync(scratch, 0, q_bytes, st);  // and the counts; the planes' |g| stays
    cudaMemsetAsync(&stats->count, 0, sizeof(stats->count), st);
    cudaMemsetAsync(&stats->efield, 0, sizeof(stats->efield), st);
  }
  if (err == cudaSuccess) {
    fixed_out_kernel<<<(entries + 255) / 256, 256, 0, st>>>(lo, hi, entries, scale, lo_bits,
                                                            out_block);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventRecord(done, st);
    record_fixed(first, scale, runs, h, lo_bits);
  }
  return static_cast<int>(err);
}

// The name of a launcher's return code: FIXED_OVERFLOW's, or the CUDA
// runtime's.
inline const char* error_string(int code) {
  if (code == FIXED_OVERFLOW) return "the fixed-point cotangent sum would overflow int64";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace rt
