// The scene pack and its pull-back for Hopper (sm_90a), one thread an
// output entry.
//
// Replaces ray_rust_tpu/ops/pallas_trace.py:_pack_scene (and the texture
// meta rows of _pack_textures) and its VJP, jax.vjp(pack_f32, scene)
// (pallas_trace.py:1656-1661). Neither is a Pallas kernel: the JAX package
// packs inside its jitted program, where XLA fuses the ~20 gathers and
// stacks into a few ops. Run eagerly, those ops and autograd's ~40 in the
// backward were most of the host's enqueue around each trace and march
// kernel, so the port writes the tables in one launch (rt_pack_scene) and
// pulls the backward kernels' block back to the leaves in another
// (rt_pack_scene_vjp). The per-entry programs live in pack_body.cuh.
//
// What bounds it: the launch. A scene of 512 objects is 47 KB of tables;
// each entry is a load or two and a store, and a material entry of the
// pull-back sums its column over the objects (at most 512 loads). Both
// kernels take one grid of 256-thread blocks over their entries, read the
// leaves where they lie (one pointer a leaf, passed by value in the launch's
// parameters) and write one buffer that the wrapper allocates, so the
// wrapper's Python is one ctypes call.
//
// Bound by ctypes through the plain C interface below (ops/_build.py,
// ops/kernel_pack.py).

#include <cuda_runtime.h>

#include "pack_body.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pack_scene_kernel(rt::pack::PackArgs a, int words, void* out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < words) rt::pack::pack_word(a, w, static_cast<float*>(out), static_cast<int*>(out));
}

__global__ void __launch_bounds__(THREADS)
pack_scene_vjp_kernel(const float* __restrict__ block, const int* __restrict__ mat, int n,
                      int m, int entries, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < entries) out[e] = rt::pack::vjp_entry(block, mat, n, m, e);
}

}  // namespace

extern "C" {

// Pack the scene's leaves (``leaves``: rt::pack::LEAVES pointers in
// pack_body.cuh's order, the texture ones null for an untextured scene)
// into ``out`` (rt::pack::pack_words(n, n_tex) words) on ``stream`` of
// ``device``; returns the cudaError_t of the launch (0 = success).
int rt_pack_scene(const void* const* leaves, int n, int m, int n_tex, int tex_texels,
                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  rt::pack::PackArgs a;
  for (int k = 0; k < rt::pack::LEAVES; ++k) a.leaf[k] = leaves[k];
  a.n = n;
  a.m = m;
  a.n_tex = n_tex;
  a.tex_texels = tex_texels;
  const int words = rt::pack::pack_words(n, n_tex);
  pack_scene_kernel<<<(words + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, words, out);
  return static_cast<int>(cudaGetLastError());
}

// Pull the (n+1, GRAD_COLS) block back to the scene's float leaves
// (``mat``: the objects' material indices), into ``out``
// (rt::pack::vjp_entries(n, m) floats, in Scene.tensors()'s order), on
// ``stream`` of ``device``.
int rt_pack_scene_vjp(const float* block, const int* mat, int n, int m, float* out, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = rt::pack::vjp_entries(n, m);
  pack_scene_vjp_kernel<<<(entries + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(block, mat, n, m, entries, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
