// Per-entry bodies of the scene pack and its pull-back, shared by the CUDA
// kernels (pack_scene.cu) and a host build (pack_scene_host.cpp) that the
// CPU tests run against ops/kernel_pack.py:pack_scene and autograd of it.
//
// The pack computes what ray_rust_tpu/ops/pallas_trace.py:_pack_scene
// computes, the trace and march kernels' tables (trace_body.cuh: F32_COLS,
// I32_COLS, CAM_COLS, LIGHT_COLS), and the texture meta rows of
// ops/kernel_pack.py:pack_textures, one output word an entry, straight
// from the scene's leaves: each leaf is a contiguous f32 or i32 tensor
// (PackArgs::leaf, in the order below), the material columns are
// read through the object's material index. Every f32 word is a copy of a
// leaf's, so the tables are pack_scene's bit for bit. An object whose
// material index lies outside the table gets NaN in its material columns
// and -1 in its material's integer columns rather than another material's.
//
// The pull-back computes the cotangent of every float leaf of the scene, in
// the order of models/scene.py:Scene.tensors(), from the backward kernels'
// (n+1, GRAD_COLS) block (bwd_kernel.cuh): an object leaf takes its column,
// the camera and the light take row n, a material leaf the sum of its
// column over its objects, in object index order, one entry a thread, no
// atomics: the same result on every run. The leaves the tables do not read
// (the materials' frac, the camera's pyr) get zeros, as under jax.vjp.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RT_PACK_FI __host__ __device__ __forceinline__
#else
#define RT_PACK_FI inline
#endif

namespace rt {
namespace pack {

// The tables' widths (trace_body.cuh) and the backward block's.
constexpr int F32_COLS = 19, I32_COLS = 4, CAM_COLS = 8, LIGHT_COLS = 4, META_COLS = 4;
constexpr int GRAD_COLS = 20;

// The leaves, in PackArgs::leaf's order (ops/kernel_pack.py: _leaves).
// Objects (n each): f32 org xyz, normal xyz, radius; i32 kind, mat, uvmap.
constexpr int OBJ_F32 = 0, OBJ_LEAVES_F32 = 7, OBJ_I32 = 7;
// Materials (m each): f32 diffuse rgb, specular rgb, pn, transparency,
// refraction, pattern_scale, pattern_angle_scale, glow_dist; i32 pattern,
// texture_id, texture_filter.
constexpr int MAT_F32 = 10, MAT_LEAVES_F32 = 12, MAT_I32 = 22;
// The camera's position xyz and rotation xyzw, the light's xyz (one value
// each), then the texture bank's widths and heights (n_tex each).
constexpr int CAM = 25, LIGHT = 32, TEX_W = 35, TEX_H = 36;
constexpr int LEAVES = 37;

struct PackArgs {
  const void* leaf[LEAVES];
  int n, m, n_tex;
  int tex_texels;  // texels a texture takes in the atlas: Hmax * Wmax
};

// Where f32 table column c comes from: a leaf of the object (0-6) or of
// its material (MAT_F32 + k).
RT_PACK_FI int f32_source(int c) {
  if (c < 6) return OBJ_F32 + c;  // org xyz, normal xyz
  if (c < 17) return MAT_F32 + c - 6;  // diffuse .. pattern_angle_scale
  return c == 17 ? OBJ_F32 + 6 : MAT_F32 + 11;  // radius, glow_dist
}
// The i32 table's columns: kind (object), pattern (material), uvmap
// (object), texture id (material).
RT_PACK_FI int i32_source(int c) {
  return c == 0 ? OBJ_I32 : (c == 1 ? MAT_I32 : (c == 2 ? OBJ_I32 + 2 : MAT_I32 + 1));
}
// The block column of the pull-back's object leaf j, material leaf j and
// scene entry j, in Scene.tensors()'s order (see vjp_entries), or -1 for an
// entry the tables do not read.
// Objects: org xyz, radius, normal xyz.
RT_PACK_FI int object_column(int j) { return j < 3 ? j : (j == 3 ? 17 : j - 1); }
// Materials: diffuse rgb, specular rgb, pn, transparency, refraction
// (columns 6-14), glow_dist (18), frac rgb (unread), pattern_scale,
// pattern_angle_scale (15, 16).
RT_PACK_FI int material_column(int j) {
  return j < 9 ? 6 + j : (j == 9 ? 18 : (j < 13 ? -1 : j + 2));
}
// The camera's position xyz (row n: 0-2), pyr xyz (unread), rotation xyzw
// (3-6), then the light's xyz (7-9).
RT_PACK_FI int scene_column(int j) { return j < 3 ? j : (j < 6 ? -1 : j - 3); }

RT_PACK_FI const float* f32_leaf(const PackArgs& a, int k) {
  return static_cast<const float*>(a.leaf[k]);
}
RT_PACK_FI const int* i32_leaf(const PackArgs& a, int k) {
  return static_cast<const int*>(a.leaf[k]);
}

// Words the pack writes, laid out as f32 table (n, 19), camera (1, 8),
// light (1, 4), i32 table (n, 4), meta (n_tex, 4).
RT_PACK_FI int pack_words(int n, int n_tex) {
  return n * (F32_COLS + I32_COLS) + CAM_COLS + LIGHT_COLS + n_tex * META_COLS;
}

// The texture meta row's filter of texture j: the max over the materials
// whose texture id clamps to j of their filter (0 for a material without a
// texture), and 0 (pack_textures's scatter-max from zeros).
RT_PACK_FI int meta_filter(const PackArgs& a, int j) {
  const int* tid = i32_leaf(a, MAT_I32 + 1);
  const int* filt = i32_leaf(a, MAT_I32 + 2);
  int best = 0;
  for (int k = 0; k < a.m; ++k) {
    const int t = tid[k] < 0 ? 0 : (tid[k] > a.n_tex - 1 ? a.n_tex - 1 : tid[k]);
    const int f = tid[k] >= 0 ? filt[k] : 0;
    if (t == j && f > best) best = f;
  }
  return best;
}

// Output word w (0 <= w < pack_words): ``f32_out`` and ``i32_out`` are one
// buffer of 32-bit words, seen as f32 and as i32.
RT_PACK_FI void pack_word(const PackArgs& a, int w, float* f32_out, int* i32_out) {
  const int n = a.n;
  const int nf = n * F32_COLS;
  if (w < nf) {
    const int i = w / F32_COLS, c = w % F32_COLS;
    const int src = f32_source(c);
    if (src < MAT_F32) {
      f32_out[w] = f32_leaf(a, src)[i];
    } else {
      const int mi = i32_leaf(a, OBJ_I32 + 1)[i];
      f32_out[w] = (mi >= 0 && mi < a.m) ? f32_leaf(a, src)[mi] : NAN;
    }
    return;
  }
  w -= nf;
  if (w < CAM_COLS) {  // position xyz, rotation xyzw, pad
    f32_out[nf + w] = w < 7 ? *f32_leaf(a, CAM + w) : 0.0f;
    return;
  }
  w -= CAM_COLS;
  if (w < LIGHT_COLS) {
    f32_out[nf + CAM_COLS + w] = w < 3 ? *f32_leaf(a, LIGHT + w) : 0.0f;
    return;
  }
  w -= LIGHT_COLS;
  int* i32t = i32_out + nf + CAM_COLS + LIGHT_COLS;
  if (w < n * I32_COLS) {
    const int i = w / I32_COLS, c = w % I32_COLS;
    const int src = i32_source(c);
    if (src < MAT_F32) {
      i32t[w] = i32_leaf(a, src)[i];
    } else {
      const int mi = i32_leaf(a, OBJ_I32 + 1)[i];
      i32t[w] = (mi >= 0 && mi < a.m) ? i32_leaf(a, src)[mi] : -1;
    }
    return;
  }
  w -= n * I32_COLS;
  const int j = w / META_COLS, c = w % META_COLS;
  int v;
  if (c == 0) {
    v = i32_leaf(a, TEX_W)[j];
  } else if (c == 1) {
    v = i32_leaf(a, TEX_H)[j];
  } else if (c == 2) {  // -1 past int32: the kernels derive it (texel_index)
    const long long base = static_cast<long long>(j) * a.tex_texels;
    v = base < (1ll << 31) ? static_cast<int>(base) : -1;
  } else {
    v = meta_filter(a, j);
  }
  i32t[n * I32_COLS + w] = v;
}

// Entries the pull-back writes, one for each element of the scene's float
// leaves in Scene.tensors()'s order: 7 object leaves of n, 15 material
// leaves of m, the camera's 10 and the light's 3.
constexpr int OBJ_VJP_LEAVES = 7, MAT_VJP_LEAVES = 15, SCENE_VJP_ENTRIES = 13;
RT_PACK_FI int vjp_entries(int n, int m) {
  return OBJ_VJP_LEAVES * n + MAT_VJP_LEAVES * m + SCENE_VJP_ENTRIES;
}

// Pull-back entry e (0 <= e < vjp_entries) from the block.
RT_PACK_FI float vjp_entry(const float* block, const int* mat, int n, int m, int e) {
  if (e < OBJ_VJP_LEAVES * n) return block[(e % n) * GRAD_COLS + object_column(e / n)];
  e -= OBJ_VJP_LEAVES * n;
  if (e < MAT_VJP_LEAVES * m) {
    const int mi = e % m, col = material_column(e / m);
    float acc = 0.0f;
    if (col < 0) return acc;
    for (int i = 0; i < n; ++i) {
      if (mat[i] == mi) acc += block[i * GRAD_COLS + col];
    }
    return acc;
  }
  const int col = scene_column(e - MAT_VJP_LEAVES * m);
  return col < 0 ? 0.0f : block[n * GRAD_COLS + col];
}

}  // namespace pack
}  // namespace rt
