// Host build of the scene pack and its pull-back (pack_body.cuh): plain
// loops over the entries on the CPU, so the kernels' programs can be tested
// against ops/kernel_pack.py:pack_scene and autograd of it where there is
// no card. rt_pack_scene_host takes rt_pack_scene's arguments (pack_scene.cu)
// with an operation counter, as every host loop here, for the device and
// the stream; the pack counts nothing. rt_pack_scene_vjp takes the kernel's
// own arguments, the device and the stream unused, so one binding serves
// both builds (ops/_build.py). Build with ``g++ -std=c++17 -O2
// -ffp-contract=off -shared -fPIC``.

#include "pack_body.cuh"

extern "C" void rt_pack_scene_host(const void* const* leaves, int n, int m, int n_tex,
                                   int tex_texels, void* out, unsigned long long* /*ops_total*/) {
  rt::pack::PackArgs a;
  for (int k = 0; k < rt::pack::LEAVES; ++k) a.leaf[k] = leaves[k];
  a.n = n;
  a.m = m;
  a.n_tex = n_tex;
  a.tex_texels = tex_texels;
  const int words = rt::pack::pack_words(n, n_tex);
  for (int w = 0; w < words; ++w)
    rt::pack::pack_word(a, w, static_cast<float*>(out), static_cast<int*>(out));
}

extern "C" int rt_pack_scene_vjp(const float* block, const int* mat, int n, int m, float* out,
                                 int /*device*/, void* /*stream*/) {
  const int entries = rt::pack::vjp_entries(n, m);
  for (int e = 0; e < entries; ++e) out[e] = rt::pack::vjp_entry(block, mat, n, m, e);
  return 0;
}
