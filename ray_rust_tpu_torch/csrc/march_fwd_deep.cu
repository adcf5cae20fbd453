// March-mode forward (K3) past a refraction cap of 10, for Hopper (sm_90a),
// one thread per pixel: march_fwd.cu's kernel and launcher with the deep
// march (march_body.cuh: raymarch_deep) in place of the chain of inlined
// raymarch<D> levels, which stops at rt::MARCH_FRAMES = 10 nested calls.
//
// The deep march runs the refraction recursion as one loop over an
// explicit per-thread stack of suspended raymarch calls (64 frames, 6.3 KB
// of local memory, touched once a sub-march each way), every float
// operation in the recursive body's order: at caps up to 10 its image is
// march_fwd's bit for bit, and with march_floor_skip off the plain
// march's. One instance in a library of its own, as march_bwd_buf.cu: it
// reads the tables from global memory (RT_GLOBAL_TABLES) and reads the
// texture atlas where the scene has one, so it takes every scene size and
// texture case the other builds take. ops/kernel_march.py launches it past
// FRAME_CAP and refuses caps past 64. Its launcher is rt_march_fwd,
// exported under the same name as the other builds'.

#define RT_GLOBAL_TABLES
#define RT_MARCH_DEEP
#include "march_fwd.cu"
