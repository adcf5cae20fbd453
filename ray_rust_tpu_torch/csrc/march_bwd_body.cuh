// Per-pixel body of the march-mode backward (K4), shared by the CUDA kernel
// (march_bwd.cu) and a host build (march_bwd_host.cpp) that the CPU tests
// hold against torch autograd of the plain PyTorch version.
//
// It computes what ray_rust_tpu/ops/pallas_bwd.py:render_color_pallas_march_grads
// computes for one pixel: the pixel's cotangent g pulled back to the packed
// scene tables (the 19 f32 columns of every object, the camera and the
// light), for march-mode scenes, textured or not. The gradient contract is the
// plain version's (ops/trace.py:raymarch under autograd around the implicit
// VJP of ops/march.py): march, shadow, hit and pattern decisions and the
// texels are constants (a Bilinear texture's colour moves with its hit's uv
// through the blend weights, a Nearest one's not at all); a hit point moves
// with the scene by the implicit function theorem; the glow factor
// differentiates through the glow metric of the recorded argmin object at
// the recorded argmin position, which is a constant inside the path and the
// moving hit where it was the march's last sample; a hit at travel >=
// grad_distance_cutoff passes no shading gradient through its point.
//
// Two passes per pixel:
//
// 1. Record: the forward kernel's own traversal (march_body.cuh:march_pixel
//    with a MarchRecorder), the same marches, shadow marches and laps in
//    the same order, so the pixel's colour is the forward kernel's bit for
//    bit. This pass is what bounds the kernel, as the traversal bounds K3:
//    its slowest thread's serial SDF sweeps; the floor tail and the
//    never-converges shortcut of march_body.cuh shorten it here as there.
//    A march that the tail resolves records its argmin sample as the
//    stepped march would (the sample's position, step index and object;
//    of a run of samples whose f32 glow ties, the first), so ``gend``
//    below holds exactly where the argmin was the last sample. For every
//    raymarch call (a frame: the camera ray's, each refraction sub-march)
//    it saves the lap that started it, its colour before and after its
//    glow factor, and the glow argmin (value, position, object, whether it
//    was the hit of its march, and its lap). For every
//    lap that ran (a site) it saves the direction the lap marched, the end point,
//    the travel, the throughput before the lap, flags, the ignored object,
//    the winner, hit and lit, the next lap of its frame and the sub-march it
//    started. Only laps that occur are recorded.
// 2. Reverse sweep. First each frame's weight in the pixel, in creation
//    order (a sub-march's colour enters its parent linearly, through the
//    parent's throughput, transparency and glow factor), and the glow
//    factor's adjoint: the factor 1 + g*0.99^m, then m = glow_dist *
//    SDF(argmin object, argmin position) with the clamped SDF. Then the sites
//    last to first. A sub-march runs inside its parent's lap, after the
//    lap's own site and before the parent's next lap, and all of its own
//    sub-marches with it, so walking the sites backwards finishes every
//    sub-march before the site that started it, which then finds the
//    sub-march's colour and start-ray cotangents in its frame record; each
//    frame keeps its own running cotangents (start point, direction,
//    throughput), since the sites of its sub-marches come between its own.
//    A miss re-adds the sky on every remaining lap with unchanged state, so
//    its adjoint adds the sky's and passes the state's cotangents through. A
//    hit runs trace_bwd_body.cuh's shade_adj at the recorded hit point, then
//    the hit point's cotangent (its shading part dropped past the cutoff,
//    plus the glow endpoint's spatial gradient on the argmin lap) through the
//    implicit function theorem: with the SDF's winner at the hit (the
//    nearest object other than the ignored one, as autograd of the plain
//    SDF routes it), ∇D, ddt = ∇D.e and w = -(ḡ.e)/ddt on lanes with
//    |ddt| > 1e-5, the winner's fields get w*∂D/∂θ, the lap's start point
//    ḡ + w∇D and its direction t*(ḡ + w∇D). The camera ray's adjoint ends
//    the sweep. This is the JAX kernel's Newton reparameterization of the
//    hit, t = t_c - (D(p0 + e t_c) - D_c)/ddt, differentiated by hand.
//
// A site's record is 68 bytes and a frame's 124, so the two local arrays
// take MARCH_SITE_CAP * 192 bytes a thread (6.7 KB at MARCH_SITE_CAP = 35, the
// count of refraction_unroll=None at 3 laps), beside the forward's
// registers. Configurations with more laps, or a refraction cap past
// MARCH_FRAMES, run march_pixel_grad_buf (its record pass the deep march), whose
// records lie in a buffer in device memory that the wrapper allocates for
// the launch's window (trace_bwd_body.cuh: RecBuf, BufRecs; the cap a
// launch argument); the recorder and the sweep read and write them through
// their stores, one code for both. A record that would overflow turns the
// pixel and the block to NaN rather than drop a lap.
//
// Every function is forced inline, so the kernel is one straight program:
// real device calls between the march levels faulted on the card (ROADMAP
// queue 3), and chip_smoke.py fails when ptxas reports a function of
// march_bwd.cu besides the kernel.
#pragma once

#include "march_body.cuh"
#include "trace_bwd_body.cuh"

namespace rt {

constexpr int MARCH_SITE_CAP = 35;  // ops/kernel_march_bwd.py: SITE_CAP

// One lap that ran.
struct MSite {
  V3 eye;        // the direction the lap marched
  V3 pt;         // the march's end point (the hit point on a hit)
  C3 fcs;        // the throughput before the lap
  float travel;  // t*
  int flags, idx, ig;
  int frame;     // the raymarch call it belongs to
  int next;      // the next lap of that call, or -1
  int child;     // the refraction sub-march it started, or -1
  bool hit, lit;
};

// One raymarch call.
struct MFrame {
  int parent;        // the lap that started it, -1 for the camera ray
  int last;          // its latest lap (while recording)
  C3 ret, out;       // its colour before and after the glow factor
  float min_min;     // the glow argmin: value,
  V3 gpos;           //   position (before the step),
  int gobj;          //   object,
  int glap;          //   the lap whose march found it,
  bool gend;         //   and whether it was that march's last sample
  // reverse sweep
  C3 w;              // the weight of ``out`` in the pixel
  float factor;      // its glow factor
  V3 g_glow;         // the glow endpoint's cotangent on lap glap's hit point
  V3 g_pos, g_eye;   // running cotangents of the ray state,
  C3 g_fcs;          // and of the throughput
};

static_assert(sizeof(MSite) == 68 && sizeof(MFrame) == 124,
              "ops/kernel_march_bwd.py: RECORD_WORDS");

// The recorder raymarch calls (march_body.cuh): frames and sites in
// execution order, at most ``sites.size()`` of each, in the stores
// ``sites`` and ``frames`` (trace_bwd_body.cuh: LocalRecs or BufRecs). TEX:
// whether hits read the texture atlas (the textured kernel); the
// untextured kernel compiles the fetch out.
template <bool TEX, class Sites, class Frames>
struct MarchRecorder {
  static constexpr bool TRACK_GLOW = true;
  static constexpr bool TEXTURED = TEX;
  Sites sites;
  Frames frames;
  int n_sites, n_frames;
  bool overflow;

  RT_AD int frame(int parent) {
    if (overflow || n_frames >= frames.size()) {  // a frame holds at least one lap
      overflow = true;
      return -1;
    }
    auto&& f = frames.fresh(n_frames);
    f.parent = parent;
    f.last = -1;
    f.min_min = INFINITY;
    f.gpos = v3(0.0f, 0.0f, 0.0f);
    f.gobj = 0;
    f.glap = -1;
    f.gend = false;
    frames.put(n_frames, f);
    if (parent >= 0) {
      auto&& ps = sites.ref(parent);
      ps.child = n_frames;
      sites.put(parent, ps);
    }
    return n_frames++;
  }

  RT_AD int site(int frame, V3 eye, int ig, int flags, C3 fcs, const March& m, bool hit) {
    if (overflow || frame < 0 || n_sites >= sites.size()) {
      overflow = true;
      return -1;
    }
    auto&& st = sites.fresh(n_sites);
    st.eye = eye;
    st.pt = m.pos;
    st.fcs = fcs;
    st.travel = m.travel;
    st.flags = flags;
    st.idx = m.idx;
    st.ig = ig;
    st.frame = frame;
    st.next = -1;
    st.child = -1;
    st.hit = hit;
    st.lit = false;
    sites.put(n_sites, st);
    auto&& f = frames.ref(frame);
    if (f.last >= 0) {
      auto&& pl = sites.ref(f.last);
      pl.next = n_sites;
      sites.put(f.last, pl);
    }
    f.last = n_sites;
    frames.put(frame, f);
    return n_sites++;
  }

  RT_AD void lit(int site, bool l) {
    if (site >= 0) {
      auto&& st = sites.ref(site);
      st.lit = l;
      sites.put(site, st);
    }
  }

  RT_AD void glow(int frame, int site, const March& m, bool hit) {
    if (frame < 0) return;
    auto&& f = frames.ref(frame);
    f.min_min = m.min_dist;
    f.gpos = m.glow_pos;
    f.gobj = m.glow_obj;
    f.glap = site;
    f.gend = hit && m.glow_iter == m.iter - 1;
    frames.put(frame, f);
  }

  RT_AD void frame_end(int frame, C3 ret, C3 out) {
    if (frame < 0) return;
    auto&& f = frames.ref(frame);
    f.ret = ret;
    f.out = out;
    frames.put(frame, f);
  }
};

// Adds to ``*g_pos`` and, through ``acc``, to object ``i``'s row the
// cotangents of an SDF value d at ``pos`` for cotangent ``gd``: the sphere
// |o - p| - r, the floor (p - o).n (render.rs:473-475, 571-573), unclamped
// (the callers pass 0 where the clamp holds it). Returns nothing where
// |o - p| = 0, as the plain version's guarded square root gives.
template <class Acc>
RT_AD void sdf_adj(const SceneView& s, int i, V3 pos, float gd, V3* g_pos, Acc& acc) {
  const float* o = s.f32 + i * F32_COLS;
  if (s.i32[i * I32_COLS] == KIND_SPHERE) {
    V3 delta = sub(v3(o[0], o[1], o[2]), pos);
    float sq = dot(delta, delta);
    if (!(sq > 0.0f)) return;
    float gl = gd / sqrtf(sq);  // d|delta| = delta/|delta| . d delta
    acc.add(i, 0, gl * delta.x);
    acc.add(i, 1, gl * delta.y);
    acc.add(i, 2, gl * delta.z);
    acc.add(i, 17, -gd);
    acc3(g_pos, scale(delta, -gl));
    return;
  }
  V3 nrm = v3(o[3], o[4], o[5]);
  V3 rel = sub(pos, v3(o[0], o[1], o[2]));
  acc.add(i, 0, -gd * nrm.x);
  acc.add(i, 1, -gd * nrm.y);
  acc.add(i, 2, -gd * nrm.z);
  acc.add(i, 3, gd * rel.x);
  acc.add(i, 4, gd * rel.y);
  acc.add(i, 5, gd * rel.z);
  acc3(g_pos, scale(nrm, gd));
}

// The winner of the scene SDF at ``pos`` (object ``ig`` skipped): the
// nearest clamped distance, the first index on ties, as autograd of the
// plain SDF routes a cotangent. Sets *live when its unclamped distance is
// >= 0, where the clamp passes a gradient.
RT_AD int sdf_winner(const SceneView& s, V3 pos, int ig, bool* live) {
  float closest = INFINITY, raw = 0.0f;
  int idx = 0;
  for (int i = 0; i < s.n; ++i) {
    if (i == ig) continue;
    const float* o = s.f32 + i * F32_COLS;
    float r;
    if (s.i32[i * I32_COLS] == KIND_SPHERE) {
      V3 d = sub(v3(o[0], o[1], o[2]), pos);
      r = sqrtf(dot(d, d)) - o[17];
    } else {
      r = dot(sub(pos, v3(o[0], o[1], o[2])), v3(o[3], o[4], o[5]));
    }
    float c = fmaxf(r, 0.0f);
    if (c < closest) {
      closest = c;
      idx = i;
      raw = r;
    }
  }
  *live = raw >= 0.0f;
  return idx;
}

// ∇D at ``pos`` for object ``i`` (unclamped): (p - o)/|p - o| or the normal.
RT_AD V3 sdf_grad(const SceneView& s, int i, V3 pos) {
  const float* o = s.f32 + i * F32_COLS;
  if (s.i32[i * I32_COLS] == KIND_SPHERE) {
    V3 d = sub(pos, v3(o[0], o[1], o[2]));
    float sq = dot(d, d);
    if (!(sq > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
    return scale(d, 1.0f / sqrtf(sq));
  }
  return v3(o[3], o[4], o[5]);
}

// The adjoint of a lap that hit: shade_adj at the hit point (TEX: its
// texture's adjoint where the hit is textured), then the hit point through
// the implicit function theorem. Updates its frame's running cotangents
// (``F``) to those before the lap; reads the sub-march the lap started from
// ``frames`` (a store of trace_bwd_body.cuh).
template <bool TEX, class Frames, class Acc>
RT_AD void lap_adj(const SceneView& s, float cutoff, int i, const MSite& st, MFrame& F,
                   const Frames& frames, C3 gret, V3* g_light, Acc& acc) {
  const float* o = s.f32 + st.idx * F32_COLS;
  const int* oi = s.i32 + st.idx * I32_COLS;
  float g_row[F32_COLS];
  for (int k = 0; k < F32_COLS; ++k) g_row[k] = 0.0f;
  MFrame child;  // the sub-march's record, where the store holds no array
  const MFrame* ch = frames.ptr(st.child, child);
  const C3 zc = c3(0.0f, 0.0f, 0.0f);
  const V3 zv = v3(0.0f, 0.0f, 0.0f);
  C3 col = zc;  // the frame's colour is recorded; shade_adj's sum goes unused
  V3 gpt, ge;
  shade_adj<TEX>(s, o, oi, st.eye, st.pt, st.fcs, st.flags, st.lit, ch != nullptr,
            ch ? ch->out : zc, ch ? ch->g_pos : zv, ch ? ch->g_eye : zv, st.next >= 0, gret,
            F.g_pos, F.g_eye, &F.g_fcs, &col, &gpt, &ge, g_light, g_row);
  for (int k = 0; k < F32_COLS; ++k)
    if (g_row[k] != 0.0f) acc.add(st.idx, k, g_row[k]);

  // the hit point's cotangent: shading (not past the cutoff) + glow endpoint
  V3 gp = st.travel < cutoff ? gpt : zv;
  if (i == F.glap && F.gend) acc3(&gp, F.g_glow);

  // implicit function theorem at the hit: x* = p0 + e t*
  bool live;
  const int wi = sdf_winner(s, st.pt, st.ig, &live);
  V3 grad = live ? sdf_grad(s, wi, st.pt) : zv;
  float ddt = dot(grad, st.eye);
  float w = fabsf(ddt) > 1e-5f ? -dot(gp, st.eye) / ddt : 0.0f;
  if (w != 0.0f) {
    V3 unused = zv;
    sdf_adj(s, wi, st.pt, w, &unused, acc);
  }
  V3 p0 = add(gp, scale(grad, w));
  F.g_pos = p0;
  F.g_eye = add(ge, scale(p0, st.travel));
}

// The pixel's cotangent g pulled back to the scene tables through ``acc``
// (rows 0..n-1: the objects' 19 columns; row n: camera, light), recording
// at most ``rec.sites.size()`` laps and frames in ``rec``'s stores. Returns the
// pixel's colour (march_pixel's). TEX: the scene may be textured. DEEP: the
// record pass runs the deep march (march_body.cuh: raymarch_deep, the same
// traversal and records on an explicit stack), for refraction caps past
// MARCH_FRAMES.
template <bool DEEP = false, bool TEX, class Sites, class Frames, class Acc>
RT_AD C3 march_sweep(MarchRecorder<TEX, Sites, Frames>& rec, const SceneView& s,
                     const MarchParams& p, float cutoff, const float* cam, int ix, int iy,
                     C3 g, Acc& acc) {
  const Sites& sites = rec.sites;
  const Frames& frames = rec.frames;
  rec.n_sites = 0;
  rec.n_frames = 0;
  rec.overflow = false;
  C3 out;
  if constexpr (DEEP) {
    out = march_pixel_deep(s, p, cam, ix, iy, rec);
  } else {
    out = march_pixel(s, p, cam, ix, iy, rec);
  }
  if (rec.overflow) {  // unreachable at the wrapper's cap: poison, never drop a lap
    acc.add(s.n, 0, nanf(""));
    return c3(nanf(""), nanf(""), nanf(""));
  }

  // each frame's weight, parents first, and its glow factor's adjoint
  const V3 zv = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < rec.n_frames; ++k) {
    auto&& F = frames.ref(k);
    if (F.parent < 0) {
      F.w = c3(1.0f, 1.0f, 1.0f);
    } else {  // out_parent = factor * sum(face * fcs), face = base*(1 - f) + out*f
      const auto& ps = sites.get(F.parent);
      const auto& P = frames.get(ps.frame);
      const float f = s.f32[ps.idx * F32_COLS + 13];
      F.w = c3((ps.flags & RIGNORE) ? 0.0f : P.w.r * P.factor * ps.fcs.r * f,
               (ps.flags & GIGNORE) ? 0.0f : P.w.g * P.factor * ps.fcs.g * f,
               (ps.flags & BIGNORE) ? 0.0f : P.w.b * P.factor * ps.fcs.b * f);
    }
    F.g_pos = F.g_eye = F.g_glow = zv;
    F.g_fcs = c3(0.0f, 0.0f, 0.0f);
    const bool has = p.glow_on && fabsf(F.min_min) < INFINITY;
    F.factor = has ? 1.0f + p.glow * powf(0.99f, F.min_min) : 1.0f;
    if (has) {
      // factor = 1 + glow * 0.99^m; m = glow_dist * d(argmin object, gpos)
      float gfac = g.r * F.w.r * F.ret.r + g.g * F.w.g * F.ret.g + g.b * F.w.b * F.ret.b;
      float gm = gfac * p.glow * powf(0.99f, F.min_min) * logf(0.99f);
      const float* o = s.f32 + F.gobj * F32_COLS;
      float d = object_distance(o, s.i32[F.gobj * I32_COLS], F.gpos);
      if (gm * d != 0.0f) acc.add(F.gobj, 18, gm * d);
      V3 gx = zv;
      sdf_adj(s, F.gobj, F.gpos, gm * o[18], &gx, acc);
      if (F.gend) F.g_glow = gx;  // else the argmin position is a constant
    }
    frames.put(k, F);
  }

  V3 g_light = zv;
  for (int i = rec.n_sites - 1; i >= 0; --i) {
    const auto& st = sites.get(i);
    auto&& F = frames.ref(st.frame);
    const C3 gret = c3(g.r * F.w.r * F.factor, g.g * F.w.g * F.factor, g.b * F.w.b * F.factor);
    if (st.hit) {
      lap_adj<TEX>(s, cutoff, i, st, F, frames, gret, &g_light, acc);
    } else {  // ret += bg*fcs, unguarded; the ray state passes unchanged
      C3 bg = background(p.bg, s.light, st.eye);
      F.g_fcs = c3(F.g_fcs.r + gret.r * bg.r, F.g_fcs.g + gret.g * bg.g,
                   F.g_fcs.b + gret.b * bg.b);
      background_adj(p.bg, s.light, st.eye,
                     c3(gret.r * st.fcs.r, gret.g * st.fcs.g, gret.b * st.fcs.b), &g_light,
                     &F.g_eye);
    }
    frames.put(st.frame, F);
  }
  // the camera ray's march is frame 0: its start is the camera
  const auto& f0 = frames.get(0);
  Q4 gq = camera_ray_adj(p.xres, p.yres, p.sx, p.sy, cam, ix, iy, f0.g_eye);
  const float gcam[10] = {f0.g_pos.x, f0.g_pos.y, f0.g_pos.z,
                          gq.x, gq.y, gq.z, gq.w, g_light.x, g_light.y, g_light.z};
  for (int k = 0; k < 10; ++k)
    if (gcam[k] != 0.0f) acc.add(s.n, k, gcam[k]);
  return out;
}

// march_sweep with MARCH_SITE_CAP laps and frames in two local arrays.
template <bool TEX, class Acc>
RT_AD C3 march_pixel_grad(const SceneView& s, const MarchParams& p, float cutoff,
                          const float* cam, int ix, int iy, C3 g, Acc& acc) {
  MSite sites[MARCH_SITE_CAP];
  MFrame frames[MARCH_SITE_CAP];
  MarchRecorder<TEX, LocalRecs<MSite, MARCH_SITE_CAP>, LocalRecs<MFrame, MARCH_SITE_CAP>> rec;
  rec.sites = {sites};
  rec.frames = {frames};
  return march_sweep(rec, s, p, cutoff, cam, ix, iy, g, acc);
}

// march_sweep with p.cap laps and frames in p's buffer (rec_stores), its
// record pass on the deep march: the buffer instance takes every
// refraction cap up to MARCH_FRAMES_DEEP.
template <bool TEX, class Acc>
RT_AD C3 march_pixel_grad_buf(const SceneView& s, const RecBuf<MarchParams>& p, float cutoff,
                              const float* cam, int ix, int iy, C3 g, Acc& acc) {
  MarchRecorder<TEX, BufRecs<MSite>, BufRecs<MFrame>> rec;
  rec_stores(p, ix, iy, &rec.sites, &rec.frames);
  return march_sweep<true>(rec, s, p, cutoff, cam, ix, iy, g, acc);
}

}  // namespace rt
