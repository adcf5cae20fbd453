"""The trace backward (ops/kernel_trace_bwd.py) against torch autograd.

On the CPU: the site count and the record cap against the JAX package's
static site tree, the support check, each hand-written adjoint step of the
kernel's per-pixel body (``csrc/trace_bwd_body.cuh``) against autograd of
its plain counterpart, the whole body built for the host with g++ against
``render_grads_plain`` (autograd of the plain trace), at every record cap,
and its counting build. The kernel itself runs only on a card (the
``cuda`` tests: against autograd on three scenes, and two launches against
each other); this file imports the JAX package only inside the tests that
compare with it, so the card tests also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernel_bwd.py``.

Gradient budget: the forwards of the two sides are compared first, and the
cotangent is masked to the pixels where they agree to 1e-4; every masked
pixel must sit on a decision boundary (the method of
tests/test_pallas_bwd.py:29-47). On those pixels the host build and autograd
run the same float operations up to the order of sums, so each scene leaf's
relative L2 difference must stay within 1e-3 (norm floor 1e-2). The card's
budget is the JAX package's 0.01: its blocks sum in shared memory and global
atomics, in an order that changes from run to run. ``pattern_scale`` is held
finite only, as the JAX tests hold it (edge-dominated noise).
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.quat import Quat
from ray_rust_tpu_torch.models.vec import Color, Vec3
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march as km
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops.rays import camera_rays, fov_scales
from ray_rust_tpu_torch.ops.sky import default_sky
from ray_rust_tpu_torch.ops.trace import phong, refraction_ray

from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _glass_cluster, _many_spheres, _patterns_scene, one_torch_thread, textured_scene,
    two_texture_scene)


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _ptr(a):
    return a.ctypes.data_as(_build.ctypes.c_void_p)


def _unit(rng, m):
    v = rng.standard_normal((m, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _vec(a):
    """Vec3 of leaf tensors that require grad, from an (m, 3) array."""
    return Vec3(*(torch.tensor(a[:, k]).requires_grad_() for k in range(3)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _build.build_host_library(tmp_path_factory.mktemp("trace_bwd_host"), "trace_bwd")
    p, i, f = _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_float
    lib.rt_sky_adj.argtypes = [i, p, p, p, p, p]
    lib.rt_bend_adj.argtypes = [i, p, p, p, p, p, p, p]
    lib.rt_camera_ray_adj.argtypes = [i, i, f, f, p, p, p]
    lib.rt_pow_adj.argtypes = [i, p, p, p, p, p]
    for fn in (lib.rt_sky_adj, lib.rt_bend_adj, lib.rt_camera_ray_adj, lib.rt_pow_adj):
        fn.restype = None
    return lib


def test_site_count_equals_jax_site_tree():
    from ray_rust_tpu.ops.pallas_bwd import _count_sites, _site_nodes

    import ray_rust_tpu as rt

    for kw in (dict(), dict(refraction_unroll=None), dict(max_reflections=2, refraction_unroll=1),
               dict(max_refractions=1), dict(max_reflections=5, refraction_unroll=2)):
        want = _count_sites(_site_nodes(rt.RenderConfig(**kw)))
        assert kb.count_sites(rtt.RenderConfig(**kw)) == want
    assert kb.count_sites(rtt.RenderConfig()) == 11
    assert kb.count_sites(rtt.RenderConfig(refraction_unroll=None)) == 35
    assert kb.site_cap(rtt.RenderConfig(refraction_unroll=None)) == 64


@pytest.mark.parametrize("reflections", range(1, 7))
def test_site_cap_is_the_smallest_that_holds_the_jax_site_tree(reflections):
    """Every config the forward kernel takes (at most 6 reflections) gets
    the smallest record cap that holds the JAX package's static site count."""
    from ray_rust_tpu.ops.pallas_bwd import _count_sites, _site_nodes

    import ray_rust_tpu as rt

    scene, _ = rtt.default_scene(device="cpu")
    for unroll in (0, 1, 2, 4, None):
        kw = dict(max_reflections=reflections, refraction_unroll=unroll)
        sites = _count_sites(_site_nodes(rt.RenderConfig(**kw)))
        cfg = rtt.RenderConfig(xres=8, yres=8, **kw)
        assert kt.unsupported_reason(scene, cfg) is None
        assert kb.unsupported_reason(scene, cfg) is None
        assert kb.site_cap(cfg) == min(c for c in kb.SITE_CAPS if c >= sites), kw
    if reflections == 6:
        assert kb.site_cap(rtt.RenderConfig(max_reflections=6, refraction_unroll=None)) == 192


def test_unsupported_reason_adds_the_site_cap():
    """The backward kernel takes the configs the forward kernel takes
    whose sites fit its largest record cap (4 reflections at
    refraction_unroll=None: 63 sites; 11 reflections at the default unroll:
    71), refuses the others with the forward kernel's reason, and names the
    site cap past it (7 reflections at refraction_unroll=None: 319)."""
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=8)
    assert kb.unsupported_reason(scene, cfg) is None
    assert kb.unsupported_reason(scene, cfg.with_(refraction_unroll=None)) is None
    assert kb.unsupported_reason(scene, cfg.with_(max_reflections=4,
                                                  refraction_unroll=None)) is None
    assert kb.unsupported_reason(scene, cfg.with_(max_reflections=11)) is None
    deep = cfg.with_(max_reflections=12)
    assert kb.unsupported_reason(scene, deep) == kt.unsupported_reason(scene, deep)
    assert "task stack" in kb.unsupported_reason(scene, deep)
    assert "sites" in kb.unsupported_reason(scene, cfg.with_(max_reflections=7,
                                                           refraction_unroll=None))
    with pytest.raises(ValueError, match="sites"):
        kb.site_cap(cfg.with_(max_reflections=7, refraction_unroll=None))
    assert "K3" in kb.unsupported_reason(scene, cfg.with_(use_raymarching=True))
    tex = np.zeros((4, 4, 3), np.uint8)
    textured, _ = rtt.build_scene([rtt.MaterialSpec(name="t", texture=tex)],
                                  [rtt.SphereSpec("t", 10.0, (0.0, 0.0, 50.0))],
                                  (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                  device="cpu")
    assert kb.unsupported_reason(textured, cfg) is None  # K2 takes textured sites
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.render_grads_kernel(scene, cfg, Color(*(torch.zeros(8, 8) for _ in range(3))))
    assert kb.LAUNCHES == 0


def test_cpu_gradient_takes_plain_autograd():
    """On the CPU the renderer differentiates the plain version: no launch."""
    scene, _ = rtt.default_scene(device="cpu")
    light = scene.light.x.clone().requires_grad_()
    scene = scene._replace(light=scene.light._replace(x=light))
    img = rtt.render_color(scene, rtt.RenderConfig(xres=16, yres=8, max_reflections=2))
    img.r.sum().backward()
    assert torch.isfinite(light.grad) and light.grad != 0
    assert kt.LAUNCHES == kb.LAUNCHES == 0


def test_sky_adjoint(host_lib):
    rng = np.random.default_rng(1)
    light = _unit(rng, 1)[0]
    d = _unit(rng, 96)
    # a third of the rays near the sun, through its glare and halo bands
    near = light + 0.08 * _unit(rng, 32)
    d[:32] = near / np.linalg.norm(near, axis=1, keepdims=True)
    d[40] = light  # the sun itself: a constant
    d[41] = (0.0, -0.6, 0.8)  # atan2 on its x = 0 axis
    d[42] = np.float32([0.01, -1.0, 0.02]) / np.linalg.norm([0.01, -1.0, 0.02])  # asin near -1
    d = np.ascontiguousarray(d, np.float32)
    g = _f32(rng, 96, 3)
    g_light, g_d = np.zeros((96, 3), np.float32), np.zeros((96, 3), np.float32)
    host_lib.rt_sky_adj(96, _ptr(light), _ptr(d), _ptr(g), _ptr(g_light), _ptr(g_d))

    lv = Vec3(*(torch.tensor(light[k]).expand(96).clone().requires_grad_() for k in range(3)))
    dv = _vec(d)
    col = default_sky(lv, dv)
    want = torch.autograd.grad(tuple(col), tuple(lv) + tuple(dv),
                               tuple(torch.tensor(g[:, k]) for k in range(3)))
    assert np.isfinite(g_d).all() and np.isfinite(g_light).all()
    assert _rel(g_light, torch.stack(want[:3], 1)) < 1e-5
    assert _rel(g_d, torch.stack(want[3:], 1)) < 1e-5
    assert not g_d[40].any()


def test_bend_adjoint(host_lib):
    rng = np.random.default_rng(2)
    m = 64
    eye, n = _unit(rng, m), _unit(rng, m)
    refr = _f32(rng, m, lo=0.5, hi=2.0)
    refr[:4] = (0.0, 1e-7, -1e-7, 1.0)  # degenerate indices bend with 1
    g_ray = _f32(rng, m, 3)
    out = [np.zeros((m, 3), np.float32), np.zeros((m, 3), np.float32), np.zeros(m, np.float32)]
    host_lib.rt_bend_adj(m, _ptr(eye), _ptr(n), _ptr(refr), _ptr(g_ray), *map(_ptr, out))

    ev, nv = _vec(eye), _vec(n)
    fr = torch.tensor(refr).requires_grad_()
    ray, _ = refraction_ray(ev, nv, torch.ones(m), fr)
    want = torch.autograd.grad(tuple(ray), tuple(ev) + tuple(nv) + (fr,),
                               tuple(torch.tensor(g_ray[:, k]) for k in range(3)))
    assert _rel(out[0], torch.stack(want[0:3], 1)) < 1e-5
    assert _rel(out[1], torch.stack(want[3:6], 1)) < 1e-5
    assert _rel(out[2], want[6]) < 1e-5


def test_camera_ray_adjoint(host_lib):
    """Odd sizes, so the centre row and column sit at eye offsets of 0."""
    rng = np.random.default_rng(3)
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=9, yres=7)
    cam = kt.pack_scene(scene)[2].numpy()[0].copy()
    g_eye = _f32(rng, 7, 9, 3)
    g_rot = np.zeros(4, np.float32)
    sx, sy = fov_scales(cfg)
    host_lib.rt_camera_ray_adj(9, 7, sx, sy, _ptr(cam), _ptr(g_eye), _ptr(g_rot))

    rot = Quat(*(torch.tensor(cam[3 + k]).requires_grad_() for k in range(4)))
    _, eye = camera_rays(scene.camera.position, rot, cfg)
    want = torch.autograd.grad(tuple(eye), tuple(rot),
                               tuple(torch.tensor(g_eye[..., k]) for k in range(3)))
    assert _rel(g_rot, torch.stack(want)) < 1e-5


def test_pow_adjoint(host_lib):
    rng = np.random.default_rng(4)
    ri = np.concatenate([_f32(rng, 40, lo=1e-3, hi=1.0), np.float32([0.0, -0.5, 1.0, 2.0])])
    pn = np.resize(np.float32([0.0, 1.0, 8.0, 24.0, 2.5]), ri.shape)
    g = _f32(rng, ri.size)
    g_ri, g_pn = np.zeros_like(ri), np.zeros_like(ri)
    host_lib.rt_pow_adj(ri.size, _ptr(ri), _ptr(pn), _ptr(g), _ptr(g_ri), _ptr(g_pn))

    rit, pnt = torch.tensor(ri).requires_grad_(), torch.tensor(pn).requires_grad_()
    want = torch.autograd.grad(phong(rit, pnt), (rit, pnt), torch.tensor(g))
    np.testing.assert_allclose(g_ri, want[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_pn, want[1].numpy(), rtol=1e-5, atol=1e-6)


def _host_grads(lib, scene, cfg, g):
    """The host build's table cotangents and image for cotangent planes g."""
    tables = kt.pack_scene(scene)
    tex = kt.pack_textures(scene)  # held until the call returns
    f32t, i32t, cam, light = tables
    n = f32t.shape[0]
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_trace_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
                          *kb.launch_args(cfg, tex, torch.device("cpu")),
                          *(c.data_ptr() for c in g), block.data_ptr(),
                          *(p.data_ptr() for p in prim), None)
    return kb.split_block(block, n), np.stack([p.numpy() for p in prim], -1)


def _img(col):
    return np.stack([c.detach().cpu().numpy() for c in col], -1)


def assert_boundary_only(ref_img, agree, contrast=0.05):
    """Every pixel left out of a gradient comparison has a high local
    contrast in ``ref_img``: a hit, shadow or pattern decision flips within
    its 3x3 neighbourhood (tests/test_pallas_bwd.py:29-47)."""
    bad = ~agree
    if not bad.any():
        return
    h, w = agree.shape
    pad = np.pad(ref_img.mean(-1), 1, mode="edge")
    win = np.stack([pad[r:r + h, c:c + w] for r in range(3) for c in range(3)])
    local = win.max(0) - win.min(0)
    assert (local[bad] > contrast).all(), f"masked pixels off a boundary: {np.argwhere(bad)}"


def assert_leaf_grads_close(scene, got, want, budget):
    """Per scene leaf: relative L2 within ``budget``, everything finite;
    ``pattern_scale`` finite only. Returns the largest relative L2."""
    got, want = kb.leaf_grads(scene, got), kb.leaf_grads(scene, want)
    worst = 0.0
    for path, w in want.items():
        a = got[path].detach().cpu().numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" in path:
            continue
        rel = _rel(a, w.detach().cpu().numpy())
        assert rel <= budget, f"{path}: relative L2 {rel:.2e} > {budget}"
        worst = max(worst, rel)
    return worst


_HOST_CASES = {
    "default": (lambda: rtt.default_scene(device="cpu")[0], rtt.RenderConfig(xres=32, yres=16)),
    "default_full_depth": (lambda: rtt.default_scene(device="cpu")[0],
                           rtt.RenderConfig(xres=32, yres=16, refraction_unroll=None)),
    "glass_cluster": (lambda: _glass_cluster(rtt),
                      rtt.RenderConfig(xres=32, yres=24, refraction_unroll=None)),
    "seventy_spheres": (lambda: _many_spheres(rtt, 70), rtt.RenderConfig(xres=48, yres=24)),
    "patterns_black_bg": (lambda: _patterns_scene(rtt),
                          rtt.RenderConfig(xres=48, yres=32, bg="black")),
    # tests/test_pallas_bwd.py:140-149: the textured sites
    "textured_bilinear": (lambda: textured_scene(rtt, 1, camera=(0.37, -150.3, -300.0)),
                          rtt.RenderConfig(xres=32, yres=16, max_reflections=2,
                                           refraction_unroll=1, grad_distance_cutoff=2e3)),
    "two_textures": (lambda: two_texture_scene(rtt), rtt.RenderConfig(xres=48, yres=16)),
    # the larger record caps: 63 sites (cap 64) and 191 (cap 192), where a
    # pixel of this frame records 17 (test_counting_build_changes_no_cotangent)
    "sixty_three_sites": (lambda: _glass_cluster(rtt),
                          rtt.RenderConfig(xres=16, yres=8, max_reflections=4,
                                           refraction_unroll=None)),
    "one_ninety_one_sites": (lambda: _glass_cluster(rtt),
                             rtt.RenderConfig(xres=16, yres=8, max_reflections=6,
                                              refraction_unroll=None)),
}


@pytest.mark.parametrize("case", sorted(_HOST_CASES))
def test_host_build_of_backward_body_matches_autograd(host_lib, case):
    make, cfg = _HOST_CASES[case]
    scene = make()
    assert kb.kernel_supported(scene, cfg)
    rng = np.random.default_rng(0)
    planes = [torch.from_numpy(_f32(rng, cfg.yres, cfg.xres)) for _ in range(3)]
    _, prim = _host_grads(host_lib, scene, cfg, planes)
    ref = _img(kt.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.99
    assert_boundary_only(ref, agree)
    g = Color(*(p * torch.from_numpy(agree) for p in planes))
    got, _ = _host_grads(host_lib, scene, cfg, g)
    assert_leaf_grads_close(scene, got, kb.render_grads_plain(scene, cfg, g), 1e-3)


def _count_host(lib, scene, cfg, g):
    """The counting build's table cotangents and its counts
    (``kernel_march.OPS_SLOTS`` slots, csrc/trace_bwd_host.cpp)."""
    tables = kt.pack_scene(scene)
    n = tables[0].shape[0]
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    lib.rt_trace_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
                          *kb.launch_args(cfg, None, torch.device("cpu")),
                          *(c.data_ptr() for c in g), block.data_ptr(), None, None, None,
                          ops.data_ptr())
    return kb.split_block(block, n), [int(v) for v in ops]


def test_counting_build_changes_no_cotangent(host_lib, tmp_path):
    """The -DRT_COUNT_OPS build gives the same cotangent bit for bit, and
    counts the accumulator's adds (one per nonzero entry and pixel), the
    distinct (warp of 32 pixels of a row, entry) pairs among them, and the
    sites; the 191-site case has a pixel past the smallest record cap."""
    lib = _build.build_host_library(tmp_path, "trace_bwd", count_ops=True)
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=32, yres=16)
    g = [torch.ones(cfg.yres, cfg.xres) for _ in range(3)]
    got, ops = _count_host(lib, scene, cfg, g)
    want, _ = _host_grads(host_lib, scene, cfg, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _, _, adds, pairs, sites, most = ops
    pixels = cfg.xres * cfg.yres
    assert 0 < pairs <= adds and pairs <= 16 * (kb.GRAD_COLS * (scene.objects.count + 1))
    assert adds >= 10 * pixels  # at least the camera row of every pixel
    assert pixels <= sites <= most * pixels and 1 < most <= kb.count_sites(cfg)
    make, deep = _HOST_CASES["one_ninety_one_sites"]
    ones = [torch.ones(deep.yres, deep.xres) for _ in range(3)]
    assert _count_host(lib, make(), deep, ones)[1][5] > kb.SITE_CAPS[0]


@pytest.mark.cuda
def test_cuda_gradient_goes_through_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=160, yres=120)
    rng = np.random.default_rng(5)
    g = Color(*(torch.from_numpy(_f32(rng, 120, 160)).cuda() for _ in range(3)))
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    params = [t for t in leaves if t.requires_grad]
    before = (kt.LAUNCHES, kb.LAUNCHES)
    img = rtt.render_color(scene.with_tensors(leaves), cfg)
    got = torch.autograd.grad(tuple(img), params, tuple(g), allow_unused=True)
    torch.cuda.synchronize()
    assert (kt.LAUNCHES, kb.LAUNCHES) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(_img(img), _img(kt.render_color_plain(scene, cfg)))
    want = kb.leaf_grads(scene, kb.render_grads_plain(scene, cfg, g))
    for (path, w), gr in zip(want.items(), got):
        a = np.zeros(w.shape, np.float32) if gr is None else gr.cpu().numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" not in path:
            assert _rel(a, w.cpu().numpy()) <= 0.01, path


# The card's kernel against autograd of the plain version, per scene leaf
# within the JAX package's 0.01: a field where the lanes of a warp hit
# different objects (the scatter's winner groups), the Bilinear textured
# sites, and 4 reflections at refraction_unroll=None (63 sites, the 64-site
# records; pixels of this frame record up to 20).
_CUDA_CASES = {
    "seventy_spheres": (lambda: _many_spheres(rtt, 70), rtt.RenderConfig(xres=160, yres=120)),
    "textured_bilinear": (lambda: textured_scene(rtt, 1), rtt.RenderConfig(xres=160, yres=120)),
    "sixty_three_sites": (lambda: _glass_cluster(rtt),
                          rtt.RenderConfig(xres=160, yres=120, max_reflections=4,
                                           refraction_unroll=None)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CUDA_CASES))
def test_cuda_backward_kernel_matches_autograd(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, cfg = _CUDA_CASES[case]
    scene = make().to("cuda")
    rng = np.random.default_rng(6)
    g = Color(*(torch.from_numpy(_f32(rng, cfg.yres, cfg.xres)).cuda() for _ in range(3)))
    got, prim = kb.render_grads_kernel(scene, cfg, g, return_primal=True)
    np.testing.assert_array_equal(_img(prim), _img(kt.render_color_kernel(scene, cfg)))
    assert_leaf_grads_close(scene, got, kb.render_grads_plain(scene, cfg, g), 0.01)


@pytest.mark.cuda
def test_cuda_backward_kernel_repeats_itself():
    """Two launches on the same inputs give finite cotangents within 1e-5
    relative of each other: the warps' sums reach the block and the global
    cotangent by atomics, in an order that changes from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _many_spheres(rtt, 70).to("cuda")
    cfg = rtt.RenderConfig(xres=320, yres=240)
    rng = np.random.default_rng(7)
    g = Color(*(torch.from_numpy(_f32(rng, cfg.yres, cfg.xres)).cuda() for _ in range(3)))
    first, second = (kb.render_grads_kernel(scene, cfg, g) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())
