"""K1b, the trace kernel's per-tile object cull, against the full scan.

On the CPU: the plain masks (``ops/cull.py``) hold every object a tile's
camera rays hit and every object their first shadow rays meet, and they cull
something; the kernel's host build (``csrc/trace_host.cpp``, the kernel's
own ``cull_object`` in a loop over its 16x16 tiles) writes the same masks
and, with the cull, the full scan's image bit for bit; and it agrees with
the JAX Pallas kernel run with its cull (``pallas_prefilter``) in interpret
mode. The scenes are ``tests/test_pallas.py:170``'s (68 objects: spheres
straddling tiles, behind the camera and far off-frustum, a tilted camera)
and 70 seeded spheres, at 64x32 and at a ragged 333x101. The card's kernel
runs only on a card:
``python -m pytest --noconftest -m cuda tests/test_torch_cull.py``.
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import _build, cull
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops.intersect import F32_EPSILON, object_candidate_t, raycast
from ray_rust_tpu_torch.ops.rays import camera_rays, fov_scales

from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _compare,
    _img,
    _jax,
    _jax_cfg,
    _many_spheres,
    _port,
    one_torch_thread,
)


def prefilter_scene(pkg, **kw):
    """tests/test_pallas.py:170's scene, built by ``pkg`` (either package):
    a floor, 40 spheres in the frustum, 3 behind the camera or far to the
    sides and 24 seeded ones behind, under a tilted camera."""
    rng = np.random.default_rng(17)
    mats = [pkg.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0))] + [
        pkg.MaterialSpec(name=f"m{i}", diffuse=tuple(rng.uniform(0.2, 1.0, 3)),
                         specular=(0.3, 0.3, 0.3), pn=8)
        for i in range(4)
    ]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0))]
    objs += [
        pkg.SphereSpec(f"m{int(rng.integers(4))}", float(rng.uniform(20, 60)),
                       tuple(rng.uniform(-400, 400, 3) * np.array([1, 0.3, 1])
                             + np.array([0, -150, 400])))
        for _ in range(40)
    ]
    objs += [
        pkg.SphereSpec("m0", 50.0, (0.0, -150.0, -900.0)),
        pkg.SphereSpec("m1", 50.0, (3000.0, -150.0, 100.0)),
        pkg.SphereSpec("m2", 50.0, (-3000.0, 500.0, 100.0)),
    ] + [
        pkg.SphereSpec(f"m{int(rng.integers(4))}", float(rng.uniform(20, 60)),
                       tuple(rng.uniform(-3000, 3000, 3) * np.array([1, 0.3, 1])
                             + np.array([0, -150, -1200])))
        for _ in range(24)
    ]
    scene, _ = pkg.build_scene(mats, objs, (7.0, -150.0, -300.0),
                               (0.1, -np.pi / 2 + 0.2, -np.pi / 2), (50.0, 60.0, -50.0), **kw)
    return scene


# the JAX test's config (tests/test_pallas.py:210), and the default depths
# at a ragged size (333 = 20*16 + 13 columns, 101 = 6*16 + 5 rows)
_CFGS = {"64x32": rtt.RenderConfig(xres=64, yres=32, max_reflections=2, refraction_unroll=1),
         "333x101": rtt.RenderConfig(xres=333, yres=101)}
_SCENES = {"pallas_170": lambda: prefilter_scene(rtt, device="cpu"),
           "seventy": lambda: _many_spheres(rtt, 70)}
_CASES = [(s, c) for s in sorted(_SCENES) for c in sorted(_CFGS)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("trace_host"))


@pytest.fixture(scope="module")
def scenes():
    return {k: make() for k, make in _SCENES.items()}


def _host_render(lib, scene, cfg, cull_switch, ops=None):
    """The host build's image, with K1b's cull on or off."""
    tables = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    args = kt.kernel_args(cfg) + kt.texture_args(None, torch.device("cpu")) + [int(cull_switch)]
    lib.rt_trace_host(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
                      sx, sy, *args, *(p.data_ptr() for p in out),
                      None if ops is None else ops.data_ptr())
    return out.permute(1, 2, 0).numpy()


def _host_masks(lib, scene, cfg, col0, row0):
    """The host build's two masks of one tile, as boolean ``(N,)`` tensors."""
    tables = kt.pack_scene(scene)
    n = scene.objects.count
    words = [torch.zeros((n + 31) // 32, dtype=torch.int32) for _ in range(2)]
    sx, sy = fov_scales(cfg)
    lib.rt_cull_masks_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
                           col0, row0, words[0].data_ptr(), words[1].data_ptr())
    bit = torch.arange(n) % 32
    return tuple(((w[torch.arange(n) // 32] >> bit) & 1).bool() for w in words)


def _reached(scene, cfg):
    """Per pixel, the objects its camera ray hits (any root, ``(N, H, W)``)
    and those its first shadow ray meets (from its first hit, along the
    light, the hit object skipped), as the plain trace casts them."""
    objs = scene.objects
    vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, cfg)
    flags = torch.zeros(eye.shape, dtype=torch.int32)
    inf = torch.full(eye.shape, float("inf"))

    def each(org_vi, direction, ig):
        return torch.stack([
            torch.isfinite(object_candidate_t(objs.kind[i], objs.org.take(i), objs.radius[i],
                                              objs.normal.take(i), org_vi, direction, inf,
                                              flags)) & (ig != i)
            for i in range(objs.count)])

    none = torch.full(eye.shape, -1, dtype=torch.int32)
    prim = each(vi, eye, none)
    t, idx = raycast(scene, vi, eye, none, flags)
    hit = torch.isfinite(t)
    pt = vi + eye * torch.where(hit, t, 0.0)
    light = scene.light.broadcast_to(eye.shape)
    shadow = each(pt + light * F32_EPSILON, light, idx) & hit
    return prim, shadow


@pytest.mark.parametrize("scene_name,size", _CASES)
def test_plain_masks_are_conservative_and_cull(scenes, scene_name, size):
    """Exact containment, no tolerance: every object a camera ray of a
    16x16 tile hits at any root is in the tile's primary mask, and every
    object its first shadow ray meets (not only the nearest) in its shadow
    mask; on the first scene some tile's primary mask leaves objects out."""
    scene, cfg = scenes[scene_name], _CFGS[size]
    prim, shadow = _reached(scene, cfg)
    smallest = scene.objects.count
    for col0, row0 in cull.tiles(cfg):
        pm, sm = cull.tile_masks(scene, cfg, col0, row0)
        tile = (slice(None), slice(row0, row0 + cull.TILE), slice(col0, col0 + cull.TILE))
        assert not (prim[tile].flatten(1).any(1) & ~pm).any(), (col0, row0)
        assert not (shadow[tile].flatten(1).any(1) & ~sm).any(), (col0, row0)
        smallest = min(smallest, int(pm.sum()))
    if scene_name == "pallas_170":
        assert smallest < scene.objects.count


@pytest.mark.parametrize("scene_name,size", _CASES)
def test_host_masks_equal_plain_masks(host_lib, scenes, scene_name, size):
    """Bit for bit, tile for tile: the kernel body's cull_object (the host
    build's loop in place of the warps' ballots) against ops/cull.py."""
    scene, cfg = scenes[scene_name], _CFGS[size]
    for col0, row0 in cull.tiles(cfg):
        want = cull.tile_masks(scene, cfg, col0, row0)
        got = _host_masks(host_lib, scene, cfg, col0, row0)
        for w, g in zip(want, got):
            assert torch.equal(w, g), (col0, row0)


@pytest.mark.parametrize("scene_name,size", _CASES)
def test_host_cull_bit_equal_to_full_scan(host_lib, scenes, scene_name, size):
    """The twin of tests/test_pallas.py:170, bit for bit: the host build with
    the cull renders the full scan's image (and the full scan the plain
    version's within the golden budget)."""
    scene, cfg = scenes[scene_name], _CFGS[size]
    on = _host_render(host_lib, scene, cfg, True)
    off = _host_render(host_lib, scene, cfg, False)
    assert np.isfinite(on).all()
    np.testing.assert_array_equal(on, off)


def test_counting_build_counts_the_cull(host_lib, tmp_path, scenes):
    """The -DRT_COUNT_OPS build with the cull renders the same image and
    counts the objects tested (slot 3: N a tile), one primary scan a pixel
    (slot 5) over fewer candidates than N (slot 4), and the shadow scans of
    the pixels that hit (slots 6, 7); without the cull those slots stay 0."""
    lib = _build.build_host_library(tmp_path, "trace", count_ops=True)
    scene, cfg = scenes["pallas_170"], _CFGS["64x32"]
    n, pixels = scene.objects.count, cfg.xres * cfg.yres
    ops = torch.zeros(8, dtype=torch.int64)
    np.testing.assert_array_equal(_host_render(lib, scene, cfg, True, ops),
                                  _host_render(host_lib, scene, cfg, True))
    assert ops[3] == n * len(cull.tiles(cfg))
    assert ops[5] == pixels and 0 < ops[4] < n * pixels
    assert 0 < ops[7] <= pixels and 0 < ops[6] < n * ops[7]
    off = torch.zeros(8, dtype=torch.int64)
    _host_render(lib, scene, cfg, False, off)
    assert not off[3:].any() and off[0] > ops[0]


def test_cull_regime():
    """K1 takes the cull above 64 objects with ``pallas_prefilter`` (the JAX
    kernel's rule, pallas_trace.py:1336), and passes the switch to its host
    build last among its arguments."""
    cfg = rtt.RenderConfig(xres=8, yres=8)
    assert not kt.cull_on(cfg, 64) and kt.cull_on(cfg, 65)
    assert not kt.cull_on(cfg.with_(pallas_prefilter=False), 600)
    assert kt.launch_args(cfg, None, torch.device("cpu"), 68)[-1] == 1
    assert kt.launch_args(cfg, None, torch.device("cpu"), 5)[-1] == 0


@pytest.fixture(scope="module")
def jax_prefilter_image():
    """The JAX kernel with its cull on test_pallas.py:170's scene at its
    config, in interpret mode (one JAX call for the module)."""
    rt, pallas_trace = _jax()
    cfg = _CFGS["64x32"]
    jcfg = _jax_cfg(cfg).with_(pallas_prefilter=True)
    scene = prefilter_scene(rt)
    assert scene.objects.count > 64  # the JAX kernel's cull regime
    return _img(pallas_trace.render_color_pallas(scene, jcfg, interpret=True)), scene


def test_host_cull_matches_jax_kernel_with_its_cull(host_lib, jax_prefilter_image):
    """The golden budget (tests/test_parity.py:152-214): at most 2% of pixels
    off by more than 1e-3, mean difference at most 0.01."""
    ref, jax_scene = jax_prefilter_image
    got = _host_render(host_lib, _port(jax_scene), _CFGS["64x32"], True)
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


@pytest.mark.cuda
def test_kernel_cull_bit_equal_on_card():
    """On the card: K1 with the cull (the default above 64 objects) renders
    K1 without it bit for bit, on both scenes at both sizes and at 1920x1080."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for make in _SCENES.values():
        scene = make().to(torch.device("cuda"))
        for cfg in list(_CFGS.values()) + [rtt.RenderConfig(xres=1920, yres=1080)]:
            on = _img(kt.render_color_kernel(scene, cfg))
            off = _img(kt.render_color_kernel(scene, cfg.with_(pallas_prefilter=False)))
            np.testing.assert_array_equal(on, off)
