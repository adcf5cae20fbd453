"""Scenes past 512 objects and ``max_reflections`` past 6 in the port's
kernels (K1-K4), against the plain version and the JAX package.

The JAX package renders such scenes through its jnp path (its Pallas kernels
decline more than 512 objects, ``pallas_trace.py:124``, and fall back,
``:1743-1757``); the port's kernels take them, reading the tables from
global memory above their shared-memory limits (``kernel_trace.
SHARED_TABLE_MAX`` and its siblings) and running a 64-task stack for 7 to
11 reflections. On the CPU: the kernels' host builds (which read the tables
where they lie and add straight to the cotangent block, as the global-table
builds do) against the plain version and its autograd on a floor and 599
seeded spheres, and at 8 and 11 reflections; the plain version against the
JAX package's jnp render; the support checks; the CLI's ``-d`` on a
600-object file. The card's kernels run only on a card:
``python -m pytest --noconftest -m cuda tests/test_torch_many.py``.
"""

import os
import types

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import cli
from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
from ray_rust_tpu_torch.models.vec import Color
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march as km
from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
from ray_rust_tpu_torch.ops.rays import fov_scales
from ray_rust_tpu_torch.utils.image import load_png

from .test_torch_kernel_bwd import _host_grads as _trace_host_grads
from .test_torch_kernel_bwd import assert_boundary_only, assert_leaf_grads_close
from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _compare,
    _glass_cluster,
    _img,
    _jax,
    _jax_cfg,
    _many_spheres,
    _port,
    one_torch_thread,
)
from .test_torch_march_grad import _host_grads as _march_host_grads

N_SPHERES = 599  # with the floor, 600 objects
# the step-by-step march (the plain version's), with a step budget: its time
# is its longest lane's steps, and grazing rays crawl to the budget
_MARCH = dict(use_raymarching=True, glow_effect=1.0, march_max_iter=128, march_floor_skip=False)


@pytest.fixture(scope="module")
def big():
    scene = _many_spheres(rtt, N_SPHERES)
    assert scene.objects.count == 600
    return scene


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("many_host")
    return {name: _build.build_host_library(d, name)
            for name in ("trace", "march", "trace_bwd", "march_bwd")}


@pytest.fixture(scope="module")
def plain_48x24(big):
    """The plain trace of the 600-object scene at 48x24 (one for the module)."""
    cfg = rtt.RenderConfig(xres=48, yres=24)
    return cfg, _img(kt.render_color_plain(big, cfg))


def _host_render(lib, fn, scene, cfg, args):
    tables = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    getattr(lib, fn)(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
                     sx, sy, *args, *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def _trace_host(lib, scene, cfg):
    return _host_render(lib, "rt_trace_host", scene, cfg,
                        kt.launch_args(cfg, None, torch.device("cpu"), scene.objects.count))


def test_kernels_take_600_objects(big):
    """Each kernel wrapper takes the 600-object scene, K1 in its
    global-table build (above 480 objects) with the cull, K3, K2 and K4 in
    their shared ones (up to 1 200 and 640); the re-trace oracle keeps the
    JAX function's 64-object cap and names it; a scene past the pack's int32
    words is refused by all four with its reason."""
    trace, march = rtt.RenderConfig(xres=8, yres=8), rtt.RenderConfig(xres=8, yres=8, **_MARCH)
    for mod, cfg in ((kt, trace), (kb, trace), (km, march), (kmb, march)):
        assert mod.unsupported_reason(big, cfg) is None, mod.__name__
    assert "64 objects" in kr.unsupported_reason(big, trace)
    assert kt.cull_on(trace, 600)
    n = big.objects.count
    assert kt.library("trace_fwd", n, kt.SHARED_TABLE_MAX) == "trace_fwd_global"
    assert kt.library("march_fwd", n, km.SHARED_TABLE_MAX) == "march_fwd"
    assert kt.library("trace_bwd", n, kb.SHARED_TABLE_MAX) == "trace_bwd"
    assert kt.library("trace_bwd", 1024, kb.SHARED_TABLE_MAX) == "trace_bwd_global"
    huge = types.SimpleNamespace(objects=types.SimpleNamespace(count=2**27), textures=None)
    for mod, cfg in ((kt, trace), (kb, trace), (km, march), (kmb, march)):
        assert "pack words" in mod.unsupported_reason(huge, cfg), mod.__name__


def test_host_trace_600_objects_matches_plain(libs, big, plain_48x24):
    """K1's host build with the cull (600 > 64) bit for bit against itself
    without it, and against the plain trace within the golden budget
    (tests/test_parity.py:152-214: at most 2% of pixels off by more than
    1e-3, mean at most 0.01; on the CPU the plain version's libm and the
    host build's round a few pixels apart by ~1e-5, on the card the two
    are bit-equal, chip_smoke.py)."""
    cfg, want = plain_48x24
    got = _trace_host(libs["trace"], big, cfg)
    off = _host_render(libs["trace"], "rt_trace_host", big, cfg,
                       kt.launch_args(cfg.with_(pallas_prefilter=False), None,
                                      torch.device("cpu"), big.objects.count))
    np.testing.assert_array_equal(got, off)
    _compare(want, got, frac_budget=0.02, mean_tol=0.01)


def test_host_march_600_objects_matches_plain(libs, big):
    """K3's host build against the plain march at 48x24 (step by step, a
    128-step budget), within the golden budget (tests/test_parity.py:
    152-214): at most 2% of pixels off by more than 1e-3, mean at most
    0.01."""
    cfg = rtt.RenderConfig(xres=48, yres=24, **_MARCH)
    got = _host_render(libs["march"], "rt_march_host", big, cfg,
                       km.launch_args(cfg, None, torch.device("cpu")))
    _compare(_img(km.render_color_plain(big, cfg)), got, frac_budget=0.02, mean_tol=0.01)


def test_plain_600_objects_matches_jax_render(big, plain_48x24):
    """The plain trace against the JAX package's jnp trace (how it renders
    more than 512 objects), eager, within the golden budget; both packages
    build the same scene, leaf for leaf."""
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    rt, _ = _jax()
    cfg, got = plain_48x24
    scene = _many_spheres(rt, N_SPHERES)
    jcfg = _jax_cfg(cfg)
    vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, jcfg)
    ref = _img(trace_image(scene, jcfg, vi, eye))
    a, b = rtt.scene_to_numpy(_port(scene)), rtt.scene_to_numpy(big)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


def _masked_planes(prim, ref, seed, shape):
    """Seeded cotangent planes, zero where the host build's image leaves
    the plain one's (each such pixel on a decision boundary)."""
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.99
    assert_boundary_only(ref, agree)
    rng = np.random.default_rng(seed)
    return Color(*(torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)
                                    * agree.astype(np.float32)) for _ in range(3)))


def test_host_trace_bwd_600_objects_matches_autograd(libs, big):
    """K2's host build (the global-table build's accumulator: every
    cotangent added straight to the block) against autograd of the plain
    trace at 24x16: per scene leaf relative L2 at most 0.01
    (tests/test_pallas_bwd.py:84-96)."""
    cfg = rtt.RenderConfig(xres=24, yres=16)
    ones = Color(*(torch.ones(cfg.yres, cfg.xres) for _ in range(3)))
    _, prim = _trace_host_grads(libs["trace_bwd"], big, cfg, ones)
    g = _masked_planes(prim, _img(kt.render_color_plain(big, cfg)), 0, (cfg.yres, cfg.xres))
    got, _ = _trace_host_grads(libs["trace_bwd"], big, cfg, g)
    assert_leaf_grads_close(big, got, kb.render_grads_plain(big, cfg, g), 0.01)


def test_host_march_bwd_600_objects_matches_autograd(libs, big):
    """K4's host build against autograd of the plain march (its implicit
    VJP) at 16x12: per scene leaf relative L2 at most 0.02
    (tests/test_pallas_bwd.py:306-321)."""
    cfg = rtt.RenderConfig(xres=16, yres=12, **_MARCH)
    ones = Color(*(torch.ones(cfg.yres, cfg.xres) for _ in range(3)))
    _, prim = _march_host_grads(libs["march_bwd"], big, cfg, ones)
    g = _masked_planes(prim, _img(km.render_color_plain(big, cfg)), 1, (cfg.yres, cfg.xres))
    got, _ = _march_host_grads(libs["march_bwd"], big, cfg, g)
    assert_leaf_grads_close(big, got, kmb.render_grads_plain(big, cfg, g), 0.02)


@pytest.mark.parametrize("reflections", [8, 11])
def test_host_trace_deep_reflections_matches_plain(libs, reflections):
    """K1's host build with the 64-task stack against the plain trace on a
    cluster of glass spheres (tests/test_torch_kernel_trace.py's, whose
    refraction sub-traces fill the 16-task stack at 6 reflections) at
    refraction_unroll=7, 32x24, within the golden budget; K1 takes the
    config and K5 (16 tasks) names its stack; at the default unroll K2
    takes it too."""
    scene = _glass_cluster(rtt)
    cfg = rtt.RenderConfig(xres=32, yres=24, max_reflections=reflections, refraction_unroll=7)
    assert 1 + reflections * (reflections - 1) // 2 > kt.STACK_CAP
    assert kt.unsupported_reason(scene, cfg) is None
    assert kb.unsupported_reason(scene, cfg.with_(refraction_unroll=4)) is None
    assert "task stack" in kr.unsupported_reason(scene, cfg)
    got = _trace_host(libs["trace"], scene, cfg)
    assert np.isfinite(got).all()
    _compare(_img(kt.render_color_plain(scene, cfg)), got, frac_budget=0.02, mean_tol=0.01)


@pytest.mark.parametrize("reflections", [8, 11])
def test_plain_deep_reflections_matches_jax_render(reflections):
    """The plain trace at 8 and 11 reflections against the JAX package's
    jnp trace (its kernel unrolls to any depth), eager, within the golden
    budget, on the default scene at refraction_unroll=1 (eager JAX takes
    tens of seconds at the default unroll)."""
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    rt, _ = _jax()
    cfg = rtt.RenderConfig(xres=32, yres=24, max_reflections=reflections, refraction_unroll=1)
    jcfg = _jax_cfg(cfg)
    jax_scene = rt.default_scene()[0]
    vi, eye = camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(trace_image(jax_scene, jcfg, vi, eye))
    _compare(ref, _img(kt.render_color_plain(_port(jax_scene), cfg)), frac_budget=0.02,
             mean_tol=0.01)


def test_deep_reflections_past_the_stack_are_refused():
    """12 reflections need 67 tasks: K1, K2 and K5 refuse with the stack's
    reason; K2 past its largest record cap names the sites."""
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=8, yres=8, max_reflections=12)
    for mod in (kt, kb, kr):
        assert "task stack" in mod.unsupported_reason(scene, cfg), mod.__name__
    assert "sites" in kb.unsupported_reason(scene, cfg.with_(max_reflections=8,
                                                            refraction_unroll=None))


def test_cli_reads_600_object_file(big, tmp_path, monkeypatch):
    """The CLI's ``-d`` on a 600-object scene file at 32x24 on the CPU writes
    the PNG of ``render_u8`` of the file's scene, bit for bit."""
    path, png = tmp_path / "many.yaml", tmp_path / "out.png"
    names = ("floor", "m0", "m1", "m2", "m3")  # _many_spheres's materials
    path.write_text(serialize_scene(big, rtt.SceneMeta(names, (None,) * len(names))))
    monkeypatch.chdir(tmp_path)  # textures would come from the working directory
    assert cli.main(["32", "24", "-d", str(path), "-o", str(png), "--device", "cpu"]) == 0
    loaded, _, caps = deserialize_scene(path.read_text(), device="cpu")
    assert loaded.objects.count == 600
    want = rtt.render_u8(loaded, rtt.RenderConfig(xres=32, yres=24, **caps))
    np.testing.assert_array_equal(load_png(str(png)), want)
    assert os.path.getsize(png) > 0


@pytest.mark.cuda
def test_cuda_kernels_take_600_objects():
    """On the card: K1 (global tables, the cull) bit for bit against the
    plain trace and with the cull off; K3 within the golden budget of the
    plain march; K2 and K4 against autograd of the plain versions within
    relative L2 0.01 and 0.02 per scene leaf, at the host tests' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _many_spheres(rtt, N_SPHERES).to(torch.device("cuda"))
    cfg = rtt.RenderConfig(xres=48, yres=24)
    got = _img(kt.render_color_kernel(scene, cfg))
    np.testing.assert_array_equal(got, _img(kt.render_color_plain(scene, cfg)))
    np.testing.assert_array_equal(got, _img(kt.render_color_kernel(
        scene, cfg.with_(pallas_prefilter=False))))
    mcfg = rtt.RenderConfig(xres=48, yres=24, **_MARCH)
    _compare(_img(km.render_color_plain(scene, mcfg)), _img(km.render_color_kernel(scene, mcfg)),
             frac_budget=0.02, mean_tol=0.01)
    for mod, c, budget in ((kb, rtt.RenderConfig(xres=24, yres=16), 0.01),
                           (kmb, rtt.RenderConfig(xres=16, yres=12, **_MARCH), 0.02)):
        g = Color(*(torch.ones(c.yres, c.xres, device="cuda") for _ in range(3)))
        assert_leaf_grads_close(scene, mod.render_grads_kernel(scene, c, g),
                                mod.render_grads_plain(scene, c, g), budget)


@pytest.mark.cuda
def test_cuda_kernel_max_reflections_8():
    """On the card: K1 with the 64-task stack at 8 reflections, bit for bit
    against the plain trace, at 320x240."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene()[0]
    cfg = rtt.RenderConfig(xres=320, yres=240, max_reflections=8)
    np.testing.assert_array_equal(_img(kt.render_color_kernel(scene, cfg)),
                                  _img(kt.render_color_plain(scene, cfg)))
