"""Textured march in the PyTorch port: the march kernels (K3, K4) reading
the texture atlas, against the plain textured march and the JAX package.

The JAX package's march kernel declines textures and renders them through
its jnp march, differentiated by its implicit VJP; the port's plain march
computes the same function (tests/test_torch_texture.py:
test_plain_textured_march_matches_jax). This file holds:

- K3's per-pixel body (``csrc/march_body.cuh``) built for the host with g++
  on textured scenes, Nearest and Bilinear, floor tail on and off, against
  the plain textured march within the golden budget (they differ where
  powf and torch.pow round apart: the card, where the two agree, holds K3
  with the tail off bit-equal to the plain version at 1280x720,
  ``chip_smoke.py``); the tail on against off bit for bit, since the tail
  declines a shaded march toward a textured floor;
- K4's body (``csrc/march_bwd_body.cuh``, its textured instance) against
  autograd of the plain textured march, per scene leaf within relative L2
  0.02 on the pixels where the forwards agree (tests/test_pallas_bwd.py:
  306-321), its image K3's body's bit for bit;
- the plain textured march's gradient against ``jax.vjp`` of the eager JAX
  ``trace_image`` (``march_chunk=1``) under the same budget.

The card runs the kernels in ``python -m pytest --noconftest -m cuda
tests/test_torch_march_texture.py``.
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.vec import Color
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march as km
from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops.rays import fov_scales

from .test_torch_kernel_bwd import _rel, assert_boundary_only, assert_leaf_grads_close
from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    one_torch_thread, textured_scene, two_texture_scene)
from .test_torch_march_grad import _VJP_KW, _img, _jax_fwd, _port

CPU = torch.device("cpu")
# the plain march's budget at these sizes; the step-by-step march crawls to
# it on horizon rays (tests/test_torch_march.py's host cases)
_MARCH = dict(use_raymarching=True, glow_effect=1.0, march_max_iter=2000)
_SCENES = {"nearest": lambda: textured_scene(rtt, 0),
           "bilinear": lambda: textured_scene(rtt, 1),
           "two_textures": lambda: two_texture_scene(rtt)}


@pytest.fixture(scope="module")
def march_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("march_host"), "march")


@pytest.fixture(scope="module")
def march_bwd_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("march_bwd_host"), "march_bwd")


def _host_render(lib, scene, cfg):
    """K3's body on the CPU: the image, (H, W, 3)."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    out = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_host(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
                      *kt.window(cfg), sx, sy, *km.launch_args(cfg, tex, CPU),
                      *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def _host_grads(lib, scene, cfg, g):
    """K4's body on the CPU: the table cotangents and the image."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    n = scene.objects.count
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres,
                          *kt.window(cfg), sx, sy,
                          *kmb.launch_args(cfg, tex, CPU), *(c.data_ptr() for c in g),
                          block.data_ptr(), *(p.data_ptr() for p in prim), None)
    return kb.split_block(block, n), prim.permute(1, 2, 0).numpy()


@pytest.fixture(scope="module")
def plain_images():
    """The plain textured march of each scene at 48x36 (the tail is a
    kernel switch: the plain version has none)."""
    cfg = rtt.RenderConfig(xres=48, yres=36, **_MARCH)
    return cfg, {name: _img(km.render_color_plain(make(), cfg)) for name, make in _SCENES.items()}


@pytest.mark.parametrize("case", sorted(_SCENES))
@pytest.mark.parametrize("tail", [True, False], ids=["tail", "stepped"])
def test_host_build_of_textured_march_matches_plain(march_lib, plain_images, case, tail):
    """The golden budget (2% of pixels > 1e-3, mean 0.01); the texture shows
    (the image is not the untextured scene's)."""
    cfg, plain = plain_images
    scene = _SCENES[case]()
    got = _host_render(march_lib, scene, cfg.with_(march_floor_skip=tail))
    diff = np.abs(got - plain[case])
    assert np.isfinite(got).all()
    assert (diff.max(-1) > 1e-3).mean() <= 0.02 and diff.mean() <= 0.01
    untextured = scene._replace(textures=None)
    assert np.abs(got - _host_render(march_lib, untextured, cfg)).max() > 0.1


def test_floor_tail_on_textured_floors(march_lib, march_bwd_lib):
    """Tail on against off at 64x48, Nearest and Bilinear: bit for bit, the
    image and K4's cotangents, since a shaded march toward a textured floor
    takes no tail (csrc/march_body.cuh:textured_floor). With the tail, the
    Nearest floor's camera.rotation.z came to relative L2 0.018 of the march
    gradient budget's 0.02 at 160x120."""
    cfg = rtt.RenderConfig(xres=64, yres=48, **_MARCH)
    rng = np.random.default_rng(3)
    g = Color(*(torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
                for _ in range(3)))
    for make in (_SCENES["nearest"], _SCENES["bilinear"]):
        scene = make()
        on, off = (_host_render(march_lib, scene, cfg.with_(march_floor_skip=t))
                   for t in (True, False))
        np.testing.assert_array_equal(on, off)
        (g_on, p_on), (g_off, p_off) = (
            _host_grads(march_bwd_lib, scene, cfg.with_(march_floor_skip=t), g)
            for t in (True, False))
        np.testing.assert_array_equal(p_on, on)
        for a, b in zip(g_on, g_off):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_host_build_of_textured_march_backward_matches_autograd(march_lib, march_bwd_lib, filt):
    """tests/test_pallas_bwd.py:116-138's scene at 16x12 under the march
    gradient settings (:279-283), the floor tail on: the forwards agree on
    more than 90% of pixels, each other one on a decision boundary, and
    every leaf is within relative L2 0.02 of autograd of the plain march."""
    scene = textured_scene(rtt, filt, camera=(0.37, -150.3, -300.0))
    cfg = rtt.RenderConfig(**_VJP_KW, glow_effect=1.0)
    assert kmb.kernel_supported(scene, cfg)
    rng = np.random.default_rng(filt)
    planes = [torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
              for _ in range(3)]
    _, prim = _host_grads(march_bwd_lib, scene, cfg, planes)
    np.testing.assert_array_equal(prim, _host_render(march_lib, scene, cfg))
    ref = _img(km.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.9
    assert_boundary_only(ref, agree)
    g = Color(*(p * torch.from_numpy(agree) for p in planes))
    got, _ = _host_grads(march_bwd_lib, scene, cfg, g)
    want = kmb.render_grads_plain(scene, cfg, g)
    assert_leaf_grads_close(scene, got, want, 0.02)
    if filt == 1:  # the Bilinear floor's uv moves the image: its origin gets a gradient
        assert float(kb.leaf_grads(scene, want)["objects.org.z"].abs().sum()) > 0


def test_plain_textured_march_gradient_matches_jax_vjp():
    """Autograd of the plain textured march (Bilinear floor) against
    ``jax.vjp`` of the JAX package's eager jnp march at 16x12, per scene
    leaf within relative L2 0.02 on the pixels where the forwards agree."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt
    from ray_rust_tpu.models.vec import Color as JaxColor

    jax_scene = textured_scene(rt, 1, camera=(0.37, -150.3, -300.0))
    cfg = rtt.RenderConfig(**_VJP_KW, glow_effect=1.0)
    jax_img, vjp = jax.vjp(_jax_fwd(cfg), jax_scene)
    jax_img = _img(jax_img)
    scene = _port(jax_scene)
    paths = list(rtt.scene_to_numpy(scene))
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    params = {p: t for p, t in zip(paths, leaves) if t.requires_grad}
    img = rtt.render_color(scene.with_tensors(leaves), cfg)
    agree = np.abs(_img(img) - jax_img).max(-1) < 1e-4
    assert agree.mean() > 0.9, f"forwards agree on {agree.mean():.0%}"
    assert_boundary_only(jax_img, agree)

    rng = np.random.default_rng(0)
    planes = [rng.standard_normal(agree.shape).astype(np.float32) * agree for _ in range(3)]
    (ct,) = vjp(JaxColor(*map(jnp.asarray, planes)))
    want = rtt.scene_to_numpy(ct)
    got = torch.autograd.grad(tuple(img), list(params.values()),
                              tuple(map(torch.from_numpy, planes)), allow_unused=True)
    for (path, t), gr in zip(params.items(), got):
        a = np.zeros(t.shape, np.float32) if gr is None else gr.numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" in path:
            continue
        rel = _rel(a, want[path])
        assert rel < 0.02, f"{path}: relative L2 {rel:.2e}"
    assert np.linalg.norm(want["objects.org.z"]) > 0  # the texture's uv reaches the floor


def test_textured_march_reasons():
    """Textured march is taken by both kernels, also a bank past TEXTURE_MAX
    textures (their global-table builds) and an atlas of 2^31 texels or more
    (the kernels' texel index is 64-bit)."""
    cfg = rtt.RenderConfig(xres=8, yres=8, **_MARCH)
    scene = textured_scene(rtt, 1)
    assert km.unsupported_reason(scene, cfg) is None
    assert kmb.unsupported_reason(scene, cfg) is None
    tex = np.zeros((1, 1, 3), np.uint8)
    n = kt.TEXTURE_MAX + 1
    many, _ = rtt.build_scene([rtt.MaterialSpec(name=f"t{i}", texture=tex) for i in range(n)],
                              [rtt.SphereSpec("t0", 10.0, (0.0, 0.0, 50.0))],
                              (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device="cpu")
    atlas = many._replace(textures=many.textures._replace(
        packed=torch.empty((2, 2**15, 2**15, 0), dtype=torch.int32)))
    for mod in (km, kmb):
        assert mod.unsupported_reason(many, cfg) is None
        assert mod.unsupported_reason(atlas, cfg) is None


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_cuda_textured_march_kernels(filt):
    """K3 with the tail off bit-equal to the plain textured march; K4's image
    K3's; a textured march gradient goes through K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = textured_scene(rtt, filt).to("cuda")
    cfg = rtt.RenderConfig(xres=64, yres=48, march_floor_skip=False, **_MARCH)
    before = km.LAUNCHES
    got = _img(rtt.render_color(scene, cfg))
    assert km.LAUNCHES == before + 1
    np.testing.assert_array_equal(got, _img(km.render_color_plain(scene, cfg)))
    rng = np.random.default_rng(filt)
    g = Color(*(torch.from_numpy(rng.uniform(-1, 1, (48, 64)).astype(np.float32)).cuda()
                for _ in range(3)))
    before = kmb.LAUNCHES
    grads, prim = kmb.render_grads_kernel(scene, cfg, g, return_primal=True)
    torch.cuda.synchronize()
    assert kmb.LAUNCHES == before + 1
    np.testing.assert_array_equal(_img(prim), got)
    assert all(torch.isfinite(t).all() for t in grads)
