"""March-mode gradients of the PyTorch port against the JAX package.

The port's CPU march gradient is torch autograd of the plain march around
the implicit VJP (``ops/march.py:_ImplicitMarch``, the counterpart of
``_march_while_vjp``), and the march backward kernel (K4,
``ops/kernel_march_bwd.py``) is held against it. This file holds:

- the plain gradient against ``jax.vjp`` of the JAX package's jnp march, glow
  on and off, per scene leaf on the pixels where the two forwards agree to
  1e-4 (every other pixel on a decision boundary), relative L2 within 0.02:
  the march budget of tests/test_pallas_bwd.py:263-321, at its settings
  (raymarch_max_reflections=2, max_refractions=1, refraction_unroll=1,
  march_max_iter=512, the camera moved to x = 0.37);
- the twins of tests/test_grad.py:235-277: the implicit gradient of sphere
  3's ``org.y`` and, with glow, of its radius against the JAX package's
  scan-mode gradient (``differentiable=True``, ``march_budget=256``), at
  rtol 5e-3 and 0.1;
- the static lap-site tree and the raymarch calls against
  ``_march_unroll_nodes`` and ``_glow_sid_map``, and the kernel's site cap;
- K4's per-pixel body (``csrc/march_bwd_body.cuh``) built for the host with
  g++ against autograd of the plain march, per leaf within 1e-3, glow on and
  off at refraction depths 1 and 4, its image against the plain forward.

Every JAX computation runs eagerly at 16x12 in this one process, so they
share their compiles; ``march_chunk=1`` keeps the JAX while loop's body
small. The kernel runs only on a card:
``python -m pytest --noconftest -m cuda tests/test_torch_march_grad.py``.
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
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

W, H = 16, 12
# tests/test_pallas_bwd.py:279-283's settings
_VJP_KW = dict(xres=W, yres=H, use_raymarching=True, raymarch_max_reflections=2,
               max_refractions=1, refraction_unroll=1, march_max_iter=512)
# tests/test_grad.py:240-241's
_TWIN_KW = dict(xres=W, yres=H, use_raymarching=True, max_refractions=1, march_max_iter=512)


def _img(col):
    """(H, W, 3) numpy image from a Color of either package."""
    return np.stack([c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
                     for c in col], -1)


def _jax_fwd(cfg, **extra):
    """The JAX package's jnp render of a scene under the port config
    ``cfg`` (eager), with the JAX-only settings ``extra``."""
    import dataclasses

    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    jcfg = rt.RenderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                           march_tiles=1, march_chunk=1, **extra)

    def fwd(s):
        vi, eye = camera_rays(s.camera.position, s.camera.rotation, jcfg)
        return trace_image(s, jcfg, vi, eye)
    return fwd


def _port(jax_scene):
    return rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")


@pytest.fixture(scope="module", params=["glow", "no_glow"])
def jax_vjp_case(request):
    """The JAX scene (camera at x = 0.37), its jnp image and its vjp."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt

    scene, _ = rt.default_scene()
    scene = scene._replace(camera=scene.camera._replace(
        position=scene.camera.position._replace(x=jnp.float32(0.37))))
    cfg = rtt.RenderConfig(**_VJP_KW, glow_effect=1.0 if request.param == "glow" else None)
    img, vjp = jax.vjp(_jax_fwd(cfg), scene)
    return scene, cfg, _img(img), vjp


def test_plain_march_gradient_matches_jax_vjp(jax_vjp_case):
    import jax.numpy as jnp

    from ray_rust_tpu.models.vec import Color as JaxColor

    jax_scene, cfg, jax_img, vjp = jax_vjp_case
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


# -- twins of tests/test_grad.py:235-277: implicit VJP vs JAX scan mode -------

def _port_grad(cfg, edit, x0):
    """d/dx mean(r + g + b) of the port's render of the default scene, with
    ``edit(scene, x)`` placing the parameter."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    img = rtt.render_color(edit(rtt.default_scene(device="cpu")[0], x), cfg)
    return float(torch.autograd.grad((img.r + img.g + img.b).mean(), x)[0])


def _jax_scan_grad(cfg, edit, x0):
    """The same derivative by reverse-mode AD through the JAX package's
    fixed-budget scan march (its gradient oracle)."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt

    fwd = _jax_fwd(cfg, differentiable=True, march_budget=256)
    scene, _ = rt.default_scene()

    def loss(x):
        img = fwd(edit(scene, x))
        return jnp.mean(img.r + img.g + img.b)
    return float(jax.grad(loss)(jnp.float32(x0)))


def _set_org_y3(scene, y):
    objs = scene.objects
    if isinstance(y, torch.Tensor):
        oy = torch.cat([objs.org.y[:3], y.reshape(1), objs.org.y[4:]])
    else:
        oy = objs.org.y.at[3].set(y)
    return scene._replace(objects=objs._replace(org=objs.org._replace(y=oy)))


def _set_radius3(scene, r):
    objs = scene.objects
    if isinstance(r, torch.Tensor):
        radius = torch.cat([objs.radius[:3], r.reshape(1), objs.radius[4:]])
    else:
        radius = objs.radius.at[3].set(r)
    return scene._replace(objects=objs._replace(radius=radius))


def test_march_implicit_vjp_matches_scan():
    """Geometry only: the hit point is an SDF root, so the implicit gradient
    equals the unrolled one up to the march's convergence."""
    cfg = rtt.RenderConfig(**_TWIN_KW)
    y0 = float(rtt.default_scene(device="cpu")[0].objects.org.y[3])
    np.testing.assert_allclose(_port_grad(cfg, _set_org_y3, y0),
                               _jax_scan_grad(cfg, _set_org_y3, y0), rtol=5e-3)


def test_march_implicit_vjp_glow_contract():
    """Glow: endpoint-argmin lanes through the hit point's implicit
    gradient, interior-argmin lanes by the envelope; the same sign and order
    as the discrete scan derivative."""
    cfg = rtt.RenderConfig(**_TWIN_KW, glow_effect=1.0)
    got = _port_grad(cfg, _set_radius3, 80.0)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, _jax_scan_grad(cfg, _set_radius3, 80.0), rtol=0.1)


# -- the site tree and the support check -------------------------------------

def test_march_site_tree_matches_jax():
    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.pallas_bwd import _count_sites, _glow_sid_map, _march_unroll_nodes

    for kw in (dict(), dict(refraction_unroll=None), dict(raymarch_max_reflections=2,
               max_refractions=1, refraction_unroll=1), dict(refraction_unroll=2),
               dict(raymarch_max_reflections=5, refraction_unroll=2)):
        nodes = _march_unroll_nodes(rt.RenderConfig(use_raymarching=True, **kw))
        cfg = rtt.RenderConfig(use_raymarching=True, **kw)
        assert kmb.count_sites(cfg) == _count_sites(nodes)
        assert kmb.count_frames(cfg) == len(_glow_sid_map(nodes, _count_sites(nodes)))
    cfg = rtt.RenderConfig(use_raymarching=True)
    assert (kmb.count_sites(cfg), kmb.count_frames(cfg)) == (11, 8)
    assert kmb.count_sites(cfg.with_(refraction_unroll=None)) == kmb.SITE_CAP == 35


def test_march_unsupported_reason_adds_the_site_cap():
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=8, use_raymarching=True, glow_effect=1.0)
    assert kmb.unsupported_reason(scene, cfg) is None
    assert kmb.unsupported_reason(scene, cfg.with_(refraction_unroll=None)) is None
    assert "laps" in kmb.unsupported_reason(scene, cfg.with_(raymarch_max_reflections=4,
                                                             refraction_unroll=None))
    assert "K1" in kmb.unsupported_reason(scene, cfg.with_(use_raymarching=False))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmb.render_grads_kernel(scene, cfg, Color(*(torch.zeros(8, 8) for _ in range(3))))
    assert kmb.LAUNCHES == 0


# -- K4's body built for the host --------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("march_bwd_host"), "march_bwd")


def _host_grads(lib, scene, cfg, g):
    """The host build's table cotangents and image for cotangent planes g."""
    tables = kt.pack_scene(scene)
    n = tables[0].shape[0]
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
                          *kmb.kernel_args(cfg), *(c.data_ptr() for c in g), block.data_ptr(),
                          *(p.data_ptr() for p in prim), None)
    return kb.split_block(block, n), np.stack([p.numpy() for p in prim], -1)


@pytest.mark.parametrize("glow", [1.0, None], ids=["glow", "no_glow"])
@pytest.mark.parametrize("depth", [1, 4])
def test_host_build_of_march_backward_matches_autograd(host_lib, glow, depth):
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=32, yres=24, use_raymarching=True, glow_effect=glow,
                           march_max_iter=512, refraction_unroll=depth)
    assert kmb.kernel_supported(scene, cfg)
    rng = np.random.default_rng(depth)
    planes = [torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
              for _ in range(3)]
    _, prim = _host_grads(host_lib, scene, cfg, planes)
    ref = _img(km.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.99
    assert_boundary_only(ref, agree)
    g = Color(*(p * torch.from_numpy(agree) for p in planes))
    got, _ = _host_grads(host_lib, scene, cfg, g)
    assert_leaf_grads_close(scene, got, kmb.render_grads_plain(scene, cfg, g), 1e-3)


@pytest.mark.cuda
def test_cuda_march_gradient_goes_through_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=1.0,
                           march_max_iter=2000)
    rng = np.random.default_rng(5)
    g = Color(*(torch.from_numpy(rng.uniform(-1, 1, (48, 64)).astype(np.float32)).cuda()
                for _ in range(3)))
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    params = [t for t in leaves if t.requires_grad]
    before = (km.LAUNCHES, kmb.LAUNCHES)
    img = rtt.render_color(scene.with_tensors(leaves), cfg)
    got = torch.autograd.grad(tuple(img), params, tuple(g), allow_unused=True)
    torch.cuda.synchronize()
    assert (km.LAUNCHES, kmb.LAUNCHES) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(_img(img), _img(km.render_color_plain(scene, cfg)))
    want = kb.leaf_grads(scene, kmb.render_grads_plain(scene, cfg, g))
    for (path, w), gr in zip(want.items(), got):
        a = np.zeros(w.shape, np.float32) if gr is None else gr.cpu().numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" not in path:
            assert _rel(a, w.cpu().numpy()) <= 0.02, path
