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

    jcfg = rt.RenderConfig(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                              "march_tiles": 1, "march_chunk": 1, **extra})

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


# -- the port's scan-mode march (cfg.differentiable) -------------------------

def _org_x_grad_port(cfg):
    """d mean(r + g + b) / d objects.org.x of the port's default scene."""
    scene = rtt.default_scene(device="cpu")[0]
    ox = scene.objects.org.x.clone().requires_grad_()
    img = rtt.render_color(scene._replace(objects=scene.objects._replace(
        org=scene.objects.org._replace(x=ox))), cfg)
    return torch.autograd.grad((img.r + img.g + img.b).mean(), ox)[0].numpy()


def test_scan_march_matches_jax_scan():
    """Twin of tests/test_grad.py:218 (``differentiable=True``,
    ``march_budget=64``, glow): the port's scan gradient of every sphere's
    and the floor's ``org.x`` is finite and not all zero, and within 1e-4
    relative L2 of the JAX package's scan gradient. The JAX gradient is
    compiled with XLA's backend optimisations off: a default build
    contracts to FMAs and moves this vector by 1.8e-4 (its eager run, 200 s
    here, agrees with the port to 1.7e-7)."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt

    cfg = rtt.RenderConfig(xres=W, yres=H, use_raymarching=True, glow_effect=1.0,
                           max_refractions=1, differentiable=True, march_budget=64)
    got = _org_x_grad_port(cfg)
    assert np.all(np.isfinite(got)) and np.any(got != 0.0)
    fwd = _jax_fwd(cfg)
    scene, _ = rt.default_scene()

    def loss(ox):
        img = fwd(scene._replace(objects=scene.objects._replace(
            org=scene.objects.org._replace(x=ox))))
        return jnp.mean(img.r + img.g + img.b)

    x0 = scene.objects.org.x
    want = np.asarray(jax.jit(jax.grad(loss)).lower(x0).compile(
        {"xla_backend_optimization_level": 0})(x0))
    assert _rel(got, want) <= 1e-4, (got, want)


def test_march_implicit_vjp_matches_port_scan():
    """The implicit VJP against the port's own scan (budget 256), as
    tests/test_grad.py:235-255 holds the JAX package's: sphere 3's ``org.y``,
    rtol 5e-3."""
    cfg = rtt.RenderConfig(**_TWIN_KW)
    y0 = float(rtt.default_scene(device="cpu")[0].objects.org.y[3])
    scan = _port_grad(cfg.with_(differentiable=True, march_budget=256), _set_org_y3, y0)
    np.testing.assert_allclose(_port_grad(cfg, _set_org_y3, y0), scan, rtol=5e-3)


def test_scan_march_is_a_mode_no_kernel_runs():
    """``differentiable`` routes a march to the plain version on either
    device; the march kernels refuse it; exhausted lanes count as escaped
    (``iter = march_max_iter + 1``, ``final_dist = 2 far_away``)."""
    from ray_rust_tpu_torch.models.vec import v3
    from ray_rust_tpu_torch.ops.march import march_single

    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=8, yres=6, use_raymarching=True, differentiable=True,
                           march_budget=3)
    assert "scan-mode" in km.unsupported_reason(scene, cfg)
    assert "scan-mode" in kmb.unsupported_reason(scene, cfg)
    # a ray along the floor from far away: three steps do not settle it
    res = march_single(scene, cfg, v3(0.0, -49.0, -3000.0), v3(0.0, 0.0, 1.0), -1)
    assert int(res.iter) == cfg.march_max_iter + 1
    assert float(res.final_dist) == 2 * cfg.far_away
    ref = march_single(scene, cfg.with_(differentiable=False), v3(0.0, -49.0, -3000.0),
                       v3(0.0, 0.0, 1.0), -1)
    assert int(ref.iter) > 3


def test_scan_residual_bytes_bound_and_refusal(monkeypatch):
    """``scan_residual_bytes`` bounds what autograd saves for a scan march
    (its docstring's measurement), and a march past ``SCAN_MAX_BYTES`` raises
    before it runs."""
    from ray_rust_tpu_torch.ops import march as march_mod
    from ray_rust_tpu_torch.ops.rays import camera_rays

    scene = _glowing_sphere_field()
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    scene = scene.with_tensors(leaves)

    def saved_bytes(budget):
        cfg = rtt.RenderConfig(xres=W, yres=H, use_raymarching=True, glow_effect=1.0,
                               differentiable=True, march_budget=budget)
        vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, cfg)
        seen, total = set(), [0]

        def pack(t):
            if t.untyped_storage().data_ptr() not in seen:
                seen.add(t.untyped_storage().data_ptr())
                total[0] += t.untyped_storage().nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            march_mod.march_single(scene, cfg, vi, eye, -1)
        return total[0]

    n = scene.objects.count
    per_step = (saved_bytes(8) - saved_bytes(4)) / 4
    assert 0.5 * march_mod.scan_residual_bytes(n, W * H, 1) <= per_step
    assert per_step <= march_mod.scan_residual_bytes(n, W * H, 1)
    monkeypatch.setattr(march_mod, "SCAN_MAX_BYTES", march_mod.scan_residual_bytes(n, W * H, 7))
    cfg = rtt.RenderConfig(xres=W, yres=H, use_raymarching=True, differentiable=True,
                           march_budget=8)
    with pytest.raises(ValueError, match="SCAN_MAX_BYTES"):
        rtt.render_color(scene, cfg)


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
    # 63 laps: the buffer instance; past the record buffer the laps are named
    assert kmb.unsupported_reason(scene, cfg.with_(raymarch_max_reflections=4,
                                                   refraction_unroll=None)) is None
    assert kmb.buffered(cfg.with_(raymarch_max_reflections=4, refraction_unroll=None))
    assert "laps" in kmb.unsupported_reason(scene, cfg.with_(raymarch_max_reflections=10**6,
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
    lib.rt_march_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres,
                          *kt.window(cfg), sx, sy,
                          *kmb.launch_args(cfg, None, torch.device("cpu")),
                          *(c.data_ptr() for c in g), block.data_ptr(),
                          *(p.data_ptr() for p in prim), None)
    return kb.split_block(block, n), np.stack([p.numpy() for p in prim], -1)


@pytest.mark.parametrize("glow", [1.0, None], ids=["glow", "no_glow"])
@pytest.mark.parametrize("depth", [1, 4])
def test_host_build_of_march_backward_matches_autograd(host_lib, glow, depth):
    # the step-by-step march, which the plain version is (the floor tail's
    # own budgets: test_host_build_of_march_backward_with_floor_tail)
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=32, yres=24, use_raymarching=True, glow_effect=glow,
                           march_max_iter=512, refraction_unroll=depth, march_floor_skip=False)
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


@pytest.fixture(scope="module")
def march_host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("march_host"), "march")


def _glowing_sphere_field():
    """tests/test_parity.py:75-102's seeded field (floor and 39 spheres, seed
    7) with its first material, the floor's, glowing (glow_dist 3): many
    horizon rays whose glow argmin the floor tail resolves."""
    rng = np.random.default_rng(7)
    mats = [rtt.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3),
                             pn=8, glow_dist=3.0),
            rtt.MaterialSpec(name="m1", diffuse=(0.1, 0.5, 0.9), specular=(0.0, 0.0, 0.0), pn=0)]
    objs = [rtt.FloorSpec("m0", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0))]
    for _ in range(39):
        c = rng.uniform(-300, 300, 3)
        c[2] = rng.uniform(100, 600)
        r = rng.uniform(10, 50)
        objs.append(rtt.SphereSpec(f"m{int(rng.integers(0, 2))}", float(r),
                                   tuple(float(v) for v in c)))
    return rtt.build_scene(mats, objs, (0.0, 0.0, -400.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), device="cpu")[0]


_TAIL_CASES = {
    "glow": (lambda: rtt.default_scene(device="cpu")[0], dict(glow_effect=1.0)),
    "no_glow": (lambda: rtt.default_scene(device="cpu")[0], dict(glow_effect=None)),
    # the horizon rays' argmin is the floor's glow at the tail's last samples,
    # whose f32 distances tie over a run of samples
    "forty_glowing_spheres": (_glowing_sphere_field, dict(glow_effect=1.0, max_refractions=1)),
}


@pytest.mark.parametrize("case", list(_TAIL_CASES))
def test_host_build_of_march_backward_with_floor_tail(host_lib, march_host_lib, case):
    """K4's body with the floor tail on (the default) against autograd of the
    plain march at the JAX package's budgets: the forwards agree on more
    than 90% of pixels, every other one on a decision boundary
    (tests/test_pallas_bwd.py:29-72), then relative L2 <= 0.02 per leaf on
    the agreeing pixels (:306-321); its image is the march body's (K3's host
    build, tail on) bit for bit."""
    make, kw = _TAIL_CASES[case]
    scene = make()
    cfg = rtt.RenderConfig(xres=32, yres=24, use_raymarching=True, march_max_iter=2000, **kw)
    assert cfg.march_floor_skip
    rng = np.random.default_rng(7)
    planes = [torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
              for _ in range(3)]
    _, prim = _host_grads(host_lib, scene, cfg, planes)
    f32t, i32t, cam, light = kt.pack_scene(scene)
    k3 = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    march_host_lib.rt_march_host(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(),
                                 light.data_ptr(), scene.objects.count, cfg.xres, cfg.yres,
                                 *kt.window(cfg), sx, sy,
                                 *km.launch_args(cfg, None, torch.device("cpu")),
                                 *(c.data_ptr() for c in k3), None)
    np.testing.assert_array_equal(prim, np.stack([c.numpy() for c in k3], -1))
    ref = _img(km.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.9
    assert_boundary_only(ref, agree)
    g = Color(*(p * torch.from_numpy(agree) for p in planes))
    got, _ = _host_grads(host_lib, scene, cfg, g)
    assert_leaf_grads_close(scene, got, kmb.render_grads_plain(scene, cfg, g), 0.02)


@pytest.mark.cuda
def test_cuda_scan_march_launches_no_kernel():
    """On the card the scan-mode march is the plain version too: neither
    march kernel launches, and its gradient is the CPU's within rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = rtt.RenderConfig(xres=W, yres=H, use_raymarching=True, glow_effect=1.0,
                           max_refractions=1, differentiable=True, march_budget=64)
    scene = rtt.default_scene(device="cuda")[0]
    ox = scene.objects.org.x.clone().requires_grad_()
    before = (km.LAUNCHES, kmb.LAUNCHES)
    img = rtt.render_color(scene._replace(objects=scene.objects._replace(
        org=scene.objects.org._replace(x=ox))), cfg)
    got = torch.autograd.grad((img.r + img.g + img.b).mean(), ox)[0].cpu().numpy()
    assert (km.LAUNCHES, kmb.LAUNCHES) == before
    assert _rel(got, _org_x_grad_port(cfg)) <= 1e-4


@pytest.mark.cuda
def test_cuda_march_gradient_goes_through_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    # the step-by-step march, whose image is the plain version's bit for bit
    cfg = rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=1.0,
                           march_max_iter=2000, march_floor_skip=False)
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
