"""Gradients of the PyTorch port's plain trace against the JAX package.

The port's CPU gradient is torch autograd of the plain trace
(``kernel_trace.render_color_plain``); the trace backward kernel is held
against it (tests/test_torch_kernel_bwd.py), so this file holds it against
``jax.vjp`` of the JAX package's jnp trace, on one scene carried into both
packages by ``scene_to_numpy``/``scene_from_numpy``:

- per scene leaf on the pixels where the two forwards agree to 1e-4, every
  other pixel on a decision boundary, relative L2 within 0.01 (the budget of
  tests/test_pallas_bwd.py:29-96);
- the finite-difference checks of tests/test_grad.py:61-173, each with its
  JAX twin's tolerance;
- ``render_loss`` and one ``sgd_train_step`` against the JAX functions.

The JAX gradients compile once per module (fixtures), as they dominate this
file's time on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu.models.vec import Color as JaxColor
from ray_rust_tpu.ops.rays import camera_rays as jax_camera_rays
from ray_rust_tpu.ops.trace import trace_image as jax_trace_image
from ray_rust_tpu.parallel.train import sgd_train_step as jax_sgd_train_step
from ray_rust_tpu_torch.models.vec import Vec3
from ray_rust_tpu_torch.ops.intersect import raycast
from ray_rust_tpu_torch.ops.kernel_trace import render_color_plain
from ray_rust_tpu_torch.ops.texture import get_uv
from ray_rust_tpu_torch.parallel import render_loss, sgd_train_step

from .test_torch_kernel_bwd import assert_boundary_only
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

CFG = rtt.RenderConfig(xres=32, yres=24, max_refractions=1)  # tests/test_grad.py:22

# tests/test_pallas_bwd.py's config, and tests/test_grad.py's
_VJP_CASES = {
    "reflections2_unroll1_32x16": dict(xres=32, yres=16, max_reflections=2, refraction_unroll=1),
    "refractions1_32x24": dict(xres=32, yres=24, max_refractions=1),
}


def _img(col):
    return np.stack([np.asarray(c.detach() if isinstance(c, torch.Tensor) else c) for c in col], -1)


def _port(jax_scene):
    return rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")


def _with_grad(scene):
    """``scene`` with fresh float leaves that require grad, and those leaves
    by dotted path."""
    paths = list(rtt.scene_to_numpy(scene))
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    return scene.with_tensors(leaves), {p: t for p, t in zip(paths, leaves) if t.requires_grad}


def _grads(out, params: dict, g):
    got = torch.autograd.grad(out, list(params.values()), g, allow_unused=True)
    return {p: np.zeros(t.shape, np.float32) if gr is None else gr.numpy()
            for (p, t), gr in zip(params.items(), got)}


@pytest.fixture(scope="module", params=sorted(_VJP_CASES))
def jax_vjp_case(request):
    """The JAX scene, its jnp image and its vjp under one config."""
    kw = _VJP_CASES[request.param]
    scene, _ = rt.default_scene()
    cfg = rt.RenderConfig(**kw)

    def fwd(s):
        vi, eye = jax_camera_rays(s.camera.position, s.camera.rotation, cfg)
        return jax_trace_image(s, cfg, vi, eye)

    img, vjp = jax.vjp(fwd, scene)
    return scene, kw, _img(img), vjp


def test_plain_gradient_matches_jax_vjp(jax_vjp_case):
    jax_scene, kw, jax_img, vjp = jax_vjp_case
    scene, params = _with_grad(_port(jax_scene))
    cfg = rtt.RenderConfig(**kw)
    img = render_color_plain(scene, cfg)
    agree = np.abs(_img(img) - jax_img).max(-1) < 1e-4
    assert agree.mean() > 0.9
    assert_boundary_only(jax_img, agree)

    rng = np.random.default_rng(0)
    planes = [rng.standard_normal(agree.shape).astype(np.float32) * agree for _ in range(3)]
    (ct,) = vjp(JaxColor(*map(jnp.asarray, planes)))
    want = rtt.scene_to_numpy(ct)
    got = _grads(tuple(img), params, tuple(map(torch.from_numpy, planes)))
    for path, a in got.items():
        assert np.isfinite(a).all(), path
        b = np.asarray(want[path], np.float64)
        if "pattern_scale" in path:
            continue
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2)
        assert rel < 0.01, f"{path}: relative L2 {rel:.2e} (norm {np.linalg.norm(b):.3g})"


# -- finite differences: twins of tests/test_grad.py:61-173 -----------------

@pytest.fixture(scope="module")
def scene():
    return rtt.default_scene(device="cpu")[0]


@pytest.fixture(scope="module")
def target(scene):
    with torch.no_grad():
        return render_color_plain(scene, CFG).to_array()


def _hit_t(scene, radius=None, cx=None):
    """The nearest t of one ray from the camera at mirror sphere 1."""
    objs = scene.objects
    if radius is not None:
        objs = objs._replace(radius=torch.cat([objs.radius[:1], radius.reshape(1),
                                               objs.radius[2:]]))
    if cx is not None:
        x = torch.cat([objs.org.x[:1], cx.reshape(1), objs.org.x[2:]])
        objs = objs._replace(org=objs.org._replace(x=x))
    s = scene._replace(objects=objs)
    origin = Vec3(torch.zeros(1, 1), torch.full((1, 1), -150.0), torch.full((1, 1), -300.0))
    d = Vec3(torch.zeros(1, 1), torch.full((1, 1), 120.0), torch.full((1, 1), 472.0)).normalized()
    t, _ = raycast(s, origin, d, torch.full((1, 1), -1, dtype=torch.int32),
                   torch.zeros((1, 1), dtype=torch.int32))
    return t[0, 0]


def _d(fn, x0: float):
    """``fn``'s derivative at ``x0`` by autograd."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    return float(torch.autograd.grad(fn(x), x)[0])


def _fd(fn, x0: float, eps: float):
    with torch.no_grad():
        return (float(fn(torch.tensor(np.float32(x0 + eps))))
                - float(fn(torch.tensor(np.float32(x0 - eps))))) / (2 * eps)


def test_fd_intersection_radius(scene):
    r0 = float(scene.objects.radius[1])
    fn = lambda r: _hit_t(scene, radius=r)  # noqa: E731
    np.testing.assert_allclose(_d(fn, r0), _fd(fn, r0, 0.1), rtol=1e-3)


def test_fd_intersection_center(scene):
    fn = lambda c: _hit_t(scene, cx=c)  # noqa: E731
    np.testing.assert_allclose(_d(fn, 0.0), _fd(fn, 0.0, 1e-2), rtol=1e-3, atol=1e-5)


def _red_patch(scene):
    with torch.no_grad():
        img = render_color_plain(scene, CFG)
    red = (img.r.numpy() > 0.2) & (img.g.numpy() < 0.1)
    ys, xs = np.where(red)
    assert len(ys) > 6, "red sphere not visible at this resolution"
    return int(np.median(ys)), int(np.median(xs))


def _pixel(scene, y, x):
    img = render_color_plain(scene, CFG)
    return img.r[y, x] + img.g[y, x]


def test_fd_image_light_direction(scene):
    y, x = _red_patch(scene)

    def fn(ly):
        return _pixel(scene._replace(light=scene.light._replace(y=ly)), y, x)

    ly0 = float(scene.light.y)
    np.testing.assert_allclose(_d(fn, ly0), _fd(fn, ly0, 1e-3), rtol=0.05, atol=1e-6)


def test_fd_image_diffuse_color(scene, target):
    mats = scene.materials

    def fn(r):
        red = torch.cat([mats.diffuse.r[:2], r.reshape(1), mats.diffuse.r[3:]])
        s = scene._replace(materials=mats._replace(diffuse=mats.diffuse._replace(r=red)))
        return render_loss(s, CFG, target + 0.05)

    r0 = float(mats.diffuse.r[2])
    np.testing.assert_allclose(_d(fn, r0), _fd(fn, r0, 1e-3), rtol=0.05)


def test_fd_image_camera_position(scene):
    y, x = _red_patch(scene)
    cam = scene.camera

    def fn(cz):
        return _pixel(scene._replace(camera=cam._replace(
            position=cam.position._replace(z=cz))), y, x)

    z0 = float(cam.position.z)
    np.testing.assert_allclose(_d(fn, z0), _fd(fn, z0, 0.05), rtol=0.2, atol=5e-5)


def test_grad_zero_at_optimum(scene, target):
    s, params = _with_grad(scene)
    grads = _grads(render_loss(s, CFG, target), params, None)
    assert abs(float(grads["objects.org.x"][1])) < 1e-8
    assert abs(float(grads["materials.diffuse.r"][2])) < 1e-8


def test_grads_finite_everywhere(scene, target):
    """Default depths too: refraction, patterns, sky, shadows."""
    for cfg in (CFG, CFG.with_(max_refractions=10)):
        s, params = _with_grad(scene)
        for path, g in _grads(render_loss(s, cfg, target + 0.1), params, None).items():
            assert np.isfinite(g).all(), path


def test_get_uv_gradient_finite_at_the_pole():
    """rel.x = rel.z = 0 under every map: the lat-long branch's sqrt has no
    slope there, and it must not leak NaN through the unselected lanes."""
    for uvmap in range(4):
        rel = Vec3(*(torch.tensor(c, requires_grad=True) for c in (0.0, 0.3, 0.0)))
        ps = torch.tensor(2.0, requires_grad=True)
        pas = torch.tensor(0.5, requires_grad=True)
        u, v = get_uv(rel, torch.tensor(uvmap), ps, pas)
        grads = torch.autograd.grad(u + v, (*rel, ps, pas))
        assert all(torch.isfinite(g) for g in grads), uvmap
        if uvmap == 3:
            assert float(v.detach()) == float((torch.atan2(torch.tensor(0.0), rel.y) / pas).detach())


# -- the trainer against the JAX package's --------------------------------

def test_render_loss_and_sgd_step_match_jax():
    """Eager JAX (``disable_jit``): compiled, XLA fuses the render and flips
    knife-edge pixels, so a jitted render is not the jnp path's eager one
    (the loss floor tests/test_grad.py:197-200 describes)."""
    jax_scene, _ = rt.default_scene()
    jax_cfg = rt.RenderConfig(xres=32, yres=24, max_refractions=1)
    vi, eye = jax_camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jax_cfg)
    target = _img(jax_trace_image(jax_scene, jax_cfg, vi, eye)) + np.float32(0.05)
    target[:, :, 0] += np.float32(0.05)  # a little more red: not an optimum
    with jax.disable_jit():
        jax_new, jax_loss = jax_sgd_train_step(jax_scene, jax_cfg, jnp.asarray(target), lr=1e-3)

    scene, _ = _with_grad(_port(jax_scene))  # the JAX step trains every float leaf
    new, loss = sgd_train_step(scene, CFG, torch.from_numpy(target), lr=1e-3)
    np.testing.assert_allclose(float(render_loss(scene, CFG, torch.from_numpy(target))),
                               float(jax_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)

    want, before = rtt.scene_to_numpy(jax_new), rtt.scene_to_numpy(scene)
    moved = 0
    for path, a in rtt.scene_to_numpy(new).items():
        b = np.asarray(want[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=path)
        moved += int(not np.array_equal(a, before[path]))
    assert moved > 10  # the step moved most float leaves


def _colour_leaves(scene):
    """``scene`` with its material colours (diffuse, specular) as the only
    leaves that require grad."""
    m = scene.materials

    def fresh(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    return scene._replace(materials=m._replace(diffuse=fresh(m.diffuse),
                                               specular=fresh(m.specular)))


def test_sgd_steps_recover_a_colour(scene):
    """The training main path of chip_smoke.py at a small size: the target
    moves the red material's diffuse red by +0.1, five steps on the material
    colours bring the loss down at every step and the red back."""
    m = scene.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = render_color_plain(
            scene._replace(materials=m._replace(diffuse=m.diffuse._replace(r=red))), CFG).to_array()
    s = _colour_leaves(scene)
    losses = []
    for _ in range(5):
        s, loss = sgd_train_step(s, CFG, target, lr=30.0)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert abs(float(s.materials.diffuse.r[2]) - 0.9) < 0.01
    # only the leaves that require grad moved, and they still do
    before, after = rtt.scene_to_numpy(scene), rtt.scene_to_numpy(s)
    moved = {p for p in before if not np.array_equal(before[p], after[p])}
    assert moved and moved <= {f"materials.{f}.{c}" for f in ("diffuse", "specular")
                               for c in "rgb"}
    assert s.materials.diffuse.r.requires_grad and not s.light.x.requires_grad
    with pytest.raises(ValueError, match="requires grad"):
        sgd_train_step(scene, CFG, target)
