"""March mode with glow in the PyTorch port against the JAX package.

The plain version (``ops/march.py``, ``ops/trace.py:raymarch``) against JAX
``distance_estimate``, ``march_single`` (while mode), the jnp ``render_color``
and the Pallas march kernel in interpret mode; the march kernel's per-pixel
body (``csrc/march_body.cuh``) built for the host with g++ against the plain
version and against the march golden; routing and the CLI. Inputs come from
a numpy seed or the default scene, carried into the port with
``scene_to_numpy``/``scene_from_numpy``. The plain comparisons run at 32x24
with ``march_max_iter <= 2000``, as the JAX package's march kernel test
does (tests/test_pallas.py:151-167): a horizon-grazing ray runs ~1 500 steps.
The kernel itself runs only on a card:
``python -m pytest --noconftest -m cuda tests/test_torch_march.py``.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import cli
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march as km
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops.march import distance_estimate, march_single
from ray_rust_tpu_torch.ops.rays import fov_scales
from ray_rust_tpu_torch.utils.image import load_png

from .test_torch_kernel_bwd import assert_boundary_only
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GLOW = dict(use_raymarching=True, glow_effect=1.0)


def _compare(ref, got, frac_budget, mean_tol, tol=1e-3):
    diff = np.abs(got - ref)
    bad_frac = (diff.max(-1) > tol).mean()
    assert np.isfinite(got).all()
    assert bad_frac <= frac_budget, (
        f"{bad_frac:.1%} pixels differ > {tol} (budget {frac_budget:.0%}); "
        f"mean {diff.mean():.4f} max {diff.max():.3f}"
    )
    assert diff.mean() <= mean_tol, f"mean diff {diff.mean():.4f} > {mean_tol}"


def _img(col):
    """(H, W, 3) numpy image from a Color of either package."""
    return np.stack([c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                     else np.asarray(c) for c in col], -1)


def _jax():
    import ray_rust_tpu

    return ray_rust_tpu


def _jax_cfg(cfg, **extra):
    """The same render settings as a JAX RenderConfig."""
    return _jax().RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)}, **extra)


def _port(jax_scene):
    return rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")


def _on_cpu(pkg):
    return {"device": "cpu"} if pkg is rtt else {}


def _seventy_spheres(pkg):
    """tests/test_pallas.py:119-148's 71-object march scene (glowing floor)."""
    rng = np.random.default_rng(3)
    mats = [pkg.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0), glow_dist=2.0)] + [
        pkg.MaterialSpec(name=f"m{i}", diffuse=tuple(rng.uniform(0.2, 1.0, 3)),
                         specular=(0.3, 0.3, 0.3), pn=8)
        for i in range(4)
    ]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0))] + [
        pkg.SphereSpec(f"m{int(rng.integers(4))}", float(rng.uniform(20, 60)),
                       tuple(rng.uniform(-800, 800, 3) * np.array([1, 0.3, 1])
                             + np.array([0, -150, 400])))
        for _ in range(70)
    ]
    return pkg.build_scene(mats, objs, (0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **_on_cpu(pkg))[0]


def _glass_before_glow(pkg):
    """A glowing glass sphere in front of a glowing red one over a floor: the
    refraction sub-marches pass the red sphere, so each carries its own glow
    factor into a parent that has one too."""
    mats = [
        pkg.MaterialSpec(name="floor", diffuse=(0.8, 0.8, 0.8), pattern=1, pattern_scale=40.0),
        pkg.MaterialSpec(name="glass", transparency=0.8, refraction=1.2,
                         diffuse=(0.1, 0.1, 0.3), glow_dist=1.5),
        pkg.MaterialSpec(name="red", diffuse=(0.8, 0.0, 0.0), specular=(0.3, 0.3, 0.3),
                         pn=24, glow_dist=5.0),
    ]
    objs = [
        pkg.FloorSpec("floor", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
        pkg.SphereSpec("glass", 60.0, (0.0, -20.0, 60.0)),
        pkg.SphereSpec("red", 50.0, (20.0, -30.0, 220.0)),
    ]
    return pkg.build_scene(mats, objs, (0.0, 0.0, -250.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **_on_cpu(pkg))[0]


def _default_jax():
    return _jax().default_scene()[0]


@pytest.mark.parametrize("make", [_default_jax, lambda: _seventy_spheres(_jax())],
                         ids=["default", "seventy_spheres"])
def test_distance_estimate_matches_jax(make):
    """Random points around the scene, a random ignored object per point:
    distances and glow within 1e-5 relative, indices equal."""
    import jax.numpy as jnp
    from ray_rust_tpu.ops.march import distance_estimate as jax_de

    jax_scene = make()
    n = jax_scene.objects.count
    rng = np.random.default_rng(11)
    pts = rng.uniform(-600, 600, (3, 4096)).astype(np.float32)
    ig = rng.integers(-1, n, 4096).astype(np.int32)
    want = jax_de(jax_scene, _jax().Vec3(*map(jnp.asarray, pts)), jnp.asarray(ig))
    got = distance_estimate(_port(jax_scene), rtt.Vec3(*map(torch.from_numpy, pts)),
                            torch.from_numpy(ig))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


def test_march_single_matches_jax_while_mode():
    """The same 32x24 primary rays marched by both packages, on >= 98% of
    lanes: index, iteration count and the glow argmin's step equal, final
    distance, travel and the glow minimum equal to 1e-4 relative (1e-5
    absolute near a hit). XLA's compiled loop rounds
    the position update apart from eager PyTorch at the ulp, and that drifts
    over hundreds of steps."""
    import jax.numpy as jnp
    from ray_rust_tpu.ops.march import march_single as jax_march
    from ray_rust_tpu.ops.rays import camera_rays as jax_rays

    rt = _jax()
    cfg = rtt.RenderConfig(xres=32, yres=24, march_max_iter=2000, **_GLOW)
    jax_scene = _default_jax()
    vi, eye = jax_rays(jax_scene.camera.position, jax_scene.camera.rotation, _jax_cfg(cfg))
    vi_np = [np.broadcast_to(np.asarray(c), (24, 32)).copy() for c in vi]
    eye_np = [np.array(c) for c in eye]
    ig = np.full((24, 32), -1, np.int32)
    want = jax_march(jax_scene, _jax_cfg(cfg), rt.Vec3(*map(jnp.asarray, vi_np)),
                     rt.Vec3(*map(jnp.asarray, eye_np)), jnp.asarray(ig))
    got = march_single(_port(jax_scene), cfg, rtt.Vec3(*map(torch.from_numpy, vi_np)),
                       rtt.Vec3(*map(torch.from_numpy, eye_np)), torch.from_numpy(ig))
    for name in ("final_dist", "idx", "iter", "travel_dist", "min_dist", "glow_iter"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        same = ((a == b) if name in ("idx", "iter", "glow_iter")
                else np.isclose(a, b, rtol=1e-4, atol=1e-5))
        assert same.mean() >= 0.98, f"{name}: equal on {same.mean():.1%} of lanes"
    assert (got.iter.numpy() > 100).any()  # some lanes graze the floor


def _slice_cfg():
    return rtt.RenderConfig(xres=32, yres=24, max_refractions=1, march_max_iter=2000, **_GLOW)


def test_plain_march_matches_jax_render_color():
    """The slice as a whole against the jnp path: <= 2% of pixels > 1e-3,
    mean <= 0.01. The JAX image is ``render_color``'s function (camera rays
    and ``trace_image``) run eagerly, one march step per while iteration
    (``march_chunk=1`` regroups no values): jitting the whole march render
    costs far more XLA compile on a cold cache for the same image."""
    from ray_rust_tpu.ops.rays import camera_rays as jax_rays
    from ray_rust_tpu.ops.trace import trace_image as jax_trace_image

    cfg = _slice_cfg()
    jax_scene = _default_jax()
    jcfg = _jax_cfg(cfg, march_tiles=1, march_chunk=1)
    vi, eye = jax_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(jax_trace_image(jax_scene, jcfg, vi, eye))
    got = _img(rtt.render_color(_port(jax_scene), cfg))
    assert got.shape == (24, 32, 3)
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


def test_plain_march_matches_pallas_interpret():
    """Against the Pallas march kernel in interpret mode, within the budget
    the JAX package gives that kernel against the jnp path
    (tests/test_pallas.py:167: 5%, mean 0.03)."""
    from ray_rust_tpu.ops.pallas_march import render_color_pallas_march

    cfg = _slice_cfg()
    jax_scene = _default_jax()
    ref = _img(render_color_pallas_march(jax_scene, _jax_cfg(cfg, pallas_march_chunk=4),
                                         interpret=True))
    got = _img(km.render_color_plain(_port(jax_scene), cfg))
    _compare(ref, got, frac_budget=0.05, mean_tol=0.03)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("march_host"), "march")


def _host_render(lib, scene, cfg, ops=None):
    f32t, i32t, cam, light = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    args = km.launch_args(cfg, None, torch.device("cpu"))
    lib.rt_march_host(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(),
                      scene.objects.count, cfg.xres, cfg.yres, *kt.window(cfg), sx, sy, *args,
                      out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                      None if ops is None else ops.data_ptr())
    return out.permute(1, 2, 0).numpy()


_HOST_CASES = {
    "default_glow": (lambda: rtt.default_scene(device="cpu")[0],
                     rtt.RenderConfig(xres=32, yres=24, march_max_iter=2000, **_GLOW)),
    "default_glow_full_depth": (lambda: rtt.default_scene(device="cpu")[0],
                                rtt.RenderConfig(xres=32, yres=24, march_max_iter=2000,
                                                 refraction_unroll=None, **_GLOW)),
    "glass_before_glow": (lambda: _glass_before_glow(rtt),
                          rtt.RenderConfig(xres=32, yres=24, march_max_iter=2000,
                                           glow_effect=0.7, use_raymarching=True)),
}


@pytest.mark.parametrize("case", sorted(_HOST_CASES))
def test_host_build_of_march_body_matches_plain(host_lib, case):
    """The kernel's body as g++ builds it against the plain version, within
    the golden budget (2% of pixels > 1e-3, mean 0.01); they differ at most
    where powf and torch.pow round apart."""
    make, cfg = _HOST_CASES[case]
    scene = make()
    want = _img(km.render_color_plain(scene, cfg))
    got = _host_render(host_lib, scene, cfg)
    _compare(want, got, frac_budget=0.02, mean_tol=0.01)
    if case == "glass_before_glow":  # the fold of sub-march glow factors is exercised
        no_glow = _img(km.render_color_plain(scene, cfg.with_(glow_effect=None)))
        assert np.abs(want - no_glow).max() > 0.05


def test_host_build_meets_march_golden(host_lib):
    """Full march budget (10 000 steps) and full refraction depth against the
    oracle's golden image: <= 2% of pixels > 1e-3, mean <= 0.01."""
    ref = np.load(os.path.join(_REPO, "tests", "goldens",
                               "default_march_glow_160x120.npz"))["img"]
    cfg = rtt.RenderConfig(xres=160, yres=120, refraction_unroll=None, **_GLOW)
    got = _host_render(host_lib, rtt.default_scene(device="cpu")[0], cfg)
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


def test_op_counting_build_changes_no_pixel(tmp_path, host_lib):
    """The operation-counting build renders the same image and counts at
    least one SDF sweep of every object per pixel."""
    counting = _build.build_host_library(tmp_path, "march", count_ops=True)
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=16, yres=12, march_max_iter=2000, **_GLOW)
    ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
    got = _host_render(counting, scene, cfg, ops)
    np.testing.assert_array_equal(got, _host_render(host_lib, scene, cfg))
    assert int(ops[0]) > 16 * 12 * 5 * 8


# -- the floor tail (march_floor_skip) and the never-converges shortcut -------
# Twins of tests/test_pallas.py:219-347: the same scenes and configs, with the
# march body's host build with the tail on held against it off under the JAX
# package's contract for the shortcut, knife-edge pixels only.


def test_march_floor_skip_is_the_jax_field():
    import ray_rust_tpu as rt

    assert rtt.RenderConfig().march_floor_skip is rt.RenderConfig().march_floor_skip is True
    cfg = rtt.RenderConfig(**_GLOW)
    assert km.kernel_args(cfg)[-1] == 1
    assert km.kernel_args(cfg.with_(march_floor_skip=False))[-1] == 0


def assert_knife_edge_only(on, off, frac_budget=0.005, tol=1e-3, contrast=0.05):
    """tests/test_pallas.py:_assert_knife_edge_only: the two images are equal
    but for at most ``frac_budget`` of pixels, each on a decision boundary
    (local contrast above ``contrast`` in the step-by-step image ``off``)."""
    diff = np.abs(on - off).max(-1)
    bad = diff > tol
    assert bad.mean() <= frac_budget, (
        f"{bad.mean():.2%} pixels differ > {tol} (budget {frac_budget:.1%}); max {diff.max():.4f}")
    assert_boundary_only(off, ~bad, contrast)


def _skip_pair(lib, scene, cfg):
    """The host build's image with the floor tail on and off."""
    return (_host_render(lib, scene, cfg.with_(march_floor_skip=True)),
            _host_render(lib, scene, cfg.with_(march_floor_skip=False)))


def _branch_matrix(pkg):
    """tests/test_pallas.py:264-293's scene: a glowing floor seen from 5 units
    above (rho < 1 hits, cap stops near the horizon, rho > 1 escapes), a
    glowing sphere off to the side (an interior glow argmin) and a dull
    sphere in the escape corridor (the tail must stop short of it)."""
    mats = [pkg.MaterialSpec(name="glowfloor", diffuse=(0.8, 0.8, 0.2), glow_dist=3.0),
            pkg.MaterialSpec(name="glowball", diffuse=(0.8, 0.2, 0.2), glow_dist=4.0),
            pkg.MaterialSpec(name="dull", diffuse=(0.3, 0.3, 0.6))]
    objs = [pkg.FloorSpec("glowfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            pkg.SphereSpec("glowball", 80.0, (400.0, -100.0, 600.0)),
            pkg.SphereSpec("dull", 60.0, (0.0, -180.0, 1500.0))]
    return pkg.build_scene(mats, objs, (0.0, -295.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **_on_cpu(pkg))[0]


def _escape_glow(pkg):
    """tests/test_pallas.py:296-322's scene: rays escaping 5 units above the
    floor pass a glowing sphere far down the corridor."""
    mats = [pkg.MaterialSpec(name="floor", diffuse=(0.9, 0.9, 0.3)),
            pkg.MaterialSpec(name="glow", diffuse=(0.9, 0.1, 0.1), glow_dist=1.0)]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            pkg.SphereSpec("glow", 100.0, (0.0, -150.0, 2000.0))]
    return pkg.build_scene(mats, objs, (0.0, -295.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **_on_cpu(pkg))[0]


def test_host_floor_skip_branch_matrix(host_lib):
    """Every branch of the tail on one scene, on against off; and on against
    the plain version within the JAX test's budget for the kernel against
    its oracle (5% of pixels, mean 0.03)."""
    scene = _branch_matrix(rtt)
    cfg = rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=1.5,
                           max_refractions=1, march_max_iter=600)
    on, off = _skip_pair(host_lib, scene, cfg)
    assert_knife_edge_only(on, off)
    _compare(_img(km.render_color_plain(scene, cfg)), on, frac_budget=0.05, mean_tol=0.03)


def test_host_floor_skip_escape_glow_regression(host_lib):
    """A glowing sphere beyond the floor's initial distance must stop the
    escape branch's tail, or the glow argmin comes out too coarse."""
    cfg = rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=2.0,
                           max_refractions=1, march_max_iter=2000)
    assert_knife_edge_only(*_skip_pair(host_lib, _escape_glow(rtt), cfg))


@pytest.mark.parametrize("case", ["branch_matrix", "escape_glow"])
def test_host_floor_skip_matches_jax_march(host_lib, case):
    """The tail-on host build against the JAX package's step-by-step march
    (its jnp ``trace_image``, one step per while iteration) on the same
    scene, knife-edge pixels only: the tail is held to the reference, not
    only to the port's own step-by-step build."""
    from ray_rust_tpu.ops.rays import camera_rays as jax_rays
    from ray_rust_tpu.ops.trace import trace_image as jax_trace_image

    make, glow, max_iter = {"branch_matrix": (_branch_matrix, 1.5, 600),
                            "escape_glow": (_escape_glow, 2.0, 2000)}[case]
    cfg = rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=glow,
                           max_refractions=1, march_max_iter=max_iter)
    assert cfg.march_floor_skip
    jax_scene = make(_jax())
    jcfg = _jax_cfg(cfg, march_tiles=1, march_chunk=1)
    vi, eye = jax_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(jax_trace_image(jax_scene, jcfg, vi, eye))
    assert_knife_edge_only(_host_render(host_lib, _port(jax_scene), cfg), ref)


@pytest.mark.parametrize("size", [(64, 48), (160, 120)], ids=["64x48", "160x120"])
def test_host_floor_skip_ab_default_scene(host_lib, size):
    """On against off on the default scene with glow, where the horizon band
    is resolved: the rays that stall in f32 above eps at the far horizon
    (csrc/march_body.cuh:freeze_distance) must miss as the step-by-step
    march does."""
    cfg = rtt.RenderConfig(xres=size[0], yres=size[1], march_max_iter=2000,
                           max_refractions=1, **_GLOW)
    assert_knife_edge_only(*_skip_pair(host_lib, rtt.default_scene(device="cpu")[0], cfg))


def test_never_converges_shortcut_changes_no_pixel(tmp_path):
    """Shadow marches, and primaries without glow, that no object can stop
    end before their first step. On the 71-object scene, whose floor's
    shadow rays pass among 70 spheres, the counting build ends dozens of
    marches so at 16x12, and with the floor tail off its image is the plain
    version's (which has no shortcut) to the rounding of powf: every lit
    and miss decision is the same."""
    scene = _seventy_spheres(rtt)
    counting = _build.build_host_library(tmp_path, "march", count_ops=True)
    for glow in (1.0, None):
        cfg = rtt.RenderConfig(xres=16, yres=12, use_raymarching=True, glow_effect=glow,
                               march_max_iter=2000, march_floor_skip=False)
        ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
        got = _host_render(counting, scene, cfg, ops)
        np.testing.assert_allclose(got, _img(km.render_color_plain(scene, cfg)), rtol=0,
                                   atol=1e-5)
        assert int(ops[5]) > 50


def test_floor_tail_cuts_the_longest_pixel(tmp_path):
    """The counting build on the default scene at the full 10 000-step
    budget: the tail cuts the operations, the most operations of one pixel
    and the most object passes of one pixel (its serial chain), which the
    step-by-step march spends at the cap on horizon rays."""
    counting = _build.build_host_library(tmp_path, "march", count_ops=True)
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=64, yres=48, **_GLOW)
    on, off = (torch.zeros(km.OPS_SLOTS, dtype=torch.int64) for _ in range(2))
    _host_render(counting, scene, cfg, on)
    _host_render(counting, scene, cfg.with_(march_floor_skip=False), off)
    assert int(off[4]) > cfg.march_max_iter  # a pixel marches to the cap
    assert int(on[0]) < int(off[0]) and int(on[2]) < int(off[2])
    assert 4 * int(on[4]) < int(off[4])


def test_march_tree_bounds():
    """A pixel's raymarch tree nests at most max(1, refraction cap) calls:
    the recursive instance takes a cap of FRAME_CAP = 10, the deep instance
    11 to FRAME_CAP_DEEP = 64, and 65 is refused."""
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=8, refraction_unroll=None, **_GLOW)
    assert km.unsupported_reason(scene, cfg.with_(max_refractions=10)) is None
    assert not km.deep(cfg.with_(max_refractions=10))
    assert km.unsupported_reason(scene, cfg.with_(max_refractions=11)) is None
    assert km.deep(cfg.with_(max_refractions=11)) and km.deep(cfg.with_(max_refractions=64))
    assert "task stack holds 64" in km.unsupported_reason(scene, cfg.with_(max_refractions=65))


def test_cached_build_keeps_its_log(tmp_path):
    """A second build of the same source is the cached library, and it
    reports the first build's compiler output."""
    compiler = ["g++", "-v"] + _build.GXX_FLAGS  # -v: the compiler writes a log
    src = _build.CSRC_DIR / "march_host.cpp"
    path, log = _build._compile(compiler, src, tmp_path, "logged")
    assert "logged" in _build.build_logs and log
    mtime = path.stat().st_mtime_ns
    _build.build_logs.clear()
    again, cached_log = _build._compile(compiler, src, tmp_path, "logged")
    assert again == path and again.stat().st_mtime_ns == mtime
    assert cached_log == log == _build.build_logs["logged"]


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16march_fwd_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z16march_fwd_kernelPKf
    744 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 744 bytes cumulative stack size
"""
_PTXAS_CALL = """\
ptxas info    : Function properties for _ZN2rt8raymarchILi1EEENS_2C3ERKNS_9SceneViewE
    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_called_functions_reads_ptxas_log():
    """A kernel alone reports no call; a device function left as a call
    is named; a log without a kernel is refused."""
    assert _build.called_functions(_PTXAS_LOG) == []
    assert _build.called_functions(_PTXAS_LOG + _PTXAS_CALL) == [
        "_ZN2rt8raymarchILi1EEENS_2C3ERKNS_9SceneViewE"]
    with pytest.raises(ValueError, match="no kernel"):
        _build.called_functions(_PTXAS_CALL)


def test_cpu_march_render_takes_plain_version():
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=12, yres=8, march_max_iter=500, **_GLOW)
    before = km.LAUNCHES
    out = rtt.render_color(scene, cfg)
    assert km.LAUNCHES == before == 0
    np.testing.assert_array_equal(_img(out), _img(km.render_color_plain(scene, cfg)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        km.render_color_kernel(scene, cfg)
    assert km.LAUNCHES == 0


@pytest.mark.parametrize("change,names", [
    (dict(use_raymarching=False), "K1"),
    (dict(bg="sunset"), "background"),
    (dict(refraction_unroll=None, max_refractions=65), "task stack"),
])
def test_march_unsupported_reason_names_what_is_missing(change, names):
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=8, **_GLOW)
    assert km.unsupported_reason(scene, cfg) is None
    assert km.unsupported_reason(scene, cfg.with_(refraction_unroll=None)) is None
    assert names in km.unsupported_reason(scene, cfg.with_(**change))


def test_march_unsupported_reason_textures_and_size():
    """Textured march is taken (the march kernels read the atlas), also past
    TEXTURE_MAX textures (the global-table build, its meta rows read from
    global memory), and an atlas of 2^31 texels (the kernels' texel index is
    64-bit). More than 512 objects are taken (above SHARED_TABLE_MAX
    the global-table build), and a scene past the pack's int32 words is
    refused with its reason."""
    cfg = rtt.RenderConfig(xres=8, yres=8, **_GLOW)
    tex = np.zeros((4, 4, 3), np.uint8)
    textured, _ = rtt.build_scene([rtt.MaterialSpec(name="t", texture=tex)],
                                  [rtt.SphereSpec("t", 10.0, (0.0, 0.0, 50.0))],
                                  (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                  device="cpu")
    assert km.unsupported_reason(textured, cfg) is None
    oversized, _ = rtt.build_scene(
        [rtt.MaterialSpec(name=f"t{i}", texture=tex[:1, :1]) for i in range(kt.TEXTURE_MAX + 1)],
        [rtt.SphereSpec("t0", 10.0, (0.0, 0.0, 50.0))],
        (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device="cpu")
    assert km.unsupported_reason(oversized, cfg) is None
    assert km.library_name(oversized, cfg) == "march_fwd_global"
    atlas = types.SimpleNamespace(objects=types.SimpleNamespace(count=1),
                                  textures=types.SimpleNamespace(packed=types.SimpleNamespace(
                                      shape=(2, 2**15, 2**15, 12))))
    assert km.unsupported_reason(atlas, cfg) is None
    big = rtt.build_scene(
        [rtt.MaterialSpec(name="m")],
        [rtt.SphereSpec("m", 1.0, (float(i), 0.0, 100.0)) for i in range(513)],
        (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device="cpu")[0]
    assert km.unsupported_reason(big, cfg) is None
    huge = types.SimpleNamespace(objects=types.SimpleNamespace(count=2**27), textures=None)
    assert "pack words" in km.unsupported_reason(huge, cfg)


def test_march_render_with_grad_raises():
    """A CPU march render that requires grad differentiates the plain march
    through its implicit VJP (finite, nonzero gradients, no kernel launch);
    only the CUDA gradient path raises, here on CPU tensors."""
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb

    scene, _ = rtt.default_scene(device="cpu")
    light = scene.light.x.clone().requires_grad_()
    radius = scene.objects.radius.clone().requires_grad_()
    scene = scene._replace(light=scene.light._replace(x=light),
                           objects=scene.objects._replace(radius=radius))
    cfg = rtt.RenderConfig(xres=8, yres=8, march_max_iter=500, **_GLOW)
    img = rtt.render_color(scene, cfg)
    g_light, g_radius = torch.autograd.grad(img.r.sum() + img.g.sum(), (light, radius))
    assert torch.isfinite(g_light) and g_light != 0
    assert torch.isfinite(g_radius).all() and g_radius.abs().sum() > 0
    assert km.LAUNCHES == kmb.LAUNCHES == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmb.render_color_grad(scene, cfg)


def test_cli_march_glow_cpu_writes_render_u8(tmp_path):
    out = tmp_path / "march.png"
    assert cli.main(["16", "12", "-m", "-g", "1.0", "-o", str(out), "--device", "cpu"]) == 0
    png = load_png(str(out))
    scene, _ = rtt.default_scene(device="cpu")
    want = rtt.render_u8(scene, rtt.RenderConfig(xres=16, yres=12, yfov=12 / 16, **_GLOW))
    assert png.shape == (12, 16, 3)
    np.testing.assert_array_equal(png, want)


@pytest.mark.cuda
def test_cuda_march_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    for cfg in (rtt.RenderConfig(xres=160, yres=120, **_GLOW),
                rtt.RenderConfig(xres=97, yres=61, refraction_unroll=None, **_GLOW)):
        before = km.LAUNCHES
        got = _img(rtt.render_color(scene, cfg))  # routes a CUDA march scene to the kernel
        torch.cuda.synchronize()
        assert km.LAUNCHES == before + 1
        assert got.shape == (cfg.yres, cfg.xres, 3)
        _compare(_img(km.render_color_plain(scene, cfg)), got, frac_budget=0.02,
                 mean_tol=0.01)
