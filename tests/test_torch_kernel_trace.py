"""The trace kernel module (ops/kernel_trace.py) against the JAX Pallas kernel.

On the CPU: the packed tables against ``_pack_scene``, the plain version
against the Pallas kernel in interpret mode, the support check against
``pallas_supported``, the CPU routing, and the kernel's per-pixel body
(``csrc/trace_body.cuh``) built for the host with g++ against the plain
version. The kernel itself runs only on a card. This file imports the JAX
package only inside the tests that compare with it, so the card test also
runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernel_trace.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops.rays import fov_scales
from ray_rust_tpu_torch.ops.sky import BG_IDS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's tests on one torch thread, then restore the count. The
    port's tests take small tensors, and tier-1 runs several pytest workers
    on the machine's cores: each worker's intra-op pool of one thread per
    core then thrashes, and a plain march gradient at 32x24 runs an order of
    magnitude slower than on one thread. Every tests/test_torch_*.py file
    takes this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(ref, got, frac_budget=0.05, tol=1e-3, mean_tol=0.02):
    diff = np.abs(got - ref)
    bad_frac = (diff.max(-1) > tol).mean()
    assert bad_frac <= frac_budget, (
        f"{bad_frac:.1%} pixels differ > {tol} (budget {frac_budget:.0%}); "
        f"mean {diff.mean():.4f} max {diff.max():.3f}"
    )
    assert diff.mean() <= mean_tol, f"mean diff {diff.mean():.4f} > {mean_tol}"


def _port(jax_scene):
    return rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")


def _img(col):
    """(H, W, 3) numpy image from a Color of either package."""
    return np.stack([c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                     else np.asarray(c) for c in col], -1)


def _jax():
    import ray_rust_tpu
    from ray_rust_tpu.ops import pallas_trace

    return ray_rust_tpu, pallas_trace


def _jax_cfg(cfg):
    """The same render settings as a JAX RenderConfig."""
    return _jax()[0].RenderConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def _on_cpu(pkg):
    """``build_scene`` keywords that put a port scene on the CPU."""
    return {"device": "cpu"} if pkg is rtt else {}


def _many_spheres(pkg, n_spheres, seed=3):
    """A floor and seeded spheres in front of the camera, built by ``pkg``
    (either package: their build_scene functions take the same specs)."""
    rng = np.random.default_rng(seed)
    mats = [pkg.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0))] + [
        pkg.MaterialSpec(name=f"m{i}", diffuse=tuple(rng.uniform(0.2, 1.0, 3)),
                        specular=(0.3, 0.3, 0.3), pn=8)
        for i in range(4)
    ]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0))] + [
        pkg.SphereSpec(f"m{int(rng.integers(4))}", float(rng.uniform(20, 60)),
                      tuple(rng.uniform(-800, 800, 3) * np.array([1, 0.3, 1])
                            + np.array([0, -150, 400])))
        for _ in range(n_spheres)
    ]
    scene, _ = pkg.build_scene(mats, objs, (0.0, -150.0, -300.0),
                              (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), **_on_cpu(pkg))
    return scene


def _patterns_scene(pkg):
    """Checkerboard floor, a glass sphere, a lat-long-mapped gradation sphere
    and a mirror: every pattern, uv map and shading branch."""
    mats = [
        pkg.MaterialSpec(name="checker", diffuse=(0.9, 0.9, 0.9), pattern=1,
                        pattern_scale=50.0),
        pkg.MaterialSpec(name="glass", transparency=0.7, refraction=1.3,
                        diffuse=(0.2, 0.2, 0.2)),
        pkg.MaterialSpec(name="ll", diffuse=(0.3, 0.8, 0.5), pattern=2,
                        pattern_angle_scale=0.3, specular=(0.2, 0.2, 0.2), pn=8),
        pkg.MaterialSpec(name="mirror", specular=(0.9, 0.9, 0.9), pn=24),
    ]
    objs = [
        pkg.FloorSpec("checker", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
        pkg.SphereSpec("glass", 60.0, (0.0, -40.0, 200.0)),
        pkg.SphereSpec("ll", 50.0, (-130.0, -50.0, 260.0), uvmap=3),
        pkg.SphereSpec("mirror", 70.0, (140.0, -30.0, 300.0), uvmap=1),
    ]
    scene, _ = pkg.build_scene(mats, objs, (0.0, 0.0, -300.0),
                              (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), **_on_cpu(pkg))
    return scene


def _glass_cluster(pkg):
    """Overlapping glass spheres that also reflect: nearly every hit pushes a
    refraction sub-trace and reflects on, filling the kernel's task stack to
    its bound at max_reflections=6."""
    mats = [
        pkg.MaterialSpec(name="floor", diffuse=(0.8, 0.8, 0.8), pattern=1,
                         pattern_scale=40.0),
        pkg.MaterialSpec(name="glass", transparency=0.5, refraction=1.3,
                         diffuse=(0.1, 0.2, 0.1), specular=(0.6, 0.6, 0.6), pn=16),
    ]
    objs = [pkg.FloorSpec("floor", (0.0, -120.0, 0.0), (0.0, 1.0, 0.0), uvmap=2)] + [
        pkg.SphereSpec("glass", 45.0, (x, y, z))
        for x, y, z in [(-50, -40, 150), (0, -40, 180), (50, -40, 150),
                        (-25, 20, 170), (25, 20, 170), (0, -60, 120)]
    ]
    scene, _ = pkg.build_scene(mats, objs, (0.0, 0.0, -150.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), **_on_cpu(pkg))
    return scene


def textured_scene(pkg, filt, camera=(0.0, -150.0, -300.0)):
    """tests/test_pallas.py:572-594's scene: a 12x20 noise texture on the
    floor, seen directly, in a mirror and through glass; ``camera``
    (0.37, -150.3, -300.0) gives tests/test_pallas_bwd.py:116-138's."""
    tex = np.random.default_rng(5).integers(0, 256, (12, 20, 3)).astype(np.uint8)
    mats = [
        pkg.MaterialSpec(name="texfloor", diffuse=(1.0, 1.0, 0.0), pattern=2,
                         pattern_scale=300.0, pattern_angle_scale=0.2,
                         texture_filter=filt, texture=tex),
        pkg.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24),
        pkg.MaterialSpec(name="glass", transparency=1.0, refraction=1.5),
    ]
    objs = [
        pkg.FloorSpec("texfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
        pkg.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
        pkg.SphereSpec("glass", 100.0, (70.0, -200.0, 150.0)),
    ]
    kw = {"device": "cpu"} if pkg is rtt else {}
    scene, _ = pkg.build_scene(mats, objs, camera, (0.0, -np.pi / 2, -np.pi / 2),
                               (50.0, 60.0, -50.0), **kw)
    return scene


def two_texture_scene(pkg):
    """tests/test_pallas.py:679-722's scene: a 200x128 Bilinear floor
    texture and a 9x14 Nearest one on a sphere."""
    rng = np.random.default_rng(23)
    mats = [
        pkg.MaterialSpec(name="texfloor", diffuse=(1.0, 1.0, 0.0), pattern_scale=300.0,
                         pattern_angle_scale=0.2, texture_filter=1,
                         texture=rng.integers(0, 256, (200, 128, 3)).astype(np.uint8)),
        pkg.MaterialSpec(name="texball", diffuse=(0.5, 0.5, 0.5), pattern_scale=80.0,
                         texture_filter=0,
                         texture=rng.integers(0, 256, (9, 14, 3)).astype(np.uint8)),
    ]
    objs = [pkg.FloorSpec("texfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            pkg.SphereSpec("texball", 120.0, (30.0, -160.0, 180.0))]
    kw = {"device": "cpu"} if pkg is rtt else {}
    scene, _ = pkg.build_scene(mats, objs, (0.3, -150.0, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), **kw)
    return scene


def test_pack_scene_equals_jax():
    rt, pallas_trace = _jax()
    for jax_scene in (rt.default_scene()[0], _many_spheres(rt, 70)):
        want = [np.asarray(a) for a in pallas_trace._pack_scene(jax_scene)]
        got = [a.numpy() for a in kt.pack_scene(_port(jax_scene))]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_plain_matches_pallas_interpret():
    """The JAX kernel test's config (tests/test_pallas.py:36)."""
    rt, pallas_trace = _jax()
    jax_scene, _ = rt.default_scene()
    cfg = rtt.RenderConfig(xres=64, yres=48, max_reflections=2, refraction_unroll=2)
    ref = _img(pallas_trace.render_color_pallas(jax_scene, _jax_cfg(cfg), interpret=True))
    got = _img(kt.render_color_plain(_port(jax_scene), cfg))
    _compare(ref, got)


def test_kernel_supported_agrees_with_pallas_supported():
    """The CUDA kernel covers what the Pallas kernel covers with its
    in-kernel textures on (the default), for atlases within the Pallas
    kernel's cap, and also the scenes past 512 objects, which the JAX
    package renders through its jnp path (the Pallas kernel declines them,
    the port's kernel reads their tables from global memory)."""
    rt, pallas_trace = _jax()
    pallas_supported = pallas_trace.pallas_supported
    cfg = rtt.RenderConfig(xres=32, yres=24)
    default = rt.default_scene()[0]
    big = _many_spheres(rt, 512)
    assert big.objects.count == 513
    tex = np.zeros((4, 4, 3), np.uint8)
    jax_tex, _ = rt.build_scene([rt.MaterialSpec(name="t", texture=tex)],
                                [rt.SphereSpec("t", 10.0, (0.0, 0.0, 50.0))],
                                (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cases = [(default, cfg), (default, cfg.with_(use_raymarching=True)), (big, cfg),
             (jax_tex, cfg), (jax_tex, cfg.with_(use_raymarching=True))]
    for jax_scene, c in cases:
        if jax_scene is big:  # the JAX package renders it through jnp
            assert not pallas_supported(jax_scene, _jax_cfg(c))
            assert kt.kernel_supported(_port(jax_scene), c)
            continue
        assert kt.kernel_supported(_port(jax_scene), c) == pallas_supported(jax_scene, _jax_cfg(c))
    assert kt.kernel_supported(_port(default), cfg)
    assert kt.kernel_supported(_port(big), cfg)
    assert kt.library("trace_fwd", big.objects.count, kt.SHARED_TABLE_MAX) == "trace_fwd_global"
    assert kt.kernel_supported(_port(jax_tex), cfg)
    assert _port(jax_tex).textures.data.dtype == torch.uint8


def test_cpu_render_takes_plain_version():
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=24, yres=16, max_reflections=2, refraction_unroll=1)
    before = kt.LAUNCHES
    out = rtt.render_color(scene, cfg)
    assert kt.LAUNCHES == before == 0
    np.testing.assert_array_equal(_img(out), _img(kt.render_color_plain(scene, cfg)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kt.render_color_kernel(scene, cfg)
    assert kt.LAUNCHES == 0


@pytest.mark.parametrize("change,names", [
    (dict(use_raymarching=True), "K3"),
    (dict(bg="sunset"), "background"),
    (dict(max_reflections=65, max_refractions=66, refraction_unroll=None), "task stack"),
])
def test_unsupported_reason_names_what_is_missing(change, names):
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=8)
    assert kt.unsupported_reason(scene, cfg) is None
    assert kt.unsupported_reason(scene, cfg.with_(max_reflections=11)) is None
    # 12 reflections hold 3 tasks at the default unroll (kernel_trace.stack_tasks)
    assert kt.unsupported_reason(scene, cfg.with_(max_reflections=12)) is None
    assert names in kt.unsupported_reason(scene, cfg.with_(**change))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("trace_host"))


def _host_render(lib, scene, cfg, ops=None):
    f32t, i32t, cam, light = kt.pack_scene(scene)
    tex = kt.pack_textures(scene)  # held until the call returns
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    lib.rt_trace_host(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(),
                      scene.objects.count, cfg.xres, cfg.yres, *kt.window(cfg), sx, sy,
                      *kt.launch_args(cfg, tex, torch.device("cpu"), scene.objects.count),
                      out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                      None if ops is None else ops.data_ptr())
    return out.permute(1, 2, 0).numpy()


_HOST_CASES = {
    "default_unroll2": (lambda: rtt.default_scene(device="cpu")[0],
                        rtt.RenderConfig(xres=64, yres=48, max_reflections=2, refraction_unroll=2)),
    "default_full_depth": (lambda: rtt.default_scene(device="cpu")[0],
                           rtt.RenderConfig(xres=64, yres=48, refraction_unroll=None)),
    "patterns_black_bg": (lambda: _patterns_scene(rtt),
                          rtt.RenderConfig(xres=48, yres=32, bg="black", max_reflections=4)),
    "glass_cluster_deep_stack": (lambda: _glass_cluster(rtt),
                                 rtt.RenderConfig(xres=32, yres=24, max_reflections=6,
                                                  refraction_unroll=7)),
    "seventy_spheres": (lambda: _many_spheres(rtt, 70),
                        rtt.RenderConfig(xres=48, yres=24, max_reflections=2,
                                         refraction_unroll=1)),
    "textured_nearest": (lambda: textured_scene(rtt, 0),
                         rtt.RenderConfig(xres=64, yres=48, max_reflections=2,
                                          refraction_unroll=2)),
    "two_textures": (lambda: two_texture_scene(rtt),
                     rtt.RenderConfig(xres=160, yres=32, max_reflections=1, refraction_unroll=0)),
}


@pytest.mark.parametrize("case", sorted(_HOST_CASES))
def test_host_build_of_kernel_body_matches_plain(host_lib, case):
    make, cfg = _HOST_CASES[case]
    scene = make()
    want = _img(kt.render_color_plain(scene, cfg))
    got = _host_render(host_lib, scene, cfg)
    assert np.isfinite(got).all()
    _compare(want, got)


def test_counting_build_counts_shading_and_sky(host_lib, tmp_path):
    """The forward's -DRT_COUNT_OPS build renders the ordinary build's image
    and counts the body's shading, sky and camera-ray operations in slot 2
    beside the object tests (slot 0): on a frame that sees only sky, the
    camera ray's 70, the miss's 9 and the sky's 70 a pixel."""
    lib = _build.build_host_library(tmp_path, "trace", count_ops=True)
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=32, yres=24)
    ops = torch.zeros(6, dtype=torch.int64)
    np.testing.assert_array_equal(_host_render(lib, scene, cfg, ops),
                                  _host_render(host_lib, scene, cfg))
    assert ops[0] > 0 and ops[2] > 0 and ops[1] == 0 and not ops[3:].any()
    behind, _ = rtt.build_scene([rtt.MaterialSpec(name="m")],
                                [rtt.SphereSpec("m", 10.0, (0.0, 0.0, -1000.0))],
                                (0.0, 0.0, 0.0), (0.0, -np.pi / 2, -np.pi / 2),
                                (50.0, 60.0, -50.0), device="cpu")
    ops.zero_()
    _host_render(lib, behind, cfg, ops)
    assert int(ops[2]) == cfg.xres * cfg.yres * (70 + 9 + 70)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    for cfg in (rtt.RenderConfig(xres=320, yres=240),
                rtt.RenderConfig(xres=333, yres=101, refraction_unroll=None)):
        before = kt.LAUNCHES
        got = _img(rtt.render_color(scene, cfg))  # routes a CUDA scene to the kernel
        torch.cuda.synchronize()
        assert kt.LAUNCHES == before + 1
        assert got.shape == (cfg.yres, cfg.xres, 3)
        _compare(_img(kt.render_color_plain(scene, cfg)), got, frac_budget=0.02,
                  mean_tol=0.01)
    # a textured scene in march mode with more laps (63) than the march
    # backward's local records (35) differentiates through its buffer
    # instance (tests/test_torch_kernel_bwd.py runs the other gradients); a
    # gradient past the kernels' task stack is refused, not faked or moved
    # to the CPU
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb

    tex = np.zeros((4, 4, 3), np.uint8)
    textured, _ = rtt.build_scene([rtt.MaterialSpec(name="t", texture=tex)],
                                  [rtt.SphereSpec("t", 10.0, (0.0, 0.0, 50.0))],
                                  (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    light = textured.light.x.clone().requires_grad_()
    textured = textured._replace(light=textured.light._replace(x=light))
    march = cfg.with_(use_raymarching=True, raymarch_max_reflections=4)
    assert kmb.count_sites(march) == 63 and kmb.buffered(march)
    before = kmb.BUF_LAUNCHES
    out = rtt.render_color(textured, march)
    (out.r.sum() + out.g.sum() + out.b.sum()).backward()
    torch.cuda.synchronize()
    assert kmb.BUF_LAUNCHES > before and torch.isfinite(light.grad)
    past = cfg.with_(max_reflections=65, max_refractions=66)
    with pytest.raises(NotImplementedError, match="task stack"):
        rtt.render_color(textured, past)
