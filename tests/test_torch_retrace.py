"""The re-trace gradient oracle (ops/kernel_trace_retrace.py, K5).

On the CPU, its per-pixel body (``csrc/trace_retrace_body.cuh``: the
forward's trace body in forward-mode numbers) built for the host with g++:

- against ``render_grads_plain`` (torch autograd of the plain trace, which
  tests/test_torch_grad.py holds against ``jax.vjp``);
- against the trace backward's host build (K2): the oracle check itself,
  the twin of tests/test_pallas_bwd.py:209;
- against the JAX package's ``render_color_pallas_grads`` in interpret mode
  on one numpy scene (marked slow: two interpret-mode kernels);
- its image bit-equal to the forward's host build;
- on 64 objects that all win pixels: the 64-bit winner mask and the compact
  seeding of a pixel's winners, against autograd;
- its counting build: the histogram of distinct winners a pixel and the
  Dual passes it implies;
- the support check and the CPU routing.

The kernel itself runs only on a card; this file imports the JAX package
only inside the test that compares with it, so the card test also runs where
JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_retrace.py``.

Budget: relative L2 0.01 per scene leaf with norm floor 1e-2, on the pixels
where the two sides' images agree to 1e-4 (every other pixel on a decision
boundary), the JAX oracle test's (tests/test_pallas_bwd.py:250-260);
``pattern_scale`` is held finite only.
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.vec import Color
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
from ray_rust_tpu_torch.ops.rays import fov_scales

from .test_torch_kernel_bwd import assert_boundary_only, assert_leaf_grads_close
from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _glass_cluster, _many_spheres, _patterns_scene, one_torch_thread, textured_scene)

BUDGET = 0.01  # tests/test_pallas_bwd.py:250-260


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds: K5's body, K2's and K1's, each built once."""
    d = tmp_path_factory.mktemp("retrace_host")
    return {name: _build.build_host_library(d, name) for name in ("trace_retrace", "trace_bwd",
                                                                  "trace")}


def _camera_x(scene, x):
    cam = scene.camera
    return scene._replace(camera=cam._replace(position=cam.position._replace(
        x=torch.tensor(x, dtype=torch.float32))))


def _sphere_grid():
    """A reflective floor and 63 reflective spheres in a 9x7 grid facing the
    camera: at 48x36 every one of the 64 objects wins some pixel, so the
    winner masks reach bits 32-63 and the compact slots of a pixel's winners
    run past the 32nd object."""
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.9, 0.9, 0.2), specular=(0.2, 0.2, 0.2),
                             pn=4)] + [
        rtt.MaterialSpec(name=f"m{i}", diffuse=(0.3 + 0.15 * i, 0.8 - 0.1 * i, 0.5),
                         specular=(0.4, 0.4, 0.4), pn=8) for i in range(4)]
    objs = [rtt.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0))] + [
        rtt.SphereSpec(f"m{k % 4}", 24.0, (-240.0 + 60.0 * (k % 9), -250.0 + 45.0 * (k // 9),
                                           300.0 + 10.0 * (k // 9)))
        for k in range(63)]
    scene, _ = rtt.build_scene(mats, objs, (0.0, -150.0, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), device="cpu")
    return scene


def _diffuse_pair():
    """tests/test_pallas.py:453's scene: a floor and a sphere, both diffuse."""
    mats = [rtt.MaterialSpec(name="d", diffuse=(0.5, 0.6, 0.7))]
    objs = [rtt.FloorSpec("d", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            rtt.SphereSpec("d", 80.0, (0.0, -30.0, 172.0))]
    scene, _ = rtt.build_scene(mats, objs, (0.0, -150.0, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0), device="cpu")
    return scene


_SMALL = dict(xres=32, yres=16, max_reflections=2, refraction_unroll=1)
_CASES = {
    # tests/test_pallas_bwd.py:209's scene and config
    "camera_x_0.37": (lambda: _camera_x(rtt.default_scene(device="cpu")[0], 0.37),
                      rtt.RenderConfig(**_SMALL)),
    # the default config: glass subtrees carry tangents
    "default_config": (lambda: rtt.default_scene(device="cpu")[0],
                       rtt.RenderConfig(xres=32, yres=16)),
    "all_diffuse_pair": (_diffuse_pair, rtt.RenderConfig(**_SMALL)),
}


def _planes(cfg, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres)).astype(np.float32))
            for _ in range(3)]


def _img(col):
    return np.stack([c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
                     for c in col], -1)


def _launch_host(lib, scene, cfg, g, return_primal, tail):
    """``kr.launch_all`` on K5's host build ``lib`` and the plain tables of
    ``scene``, held until it returns."""
    tables = kt.pack_scene(scene)
    return kr.launch_all(lib.rt_trace_retrace_host, [t.data_ptr() for t in tables],
                         tables[0].shape[0], torch.device("cpu"), cfg, g, return_primal, tail)


def _retrace_host(libs, scene, cfg, g):
    """K5's host build: the table cotangents and the image."""
    grads, prim = _launch_host(libs["trace_retrace"], scene, cfg, Color(*g), True, (None,))
    return grads, _img(prim)


def _bwd_host(libs, scene, cfg, g):
    """K2's host build: the table cotangents and the image."""
    tables = kt.pack_scene(scene)
    n = tables[0].shape[0]
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    libs["trace_bwd"].rt_trace_bwd_host(
        *(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
        *kb.launch_args(cfg, None, torch.device("cpu")), *(c.data_ptr() for c in g),
        block.data_ptr(), *(p.data_ptr() for p in prim), None)
    return kb.split_block(block, n), _img(prim)


def _fwd_host(libs, scene, cfg):
    tables = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    libs["trace"].rt_trace_host(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres, sx, sy,
        *kt.launch_args(cfg, None, torch.device("cpu"), scene.objects.count),
        *(p.data_ptr() for p in out), None)
    return _img(out)


def _masked(planes, agree):
    return Color(*(p * torch.from_numpy(agree) for p in planes))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_build_matches_plain_autograd(libs, case):
    make, cfg = _CASES[case]
    scene = make()
    assert kr.unsupported_reason(scene, cfg) is None
    planes = _planes(cfg, 0)
    _, prim = _retrace_host(libs, scene, cfg, planes)
    ref = _img(kt.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.9
    assert_boundary_only(ref, agree)
    g = _masked(planes, agree)
    got, _ = _retrace_host(libs, scene, cfg, g)
    assert_leaf_grads_close(scene, got, kr.render_grads_plain(scene, cfg, g), BUDGET)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_build_matches_backward_host_build(libs, case):
    """The oracle check: K5 and K2 derive the same cotangent by independent
    mechanisms, and both trace the forward's image, so no pixel is masked."""
    make, cfg = _CASES[case]
    scene = make()
    planes = _planes(cfg, 3)
    got, prim = _retrace_host(libs, scene, cfg, planes)
    want, prim_bwd = _bwd_host(libs, scene, cfg, planes)
    np.testing.assert_array_equal(prim, prim_bwd)
    assert assert_leaf_grads_close(scene, got, want, BUDGET) < 1e-3


def test_host_build_seeds_winners_past_bit_31(libs):
    """64 objects, each a winner somewhere (index 63 too): the 64-bit winner
    mask and the popcount slots of the compact seeding, against autograd of
    the plain version on the pixels where the images agree."""
    scene = _sphere_grid()
    cfg = rtt.RenderConfig(xres=48, yres=36)
    assert scene.objects.count == kr.OBJECT_MAX
    assert kr.unsupported_reason(scene, cfg) is None
    planes = _planes(cfg, 5)
    (g_f32t, _, _), prim = _retrace_host(libs, scene, cfg, planes)
    winners = set(torch.nonzero(g_f32t.abs().sum(1)).flatten().tolist())
    assert 63 in winners and len(winners & set(range(32, 64))) >= 24
    ref = _img(kt.render_color_plain(scene, cfg))
    agree = np.abs(prim - ref).max(-1) < 1e-4
    assert agree.mean() > 0.9
    assert_boundary_only(ref, agree)
    g = _masked(planes, agree)
    got, _ = _retrace_host(libs, scene, cfg, g)
    assert_leaf_grads_close(scene, got, kr.render_grads_plain(scene, cfg, g), BUDGET)


def test_counting_build_counts_passes(tmp_path):
    """The counting host build at 160x120: its histogram of distinct winners
    covers every pixel, its passes are ceil((10 + 19 w) / L) for a pixel of
    w winners, and they stay below the ceil(n_out / L) passes of seeding
    every entry."""
    lib = _build.build_host_library(tmp_path, "trace_retrace", count_ops=True)
    lanes = lib.rt_trace_retrace_lanes()
    scene = rtt.default_scene(device="cpu")[0]
    cfg = rtt.RenderConfig(xres=160, yres=120)
    ops = torch.zeros(kr.OPS_SLOTS, dtype=torch.int64)
    _launch_host(lib, scene, cfg, Color(*_planes(cfg, 6)), False, (ops.data_ptr(),))
    ops = ops.tolist()
    hist = ops[kr.HIST_SLOT:]
    pixels = cfg.xres * cfg.yres
    assert sum(hist) == pixels
    assert all(c == 0 for c in hist[scene.objects.count + 1:])
    assert hist[0] > 0 and hist[1] > 0 and hist[2] > 0  # sky, one winner, reflections
    per_w = [-(-(kr.SCENE_ENTRIES + 19 * w) // lanes) for w in range(len(hist))]
    assert ops[2] == sum(c * n for c, n in zip(hist, per_w))
    assert ops[3] == max(n for c, n in zip(hist, per_w) if c)
    full = -(-kr.n_out(scene.objects.count) // lanes)
    assert ops[2] / pixels < full
    # a warp's longest lane: at least the mean, at most the longest pixel
    warps = cfg.yres * -(-cfg.xres // 32)
    assert ops[2] / pixels <= ops[4] / warps <= ops[3]
    assert ops[0] > 0 and ops[1] == 0


_PRIMAL_CASES = {
    "default_config": (lambda: rtt.default_scene(device="cpu")[0],
                       rtt.RenderConfig(xres=40, yres=24)),
    "default_full_depth": (lambda: rtt.default_scene(device="cpu")[0],
                           rtt.RenderConfig(xres=40, yres=24, refraction_unroll=None)),
    "glass_cluster_six_reflections": (lambda: _glass_cluster(rtt),
                                      rtt.RenderConfig(xres=32, yres=24, max_reflections=6)),
    "patterns_black_bg": (lambda: _patterns_scene(rtt),
                          rtt.RenderConfig(xres=48, yres=32, bg="black")),
    "sixty_four_objects": (lambda: _many_spheres(rtt, 63), rtt.RenderConfig(xres=24, yres=16)),
    "sixty_four_object_grid": (_sphere_grid, rtt.RenderConfig(xres=48, yres=36)),
}


@pytest.mark.parametrize("case", sorted(_PRIMAL_CASES))
def test_host_primal_equals_forward_host_build(libs, case):
    make, cfg = _PRIMAL_CASES[case]
    scene = make()
    assert kr.unsupported_reason(scene, cfg) is None
    g = _planes(cfg, 1)
    _, prim = _retrace_host(libs, scene, cfg, g)
    np.testing.assert_array_equal(prim, _fwd_host(libs, scene, cfg))


def test_unsupported_reason_and_cpu_routing():
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=8, yres=6, max_reflections=2)
    assert kr.unsupported_reason(scene, cfg) is None
    assert kr.n_out(scene.objects.count) == 5 * 19 + 10
    assert "64 objects" in kr.unsupported_reason(_many_spheres(rtt, 64), cfg)
    with pytest.raises(ValueError, match="at most 64 objects"):  # before any launch
        kr.launch_all(None, [None] * 4, _many_spheres(rtt, 64).objects.count, torch.device("cpu"),
                      cfg, None, False, ())
    assert kr.unsupported_reason(_many_spheres(rtt, 63), cfg) is None
    textured = textured_scene(rtt, 1)
    assert "textures" in kr.unsupported_reason(textured, cfg)
    assert "K3" in kr.unsupported_reason(scene, cfg.with_(use_raymarching=True))
    assert "stack" in kr.unsupported_reason(scene, cfg.with_(max_reflections=7))
    g = Color(*(torch.zeros(6, 8) for _ in range(3)))
    with pytest.raises(ValueError, match="textures"):
        kr.render_grads_retrace(textured, cfg, g)
    # on the CPU: the plain version, and no launch
    planes = Color(*_planes(cfg, 2))
    got, prim = kr.render_grads_retrace(scene, cfg, planes, return_primal=True)
    for a, b in zip(got, kr.render_grads_plain(scene, cfg, planes)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(_img(prim), _img(kt.render_color_plain(scene, cfg)))
    assert kr.LAUNCHES == 0


@pytest.mark.slow
def test_host_build_matches_jax_retrace_kernel(libs):
    """K5's host build against the JAX kernel it replaces, in interpret mode,
    from one numpy scene (tests/test_pallas.py:500)."""
    import jax.numpy as jnp

    import ray_rust_tpu as rt
    from ray_rust_tpu.models.vec import Color as JaxColor
    from ray_rust_tpu.ops.pallas_trace import render_color_pallas_grads

    jscene, _ = rt.default_scene()
    jscene = jscene._replace(camera=jscene.camera._replace(
        position=jscene.camera.position._replace(x=jnp.float32(0.37))))
    scene = rtt.scene_from_numpy(rtt.scene_to_numpy(jscene), device="cpu")
    cfg = rtt.RenderConfig(**_SMALL)
    jcfg = rt.RenderConfig(**_SMALL)
    planes = _planes(cfg, 0)
    _, prim = _retrace_host(libs, scene, cfg, planes)
    ones = JaxColor(*(jnp.ones((cfg.yres, cfg.xres), jnp.float32) for _ in range(3)))
    _, jprim = render_color_pallas_grads(jscene, jcfg, ones, interpret=True, return_primal=True)
    agree = np.abs(prim - _img(jprim)).max(-1) < 1e-4
    assert agree.mean() > 0.9
    g = _masked(planes, agree)
    got, _ = _retrace_host(libs, scene, cfg, g)
    ct = render_color_pallas_grads(jscene, jcfg, JaxColor(*(jnp.asarray(p.numpy()) for p in g)),
                                   interpret=True)
    want = rtt.scene_to_numpy(ct)
    got = kb.leaf_grads(scene, got)
    for path, a in got.items():
        a = a.numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" in path:
            continue
        b = np.asarray(want[path], np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2)
        assert rel <= BUDGET, f"{path}: relative L2 {rel:.2e}"


@pytest.mark.cuda
def test_cuda_retrace_kernel_matches_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=320, yres=240)
    g = Color(*(p.cuda() for p in _planes(cfg, 4)))
    before = kr.LAUNCHES
    got, prim = kr.render_grads_retrace(scene, cfg, g, return_primal=True)
    want, prim_bwd = kb.render_grads_kernel(scene, cfg, g, return_primal=True)
    torch.cuda.synchronize()
    assert kr.LAUNCHES - before == 1  # one launch a cotangent
    np.testing.assert_array_equal(_img(prim), _img(kt.render_color_kernel(scene, cfg)))
    np.testing.assert_array_equal(_img(prim), _img(prim_bwd))
    assert_leaf_grads_close(scene, got, want, BUDGET)
