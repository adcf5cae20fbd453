"""The multi-device layer's forward half on CPU meshes, against the JAX
package: twins of tests/test_sharding.py:23-97,134-230.

A window of the frame (``origin=``, ``shape=``) renders the whole frame's
pixels bit for bit, in the plain versions and in the kernels' bodies built
with g++ (K1 with K1b's cull on 101 objects, whose tiles take global
corners; K3 with glow); the mesh of eight ``cpu`` cells stitches the JAX
whole-frame render within the JAX test's budget; the banded u8 path, the
mesh's checks, the one-process multihost path, and two real processes over
gloo on localhost, which import no JAX, each gathering the single-process
image bit for bit. The kernels' windows on the card run only there:
``python -m pytest --noconftest -m cuda tests/test_torch_sharding.py``.
"""

import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import _build, cull
from ray_rust_tpu_torch.ops import kernel_march as km
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops.rays import fov_scales
from ray_rust_tpu_torch.parallel import multihost
from ray_rust_tpu_torch.parallel.shard import (
    make_mesh,
    render_sharded,
    render_sharded_kernel,
    render_tiled_u8,
    render_tiles,
)

from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _compare,
    _img,
    _jax_cfg,
    _many_spheres,
    _port,
    one_torch_thread,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_GLOW = dict(use_raymarching=True, glow_effect=1.0)

# name -> (scene, config): the default scene, BASELINE.md configuration 4's
# 101 objects (K1b's cull on, above 64), and march with glow
_CASES = {
    "trace_default": (lambda: rtt.default_scene(device="cpu")[0],
                      rtt.RenderConfig(xres=48, yres=32, max_reflections=2, refraction_unroll=1)),
    "trace_101_cull": (lambda: _many_spheres(rtt, 100),
                       rtt.RenderConfig(xres=48, yres=32, max_reflections=2, refraction_unroll=1)),
    "march_glow": (lambda: rtt.default_scene(device="cpu")[0],
                   rtt.RenderConfig(xres=32, yres=16, max_refractions=1, march_max_iter=400,
                                    **_GLOW)),
}
# windows as (row0, col0, h, w) fractions of the frame: a 2x2 mesh's corner
# cell, a 3x1 mesh's middle band (its edges cut 16x16 blocks), and a ragged
# window at odd offsets
_WINDOWS = {"quadrant": lambda H, W: (H // 2, W // 2, H // 2, W // 2),
            "band": lambda H, W: (H // 4, 0, H // 2, W),
            "ragged": lambda H, W: (5, 7, H - 9, W - 12)}


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, (make, _) in _CASES.items()}


@pytest.fixture(scope="module")
def whole(scenes):
    """Each case's whole-frame plain image."""
    return {name: _img(kt.render_color_plain(scenes[name], cfg))
            for name, (_, cfg) in _CASES.items()}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """K1's and K3's bodies built with g++, the two builds at once."""
    out = tmp_path_factory.mktemp("window_host")
    with ThreadPoolExecutor(2) as pool:
        libs = {n: pool.submit(_build.build_host_library, out, n) for n in ("trace", "march")}
        return {n: f.result() for n, f in libs.items()}


def _host_render(libs, scene, cfg, win):
    """The host build's image of window ``win`` = (row0, col0, h, w), K1's
    cull as its wrapper takes it."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    out = torch.empty((3, win[2], win[3]), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    if cfg.use_raymarching:
        fn, args = libs["march"].rt_march_host, km.launch_args(cfg, tex, CPU)
    else:
        fn = libs["trace"].rt_trace_host
        args = kt.launch_args(cfg, tex, CPU, scene.objects.count)
    fn(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres, *win, sx, sy,
       *args, *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def _crop(img, win):
    r, c, h, w = win
    return img[r:r + h, c:c + w]


@pytest.mark.parametrize("window", sorted(_WINDOWS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_window_plain_is_crop(scenes, whole, case, window):
    """The plain version of a window is the whole frame's crop bit for bit:
    its rays keep their global pixels and the frame's size."""
    cfg = _CASES[case][1]
    win = _WINDOWS[window](cfg.yres, cfg.xres)
    got = _img(kt.render_color_plain(scenes[case], cfg, win[:2], win[2:]))
    np.testing.assert_array_equal(got, _crop(whole[case], win))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_window_is_crop_and_matches_plain(host_libs, scenes, whole, case):
    """The kernel's body (K1, with K1b's cull on the 101 objects, or K3)
    renders each window as its whole frame's crop bit for bit, and the
    windowed plain version within the host builds' budgets
    (tests/test_torch_kernel_trace.py, tests/test_torch_march.py)."""
    scene, cfg = scenes[case], _CASES[case][1]
    assert kt.cull_on(cfg, scene.objects.count) == (case == "trace_101_cull")
    full = _host_render(host_libs, scene, cfg, (0, 0, cfg.yres, cfg.xres))
    budget = dict(frac_budget=0.02, mean_tol=0.01) if cfg.use_raymarching else {}
    _compare(whole[case], full, **budget)
    for window in sorted(_WINDOWS):
        win = _WINDOWS[window](cfg.yres, cfg.xres)
        got = _host_render(host_libs, scene, cfg, win)
        np.testing.assert_array_equal(got, _crop(full, win), err_msg=window)
        _compare(_crop(whole[case], win), got, **budget)


def test_cull_tiles_start_at_the_window_origin():
    """K1b's tiles of a window are its 16x16 blocks from its corner, at the
    frame's global pixels (the host build's and the kernel's corners)."""
    cfg = rtt.RenderConfig(xres=48, yres=32)
    assert cull.tiles(cfg) == [(c, r) for r in (0, 16) for c in (0, 16, 32)]
    assert cull.tiles(cfg, (5, 7), (23, 36)) == [(7, 5), (23, 5), (39, 5), (7, 21), (23, 21),
                                                 (39, 21)]
    with pytest.raises(ValueError, match="not in the"):
        cull.tiles(cfg, (5, 7), (28, 36))


def _cpu_mesh(dp, sp):
    return make_mesh([CPU] * (dp * sp), dp=dp, sp=sp)


@pytest.fixture(scope="module")
def default_scene():
    return rtt.default_scene(device="cpu")[0]


def test_sharded_matches_jax_whole_frame(default_scene):
    """tests/test_sharding.py:23-35's twin: a 4x2 mesh of cpu cells stitches
    the JAX package's whole-frame render_color within that test's budget
    (<= 6% of pixels off by more than 1e-3, mean < 0.02), and is the port's
    whole frame bit for bit."""
    import ray_rust_tpu as rt

    cfg = rtt.RenderConfig(xres=64, yres=32, max_refractions=1)
    jax_scene, _ = rt.default_scene()
    ref = _img(rt.render_color(jax_scene, _jax_cfg(cfg)))
    got = _img(render_sharded(_port(jax_scene), cfg, _cpu_mesh(4, 2)))
    diff = np.abs(got - ref)
    assert (diff.max(-1) > 1e-3).mean() <= 0.06
    assert diff.mean() < 0.02
    np.testing.assert_array_equal(got, _img(rtt.render_color(_port(jax_scene), cfg)))


def test_sharded_march_matches_jax(default_scene):
    """tests/test_sharding.py:82-97's twin: the march with glow on a 2x4
    mesh against the JAX jnp march of the whole frame (eager, one march step
    a while iteration), within that test's budget (8%, mean 0.03)."""
    from ray_rust_tpu.ops.rays import camera_rays as jax_rays
    from ray_rust_tpu.ops.trace import trace_image as jax_trace_image

    import ray_rust_tpu as rt

    cfg = rtt.RenderConfig(xres=32, yres=16, max_refractions=1, march_max_iter=1000, **_GLOW)
    jax_scene, _ = rt.default_scene()
    jcfg = _jax_cfg(cfg).with_(march_tiles=1, march_chunk=1)
    vi, eye = jax_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(jax_trace_image(jax_scene, jcfg, vi, eye))
    got = _img(render_sharded_kernel(_port(jax_scene), cfg, _cpu_mesh(2, 4)))
    diff = np.abs(got - ref)
    assert (diff.max(-1) > 1e-3).mean() <= 0.08
    assert diff.mean() < 0.03


def test_sharded_layout(default_scene):
    """tests/test_sharding.py:38-43's twin: each cell's tile is its 8x32
    window on its device, at its global origin."""
    cfg = rtt.RenderConfig(xres=64, yres=32, max_reflections=1, refraction_unroll=0)
    tiles = render_tiles(default_scene, cfg, _cpu_mesh(4, 2))
    assert {tuple(t.color.r.shape) for t in tiles} == {(8, 32)}
    assert {t.color.r.device for t in tiles} == {CPU}
    assert sorted((t.index, t.origin) for t in tiles) == [
        ((i, j), (8 * i, 32 * j)) for i in range(4) for j in range(2)]


def test_tiled_matches_render_u8(default_scene):
    """tests/test_sharding.py:46-51's twin: bands of 8 rows over an 8x1 mesh
    give render_u8's frame bit for bit; a band height that does not divide
    the rows trips the JAX package's assertion."""
    cfg = rtt.RenderConfig(xres=32, yres=32, max_refractions=1)
    mesh = _cpu_mesh(8, 1)
    np.testing.assert_array_equal(render_tiled_u8(default_scene, cfg, mesh, rows_per_tile=8),
                                  rtt.render_u8(default_scene, cfg))
    with pytest.raises(AssertionError):
        render_tiled_u8(default_scene, cfg, mesh, rows_per_tile=12)


def test_indivisible_mesh_raises(default_scene):
    """tests/test_sharding.py:100-104's twin."""
    cfg = rtt.RenderConfig(xres=30, yres=30)
    with pytest.raises(ValueError, match="not divisible"):
        render_sharded(default_scene, cfg, _cpu_mesh(4, 2))
    with pytest.raises(ValueError, match="mesh 3x2"):
        make_mesh([CPU] * 8, dp=3, sp=2)


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    """Without devices, make_mesh takes every CUDA device, and raises where
    there is none; a cell may repeat a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    mesh = make_mesh([CPU] * 8)
    assert mesh.shape == {"dp": 8, "sp": 1} and not mesh.multiprocess


def test_cpu_sharded_gradient_sums_the_windows(default_scene):
    """On a CPU mesh autograd runs through the plain version of every window:
    the leaf's gradient sums the windows' parts (in another order than the
    whole frame's) and is the whole frame's. The CUDA mesh's gradient, K2 and
    K4 on each window, is tests/test_torch_sharded_grad.py's."""
    leaf = default_scene.light.x.clone().requires_grad_()
    scene = default_scene._replace(light=default_scene.light._replace(x=leaf))
    cfg = rtt.RenderConfig(xres=16, yres=8, max_reflections=1, refraction_unroll=0)
    render_sharded(scene, cfg, _cpu_mesh(2, 2)).r.sum().backward()
    want = torch.autograd.grad(rtt.render_color(scene, cfg).r.sum(), leaf)[0]
    torch.testing.assert_close(leaf.grad, want, rtol=1e-6, atol=0.0)


def test_multihost_api_single_process(default_scene):
    """tests/test_sharding.py:134-151's twin: init_distributed does nothing
    in one process, the global mesh spans the local devices, and the
    gathered image is the sharded render's."""
    assert multihost.init_distributed() is False
    assert multihost.is_primary() and multihost.world_size() == 1
    mesh = multihost.global_mesh(dp=4, sp=2, devices=[CPU] * 8)
    cfg = rtt.RenderConfig(xres=64, yres=32, max_reflections=1, refraction_unroll=0)
    img = multihost.render_multihost(default_scene, cfg, mesh)
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(img, _img(render_sharded(default_scene, cfg, mesh)))


_CHILD = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
from ray_rust_tpu_torch.parallel import multihost
import ray_rust_tpu_torch as rtt

assert multihost.init_distributed(backend="gloo") is True
assert multihost.world_size() == 2
scene, _ = rtt.default_scene(device="cpu")
cfg = rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1)
mesh = multihost.global_mesh(dp=2, sp=2, devices=[torch.device("cpu")] * 2)
assert len(mesh.local_cells()) == 2 and mesh.multiprocess
img = multihost.render_multihost(scene, cfg, mesh)
assert not any(m == "jax" or m.startswith(("jax.", "ray_rust_tpu.")) for m in sys.modules)
np.save(sys.argv[1], img)
"""


def test_two_process_gloo_render(tmp_path, default_scene):
    """tests/test_sharding.py:154-230's twin: two processes join a gloo
    group on localhost through init_distributed's torchrun variables, each
    renders its row of a 2x2 global mesh, and both gather the
    single-process image bit for bit; neither imports JAX."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), PYTHONPATH=_REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path / f"{rank}")],
                                      env=env, cwd=_REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out}\n{err}"
    cfg = rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1)
    want = _img(rtt.render_color(default_scene, cfg))
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"{rank}.npy"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("march", [False, True])
def test_kernel_windows_on_card(march):
    """On the card: K1 (K3) on a 2x2 and a 3x1 mesh of cuda:0 stitches the
    whole-frame launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=96, yres=48, **(_GLOW if march else {}))
    want = _img(rtt.render_color(scene, cfg))
    for dp, sp in ((2, 2), (3, 1)):
        mesh = make_mesh([torch.device("cuda", 0)] * (dp * sp), dp=dp, sp=sp)
        np.testing.assert_array_equal(_img(render_sharded(scene, cfg, mesh)), want)
