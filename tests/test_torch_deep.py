"""Deep ray trees in the port's kernels: the exact task-stack bound of K1, K2
and K5, and the buffer instances of K2 (past 192 sites) and K4 (past 35
laps), against the plain version and its autograd.

A task pushes a refraction sub-trace only at a level below the refraction
cap, and the stack pops its top first, so a pixel's stack holds at most
``kernel_trace.stack_tasks(cfg) = max(1, min(max_reflections, cap - 1))``
tasks: 3 at the default unroll, whatever ``max_reflections``. On the CPU:
that bound against a simulation of the push rule; K1's and K5's host
builds at 12 and 16 reflections on a cluster of glass spheres against the
plain trace and its autograd, their counting builds reaching the bound, and
in a box of transparent planes past 16 tasks (17 and 64); the buffer
instances' host twins (``rt_trace_bwd_buf_host``,
``rt_march_bwd_buf_host``, launched band by band as the wrappers launch the
kernels) at 319 sites and 39 laps against autograd, on scenes where a pixel
records more than the local caps hold (read back from a buffer filled
with ``RECORD_FILL``), and forced on configurations the local-record
instances take, bit for bit against them; the plain trace at 12
reflections against the JAX package's. The card's
kernels run in ``chip_smoke.py`` (phase 9) and in the ``cuda`` test here:
``python -m pytest --noconftest -m cuda tests/test_torch_deep.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.vec import Color
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
from ray_rust_tpu_torch.ops.rays import fov_scales

from .test_torch_kernel_bwd import assert_boundary_only, assert_leaf_grads_close
from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _compare,
    _glass_cluster,
    _img,
    _jax,
    _jax_cfg,
    one_torch_thread,
    textured_scene,
)

CPU = torch.device("cpu")
# the step-by-step march (the plain version's) with a step budget
_MARCH = dict(use_raymarching=True, glow_effect=1.0, march_max_iter=512,
              march_floor_skip=False)


class _Builds(dict):
    """Host libraries building in the background: ``[key]`` waits for one."""

    def __getitem__(self, key):
        return super().__getitem__(key).result()


@pytest.fixture(scope="module", autouse=True)
def libs(tmp_path_factory):
    """Each host library this file runs, built once, all started with the
    module (the march backward's takes the longest; the JAX comparison and
    the trace tests run meanwhile)."""
    d = tmp_path_factory.mktemp("deep_host")
    builds = {"trace": ("trace", False), "trace_ops": ("trace", True),
              "retrace": ("trace_retrace", False), "retrace_ops": ("trace_retrace", True),
              "trace_bwd": ("trace_bwd", False), "march_bwd": ("march_bwd", False)}
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        yield _Builds({k: pool.submit(_build.build_host_library, d, name, ops)
                       for k, (name, ops) in builds.items()})


@pytest.fixture(scope="module")
def glass():
    return _glass_cluster(rtt)


def test_plain_12_reflections_matches_jax_render():
    """The plain trace at 12 reflections against the JAX package's jnp
    trace, eager, within the golden budget, on the default scene at
    refraction_unroll=1 (eager JAX takes tens of seconds at the default
    unroll)."""
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    rt, _ = _jax()
    cfg = rtt.RenderConfig(xres=16, yres=12, max_reflections=12, refraction_unroll=1)
    jcfg = _jax_cfg(cfg)
    jax_scene = rt.default_scene()[0]
    vi, eye = camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(trace_image(jax_scene, jcfg, vi, eye))
    _compare(ref, _img(kt.render_color_plain(rtt.default_scene(device="cpu")[0], cfg)),
             frac_budget=0.02, mean_tol=0.01)


def _simulated_tasks(reflections: int, cap: int) -> int:
    """The most tasks the stack holds when every raycast hits glass and
    every trace runs to its last bounce: trace_body.cuh's push rule."""
    stack, most = [0], 1
    while stack:
        lev = stack.pop()
        for step in range(max(1, reflections - lev)):
            if lev + 1 + step < cap:
                stack.append(lev + 1 + step)
                most = max(most, len(stack))
    return most


def test_stack_tasks_is_the_push_rule_s_most():
    """kernel_trace.stack_tasks against the simulated stack for 0 to 13
    reflections and refraction caps 0 to 11; each kernel takes a config up
    to 64 tasks, and past it names the stack."""
    for reflections in range(14):
        for cap in range(12):
            cfg = rtt.RenderConfig(max_reflections=reflections, max_refractions=cap,
                                   refraction_unroll=None)
            assert kt.stack_tasks(cfg) == _simulated_tasks(reflections, cap), (reflections, cap)
    assert kt.stack_tasks(rtt.RenderConfig(max_reflections=1000)) == 3
    scene = rtt.default_scene(device="cpu")[0]
    deepest = rtt.RenderConfig(max_reflections=64, max_refractions=65, refraction_unroll=None)
    assert kt.stack_tasks(deepest) == kt.STACK_CAP_DEEP
    assert kt.unsupported_reason(scene, deepest) is None
    past = deepest.with_(max_reflections=65, max_refractions=66)
    for mod in (kt, kb, kr):
        assert "task stack" in mod.unsupported_reason(scene, past), mod.__name__


def _trace_host(lib, fn, scene, cfg, *tail):
    """K1's host build ``fn`` of ``lib`` on the CPU: the image, and with
    ``tail`` the counting build's (counter, tasks) pointers."""
    tables = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    getattr(lib, fn)(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
                     *kt.window(cfg), sx, sy,
                     *kt.launch_args(cfg, None, CPU, scene.objects.count),
                     *(p.data_ptr() for p in out), *(tail or (None,)))
    return out.permute(1, 2, 0).numpy()


def _retrace_host(lib, fn, scene, cfg, g, *tail):
    tables = kt.pack_scene(scene)
    return kr.launch_all(lib, fn, [t.data_ptr() for t in tables], scene.objects.count, CPU,
                         cfg, g, True, tail or (None,))


def _counters():
    return torch.zeros(kr.OPS_SLOTS, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)


@pytest.mark.parametrize("reflections", [12, 16])
def test_host_k1_and_k5_deep_reflections(libs, glass, reflections):
    """At 12 and 16 reflections and the default unroll (3 tasks; the old
    bound asked for 67 and 121): K1's host build against the plain trace of
    the glass cluster within the golden budget, K5's against autograd of it
    per scene leaf within 0.01 on the pixels where the images agree to 1e-4
    (tests/test_pallas_bwd.py:29-96), its image K1's bit for bit, and both
    counting builds show a pixel whose stack holds stack_tasks tasks, and
    none more."""
    cfg = rtt.RenderConfig(xres=32, yres=24, max_reflections=reflections)
    assert kt.stack_tasks(cfg) == 3 and kb.site_cap(cfg) == 192
    for mod in (kt, kb, kr):
        assert mod.unsupported_reason(glass, cfg) is None, mod.__name__
    want, vjp = kb.plain_vjp(glass, cfg)
    got = _trace_host(libs["trace"], "rt_trace_host", glass, cfg)
    _compare(_img(want), got, frac_budget=0.02, mean_tol=0.01)
    ops, tasks = _counters()
    np.testing.assert_array_equal(
        _trace_host(libs["trace_ops"], "rt_trace_tasks_host", glass, cfg, ops.data_ptr(),
                    tasks.data_ptr()), got)
    assert int(tasks[0]) == kt.stack_tasks(cfg)

    rng = np.random.default_rng(reflections)
    g = Color(*(torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
                for _ in range(3)))
    agree = np.abs(got - _img(want)).max(-1) < 1e-4  # the rest on decision boundaries
    assert agree.mean() > 0.9
    assert_boundary_only(_img(want), agree)
    g = Color(*(p * torch.from_numpy(agree.astype(np.float32)) for p in g))
    grads, prim = _retrace_host(libs["retrace"], "rt_trace_retrace_host", glass, cfg, g)
    np.testing.assert_array_equal(_img(prim), got)
    assert_leaf_grads_close(glass, grads, vjp(g), 0.01)
    ops, tasks = _counters()
    _retrace_host(libs["retrace_ops"], "rt_trace_retrace_tasks_host", glass, cfg, g,
                  ops.data_ptr(), tasks.data_ptr())
    assert int(tasks[0]) == kt.stack_tasks(cfg)


def test_host_k1_64_task_instance(libs):
    """Past 16 tasks K1 runs its 64-task instance: at 17 reflections and a
    refraction cap of 18 (17 tasks) on an opaque scene, which pushes no
    sub-trace, its image is the plain trace's at refraction cap 0 (the same
    function there) within the golden budget, and K5 takes the config."""
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.8, 0.8, 0.8), pattern=1,
                             pattern_scale=40.0),
            rtt.MaterialSpec(name="mirror", diffuse=(0.1, 0.1, 0.3), specular=(0.7, 0.7, 0.7),
                             pn=16)]
    objs = [rtt.FloorSpec("floor", (0.0, -120.0, 0.0), (0.0, 1.0, 0.0), uvmap=2)] + [
        rtt.SphereSpec("mirror", 45.0, (x, -40.0, z)) for x, z in [(-50, 150), (50, 150)]]
    scene, _ = rtt.build_scene(mats, objs, (0.0, 0.0, -150.0), (0.0, -np.pi / 2, -np.pi / 2),
                               (50.0, 60.0, -50.0), device="cpu")
    cfg = rtt.RenderConfig(xres=16, yres=12, max_reflections=17, max_refractions=18,
                           refraction_unroll=None)
    assert kt.stack_tasks(cfg) == 17 and kr.unsupported_reason(scene, cfg) is None
    got = _trace_host(libs["trace"], "rt_trace_host", scene, cfg)
    want = _img(kt.render_color_plain(scene, cfg.with_(max_refractions=0)))
    _compare(want, got, frac_budget=0.02, mean_tol=0.01)


def _bwd_host(lib, fn, scene, cfg, args, g, cap_words=0, extra=(), budget=kb.RECORD_BUDGET):
    """A backward host build ``fn`` of ``lib`` through the wrappers' own
    launchers: ``kernel_trace_bwd.launch_block`` for an instance with local
    records, ``launch_buffered`` (band by band within ``budget``) for a
    buffer instance. Returns the table cotangents and the image."""
    tables = kt.pack_scene(scene)
    ptrs = [t.data_ptr() for t in tables]
    n = scene.objects.count
    if cap_words:
        block, prim, bands = kb.launch_buffered(lib, getattr(lib, fn), ptrs, n, CPU, cfg, args,
                                                g, True, cap_words=cap_words, extra=extra,
                                                budget=budget)
        assert bands > 1
    else:
        block, prim = kb.launch_block(lib, getattr(lib, fn), ptrs, n, CPU, cfg, args, g, True)
    return kb.split_block(block, n), _img(prim)


def _planes(seed, cfg):
    rng = np.random.default_rng(seed)
    return Color(*(torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
                   for _ in range(3)))


def _k2_buf(lib, scene, cfg, g, budget):
    cap = kb.count_sites(cfg)
    return _bwd_host(lib, "rt_trace_bwd_buf_host", scene, cfg,
                     kb.kernel_args(cfg) + [cap] + kt.texture_args(None, CPU), g,
                     kb.RECORD_WORDS * cap, budget=budget)


def _k4_buf(lib, scene, cfg, g, budget):
    cap = kmb.count_sites(cfg)
    return _bwd_host(lib, "rt_march_bwd_buf_host", scene, cfg, kmb.launch_args(cfg, None, CPU),
                     g, kmb.RECORD_WORDS * cap, (cap,), budget)


def _box():
    """Six transparent planes facing in, a box round the camera: every ray
    inside hits one, and one that leaves through a plane meets the sides'
    fronts, so a pixel's ray tree fills most of the static one (at 42
    reflections about 280 of its 319 sites). Object 0, whose hit ends the
    bounce loop, is a small sphere out of reach."""
    mats = [rtt.MaterialSpec(name="dot", diffuse=(0.5, 0.5, 0.5)),
            rtt.MaterialSpec(name="glass", transparency=0.9, refraction=1.3,
                             diffuse=(0.1, 0.2, 0.1), specular=(0.95, 0.95, 0.95), pn=16,
                             pattern=1, pattern_scale=40.0)]
    objs = [rtt.SphereSpec("dot", 1.0, (0.0, 0.0, 5000.0))] + [
        rtt.FloorSpec("glass", tuple(-half * c for c in n), n)
        for half, axis in ((100.0, 0), (120.0, 1), (140.0, 2)) for sign in (1.0, -1.0)
        for n in [tuple(sign if k == axis else 0.0 for k in range(3))]]
    return rtt.build_scene(mats, objs, (10.0, 5.0, -20.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), device="cpu")[0]


def _recorded(lib, fn, scene, cfg, args, cap, cap_words, first_words, extra=()):
    """The most records of the first kind (K2's sites, K4's laps) one pixel
    of ``cfg``'s frame wrote, from a buffer instance's one-band launch into
    a buffer filled with ``RECORD_FILL`` (``kernel_trace_bwd.recorded``)."""
    pixels = cfg.xres * cfg.yres
    buf = torch.full((pixels * cap_words,), kb.RECORD_FILL, dtype=torch.int32)
    tables = kt.pack_scene(scene)
    _, _, bands = kb.launch_buffered(lib, getattr(lib, fn), [t.data_ptr() for t in tables],
                                     scene.objects.count, CPU, cfg, args, _planes(0, cfg), False,
                                     cap_words=cap_words, extra=extra, buf=buf)
    assert bands == 1
    return int(kb.recorded(buf, cap, first_words, pixels).max())


@pytest.mark.parametrize("case", ["7_reflections_unroll_none", "42_reflections"])
def test_host_k2_buffer_at_319_sites_matches_autograd(libs, case):
    """K2's buffer instance at 319 sites (33 KB of records a pixel) in bands
    of 3 rows, in the box of planes, where a pixel records more sites than
    the local caps: 42 reflections at the default unroll against autograd
    of the plain trace, and 7 reflections at refraction_unroll=None (7
    tasks deep) against K5's host build (forward-mode duals, an independent
    adjoint). Its image is K1's bit for bit, its cotangents the reference's
    per scene leaf within 0.01 (tests/test_pallas_bwd.py:84-96) on the
    pixels where K1's image and the plain one agree to 1e-4 (the rest on
    decision boundaries)."""
    scene = _box()
    if case == "42_reflections":
        cfg, past = rtt.RenderConfig(xres=8, yres=6, max_reflections=42), kb.SITE_CAPS[-1]
    else:
        cfg = rtt.RenderConfig(xres=8, yres=6, max_reflections=7, refraction_unroll=None)
        past = kb.SITE_CAPS[-2]
    assert kb.count_sites(cfg) == 319 and kb.buffered(cfg) and kb.site_cap(cfg) == 319
    assert kb.unsupported_reason(scene, cfg) is None
    lib, cap = libs["trace_bwd"], kb.count_sites(cfg)
    args = kb.kernel_args(cfg) + [cap] + kt.texture_args(None, CPU)
    assert _recorded(lib, "rt_trace_bwd_buf_host", scene, cfg, args, cap,
                     kb.RECORD_WORDS * cap, kb.SITE_WORDS) > past
    got = _trace_host(libs["trace"], "rt_trace_host", scene, cfg)
    g = _planes(7, cfg)
    if case == "42_reflections":
        want, vjp = kb.plain_vjp(scene, cfg)
        agree = np.abs(got - _img(want)).max(-1) < 1e-4
        assert agree.mean() > 0.9
        assert_boundary_only(_img(want), agree)
        g = Color(*(p * torch.from_numpy(agree.astype(np.float32)) for p in g))
        ref = vjp(g)
    else:
        ref, prim = _retrace_host(libs["retrace"], "rt_trace_retrace_host", scene, cfg, g)
        np.testing.assert_array_equal(_img(prim), got)
    grads, prim = _k2_buf(lib, scene, cfg, g, 3 * cfg.xres * 4 * kb.RECORD_WORDS * cap)
    np.testing.assert_array_equal(prim, got)
    assert_leaf_grads_close(scene, grads, ref, 0.01)


@pytest.mark.parametrize("case", ["default", "glass_cluster"])
def test_host_k4_buffer_at_39_laps_matches_autograd(libs, glass, case):
    """K4's buffer instance at raymarch_max_reflections=7 (39 laps, 7.5 KB
    of records a pixel), in bands of 4 rows, on the default scene and on the
    glass cluster, where a pixel records more laps than the local cap (35):
    its image is the plain march's within the golden budget, its cotangents
    autograd's (the implicit VJP) per scene leaf within 0.02
    (tests/test_pallas_bwd.py:306-321)."""
    scene, past = ((glass, kmb.SITE_CAP) if case == "glass_cluster"
                   else (rtt.default_scene(device="cpu")[0], 0))
    cfg = rtt.RenderConfig(xres=16, yres=12, raymarch_max_reflections=7, **_MARCH)
    assert kmb.count_sites(cfg) == 39 and kmb.buffered(cfg)
    assert kmb.unsupported_reason(scene, cfg) is None
    cap = kmb.count_sites(cfg)
    assert _recorded(libs["march_bwd"], "rt_march_bwd_buf_host", scene, cfg,
                     kmb.launch_args(cfg, None, CPU), cap, kmb.RECORD_WORDS * cap,
                     kmb.LAP_WORDS, (cap,)) > past
    want, vjp = kb.plain_vjp(scene, cfg)
    g = _planes(39, cfg)
    grads, prim = _k4_buf(libs["march_bwd"], scene, cfg, g,
                          4 * cfg.xres * 4 * kmb.RECORD_WORDS * cap)
    _compare(_img(want), prim, frac_budget=0.02, mean_tol=0.01)
    assert_leaf_grads_close(scene, grads, vjp(g), 0.02)


def test_host_64_task_stacks_fill_in_the_box(libs):
    """In the box of planes every bounce below the refraction cap pushes a
    sub-trace, so the counting builds of K1 and K5 reach the exact stack
    bound past 16 tasks: 17 at 17 reflections and a refraction cap of 18,
    and K1 64 (its deepest instance) at 64 and 65, every pixel finite (a
    stack that overflowed would turn its pixel to NaN). K2's buffer
    instance with the 64-task stack (196 607 sites, 20 MB of records a
    pixel) on a 2x2 window at 17 tasks: its image K1's bit for bit, its
    block finite, a pixel past 192 recorded sites."""
    scene = _box()
    for reflections, (w, h) in ((17, (16, 12)), (64, (8, 6))):
        cfg = rtt.RenderConfig(xres=w, yres=h, max_reflections=reflections,
                               max_refractions=reflections + 1, refraction_unroll=None)
        ops, tasks = _counters()
        image = _trace_host(libs["trace_ops"], "rt_trace_tasks_host", scene, cfg,
                            ops.data_ptr(), tasks.data_ptr())
        assert int(tasks[0]) == kt.stack_tasks(cfg) == reflections and np.isfinite(image).all()
    cfg = rtt.RenderConfig(xres=4, yres=3, max_reflections=17, max_refractions=18,
                           refraction_unroll=None)
    ops, tasks = _counters()
    grads, prim = _retrace_host(libs["retrace_ops"], "rt_trace_retrace_tasks_host", scene, cfg,
                                _planes(17, cfg), ops.data_ptr(), tasks.data_ptr())
    assert int(tasks[0]) == 17 and np.isfinite(_img(prim)).all()
    assert all(bool(torch.isfinite(t).all()) for t in grads)

    cfg = cfg.with_(xres=16, yres=12)
    origin, shape = (5, 7), (2, 2)
    cap = kb.count_sites(cfg)
    assert cap == 196607 and kb.unsupported_reason(scene, cfg) is None
    lib, tables = libs["trace_bwd"], kt.pack_scene(scene)
    buf = torch.full((4 * kb.RECORD_WORDS * cap,), kb.RECORD_FILL, dtype=torch.int32)
    g = Color(*(p[5:7, 7:9].contiguous() for p in _planes(17, cfg)))
    block, prim, bands = kb.launch_buffered(
        lib, lib.rt_trace_bwd_buf_host, [t.data_ptr() for t in tables], scene.objects.count,
        CPU, cfg, kb.kernel_args(cfg) + [cap] + kt.texture_args(None, CPU), g, True, origin,
        shape, kb.RECORD_WORDS * cap, buf=buf)
    assert bands == 1 and bool(torch.isfinite(block).all())
    np.testing.assert_array_equal(_img(prim),
                                  _trace_host(libs["trace"], "rt_trace_host", scene, cfg)[5:7, 7:9])
    assert int(kb.recorded(buf, cap, kb.SITE_WORDS, 4).max()) > kb.SITE_CAPS[-1]


@pytest.mark.parametrize("case", ["trace", "trace_glass_64", "march", "march_textured"])
def test_host_buffer_instances_match_local_records(libs, glass, case):
    """Each buffer instance forced on a configuration its local-record
    instance takes (record cap the site count), in bands, gives that
    instance's cotangents and image bit for bit: K2 at the default config
    and on the glass cluster at refraction_unroll=None (35 sites, cap 64),
    K4 (its buffer instance is the textured body) untextured and with the
    goldens' texture in Bilinear."""
    if case.startswith("trace"):
        scene = glass if case == "trace_glass_64" else rtt.default_scene(device="cpu")[0]
        cfg = rtt.RenderConfig(xres=20, yres=12,
                               refraction_unroll=None if case == "trace_glass_64" else 4)
        g = _planes(1, cfg)
        want = _bwd_host(libs["trace_bwd"], "rt_trace_bwd_host", scene, cfg,
                         kb.launch_args(cfg, None, CPU), g)
        got = _k2_buf(libs["trace_bwd"], scene, cfg, g,
                      5 * cfg.xres * 4 * kb.RECORD_WORDS * kb.count_sites(cfg))
    else:
        scene = (textured_scene(rtt, 1) if case == "march_textured"
                 else rtt.default_scene(device="cpu")[0])
        cfg = rtt.RenderConfig(xres=20, yres=12, **_MARCH)
        g = _planes(2, cfg)
        tex = kt.pack_textures(scene)  # held until the calls return
        args = kmb.launch_args(cfg, tex, CPU)
        want = _bwd_host(libs["march_bwd"], "rt_march_bwd_host", scene, cfg, args, g)
        cap = kmb.count_sites(cfg)
        got = _bwd_host(libs["march_bwd"], "rt_march_bwd_buf_host", scene, cfg, args, g,
                        kmb.RECORD_WORDS * cap, (cap,), 5 * cfg.xres * 4 * kmb.RECORD_WORDS * cap)
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.cuda
def test_cuda_deep_kernels(monkeypatch):
    """On the card: K1 at 12 reflections bit for bit against the plain trace
    at 320x240; K2 at 319 sites and K4 at 39 laps (their buffer instances,
    the record budget cut to a quarter of the frame's rows: 4 bands)
    against autograd at 64x48 within 0.01 and 0.02, their images the
    forward kernels'; K5 at 8 and 16 reflections against K2 within 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_rust_tpu_torch.ops import kernel_march as km

    scene = rtt.default_scene()[0]
    cfg = rtt.RenderConfig(xres=320, yres=240, max_reflections=12)
    np.testing.assert_array_equal(_img(kt.render_color_kernel(scene, cfg)),
                                  _img(kt.render_color_plain(scene, cfg)))
    for mod, fwd, c, budget in (
            (kb, kt, rtt.RenderConfig(xres=64, yres=48, max_reflections=7,
                                      refraction_unroll=None), 0.01),
            (kmb, km, rtt.RenderConfig(xres=64, yres=48, raymarch_max_reflections=7, **_MARCH),
             0.02)):
        assert mod.buffered(c)
        words = (kb.RECORD_WORDS * kb.site_cap(c) if mod is kb
                 else kmb.RECORD_WORDS * kmb.count_sites(c))
        monkeypatch.setattr(kb, "RECORD_BUDGET", 4 * words * c.xres * (c.yres // 4))
        before = mod.BUF_LAUNCHES
        g = Color(*(torch.ones(c.yres, c.xres, device="cuda") for _ in range(3)))
        got, prim = mod.render_grads_kernel(scene, c, g, return_primal=True)
        assert mod.BUF_LAUNCHES - before == 4
        np.testing.assert_array_equal(_img(prim), _img(fwd.render_color_kernel(scene, c)))
        assert_leaf_grads_close(scene, got, mod.render_grads_plain(scene, c, g), budget)
    for reflections in (8, 16):
        c = rtt.RenderConfig(xres=64, yres=48, max_reflections=reflections)
        g = Color(*(torch.ones(c.yres, c.xres, device="cuda") for _ in range(3)))
        assert_leaf_grads_close(scene, kr.render_grads_retrace(scene, c, g),
                                kb.render_grads_kernel(scene, c, g), 0.01)
