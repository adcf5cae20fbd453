"""The last configurations the port's kernels took only in part: march
refraction caps past 10 (K3's deep instance ``march_fwd_deep`` and K4's
buffer instance, both on the deep march, ``csrc/march_body.cuh:
raymarch_deep``) and texture banks past ``kernel_trace.TEXTURE_MAX`` = 1 024
textures (K1-K4 in their global-table builds, which read the meta rows from
global memory).

On the CPU: the plain march at refraction cap 12 against the JAX package's
eager jnp march on a box of transparent planes, where every lap refracts and
a pixel nests 12 raymarch calls; the g++ host build of the deep march
against the recursive body's (``rt_march_host``) at caps 4 and 10 bit for
bit, and against the plain march at cap 12 on the box bit for bit (where the
recursive body, whose chain of levels stops at 10, poisons the pixel); K4's
buffer instance's host twin at cap 12 against autograd of the plain march,
its records showing the chain of 12 nested calls; K1's host body on a bank
of 1 101 textures (the floor's the last) bit for bit against the same scene
with the floor's texture alone, and the plain port against the JAX package's
textured jnp trace; and the refusals that remain. The card's kernels run in
``chip_smoke.py`` (phase 10) and in the ``cuda`` test here:
``python -m pytest --noconftest -m cuda tests/test_torch_deep_march.py``.
"""

import types
from concurrent.futures import ThreadPoolExecutor

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

from .test_torch_kernel_bwd import assert_leaf_grads_close
from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _compare,
    _img,
    _jax,
    one_torch_thread,
)
from .test_torch_texture import _jax_cfg

CPU = torch.device("cpu")
# tests/test_parity.py:152-161: at most 2% of pixels off by more than 1e-3,
# mean difference at most 0.01
GOLDEN = dict(frac_budget=0.02, mean_tol=0.01)
# the step-by-step march at refraction cap 12, every sub-march's chain of
# levels unrolled (refraction_unroll=None)
_DEEP = dict(use_raymarching=True, glow_effect=1.0, max_refractions=12,
             refraction_unroll=None, march_floor_skip=False)


class _Builds(dict):
    """Host libraries building in the background: ``[key]`` waits for one."""

    def __getitem__(self, key):
        return super().__getitem__(key).result()


@pytest.fixture(scope="module", autouse=True)
def libs(tmp_path_factory):
    """The host libraries this file runs, built once, all started with the
    module (the JAX comparison runs meanwhile)."""
    d = tmp_path_factory.mktemp("deep_march_host")
    with ThreadPoolExecutor(max_workers=3) as pool:
        yield _Builds({name: pool.submit(_build.build_host_library, d, name)
                       for name in ("march", "march_bwd", "trace")})


def glass_box(pkg):
    """tests/test_torch_deep.py's box of six transparent planes round the
    camera, built by ``pkg``: every lap's march ends on a plane and
    refracts, so each lap below the cap starts a sub-march, and a pixel's
    chain of nested raymarch calls reaches the refraction cap."""
    mats = [pkg.MaterialSpec(name="dot", diffuse=(0.5, 0.5, 0.5)),
            pkg.MaterialSpec(name="glass", transparency=0.9, refraction=1.3,
                             diffuse=(0.1, 0.2, 0.1), specular=(0.95, 0.95, 0.95), pn=16,
                             pattern=1, pattern_scale=40.0)]
    objs = [pkg.SphereSpec("dot", 1.0, (0.0, 0.0, 5000.0))] + [
        pkg.FloorSpec("glass", tuple(-half * c for c in n), n)
        for half, axis in ((100.0, 0), (120.0, 1), (140.0, 2)) for sign in (1.0, -1.0)
        for n in [tuple(sign if k == axis else 0.0 for k in range(3))]]
    kw = {"device": "cpu"} if pkg is rtt else {}
    return pkg.build_scene(mats, objs, (10.0, 5.0, -20.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **kw)[0]


def bank_scene(pkg, n_tex=1101, filt=0):
    """The default scene whose floor reads texture ``n_tex - 1`` of a bank of
    ``n_tex`` 16x16 crops of the goldens' noise texture
    (tests/goldens/gen_textured.py), crop 1 100 whatever ``n_tex``; the
    other textures belong to materials no object takes."""
    noise = np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8)

    def crop(k):
        row, col = 16 * (k // 16 % 16), 16 * (k % 16)
        return noise[row:row + 16, col:col + 16]

    mats = [pkg.MaterialSpec(name=f"t{k}", texture=crop(k)) for k in range(n_tex - 1)] + [
        pkg.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0), pattern=2, pattern_scale=300.0,
                         pattern_angle_scale=0.2, texture_filter=filt, texture=crop(1100)),
        pkg.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24),
        pkg.MaterialSpec(name="red", diffuse=(0.8, 0.0, 0.0), pn=24, glow_dist=5.0),
        pkg.MaterialSpec(name="transparent", transparency=1.0, refraction=1.5,
                         frac=(1.49998, 1.49999, 1.5))]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            pkg.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
            pkg.SphereSpec("mirror", 80.0, (-200.0, -30.0, 172.0)),
            pkg.SphereSpec("red", 80.0, (-200.0, -200.0, 172.0)),
            pkg.SphereSpec("transparent", 100.0, (70.0, -200.0, 150.0))]
    kw = {"device": "cpu"} if pkg is rtt else {}
    return pkg.build_scene(mats, objs, (0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **kw)[0]


def _march_host(lib, fn, scene, cfg):
    """K3's host build ``fn`` (``rt_march_host``, ``rt_march_deep_host``)
    over the whole frame."""
    f32t, i32t, cam, light = kt.pack_scene(scene)
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    getattr(lib, fn)(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(),
                     scene.objects.count, cfg.xres, cfg.yres, *kt.window(cfg), sx, sy,
                     *km.launch_args(cfg, None, CPU), *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def _trace_host(lib, scene, cfg):
    """K1's host build with the scene's atlas."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)  # held until the call returns
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    sx, sy = fov_scales(cfg)
    lib.rt_trace_host(*(t.data_ptr() for t in tables), scene.objects.count,
                      cfg.xres, cfg.yres, *kt.window(cfg), sx, sy,
                      *kt.launch_args(cfg, tex, CPU, scene.objects.count),
                      *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def test_plain_bank_of_1101_textures_matches_jax():
    """The plain port's textured trace on the 1 101-texture bank against the
    JAX package's jnp trace (which renders a bank past its kernel's chunk
    through jnp), eager (jitted, XLA's rounding flips 6.6% of the Nearest
    floor's texels here), at 32x24 and one bounce, within the golden
    budget."""
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    rt, _ = _jax()
    cfg = rtt.RenderConfig(xres=32, yres=24, max_reflections=1, refraction_unroll=0)
    jcfg = _jax_cfg(cfg)
    jax_scene = bank_scene(rt)
    vi, eye = camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(trace_image(jax_scene, jcfg, vi, eye))
    _compare(ref, _img(kt.render_color_plain(bank_scene(rtt), cfg)), **GOLDEN)


def test_plain_march_cap_12_matches_jax_march():
    """The plain march at refraction cap 12 on the box of planes (8x6, one
    lap a call: 12 laps, a chain of 12 nested calls) against the JAX
    package's jnp march, eager, one step per while iteration
    (``march_chunk=1``), at a 300-step budget on both sides, within the
    golden budget. At three laps a call (43 laps) the eager JAX march takes
    about a minute here."""
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    rt, _ = _jax()
    cfg = rtt.RenderConfig(xres=8, yres=6, march_max_iter=300, raymarch_max_reflections=1,
                           **_DEEP)
    assert kmb.count_sites(cfg) == 12 and km.deep(cfg)
    jcfg = _jax_cfg(cfg, march_tiles=1, march_chunk=1)
    jax_scene = glass_box(rt)
    vi, eye = camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jcfg)
    ref = _img(trace_image(jax_scene, jcfg, vi, eye))
    got = _img(km.render_color_plain(glass_box(rtt), cfg))
    assert np.isfinite(got).all() and got.std() > 0
    _compare(ref, got, **GOLDEN)


@pytest.mark.parametrize("cap", [4, 10])
def test_host_deep_march_matches_recursive_body(libs, cap):
    """The deep march (one loop over an explicit stack) against the
    recursive body (one inlined level a depth) at refraction caps 4 and 10,
    where both take the scene, bit for bit: the default scene with glow,
    floor tail on and off, and the box of planes."""
    lib = libs["march"]
    for scene, kw in ((rtt.default_scene(device="cpu")[0], dict(march_floor_skip=True)),
                      (rtt.default_scene(device="cpu")[0], dict(march_floor_skip=False)),
                      (glass_box(rtt), dict(march_floor_skip=False))):
        cfg = rtt.RenderConfig(xres=24, yres=18, use_raymarching=True, glow_effect=1.0,
                               max_refractions=cap, refraction_unroll=None, march_max_iter=1000,
                               **kw)
        want = _march_host(lib, "rt_march_host", scene, cfg)
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(_march_host(lib, "rt_march_deep_host", scene, cfg), want)


def test_host_deep_march_cap_12_matches_plain(libs):
    """At refraction cap 12 with the floor tail off, on the box of planes:
    the deep march is the plain march bit for bit, while the recursive body,
    whose chain of levels stops at 10 calls, turns the pixels that nest past
    it to NaN (it never drops a sub-march): the box does nest past 10."""
    scene = glass_box(rtt)
    cfg = rtt.RenderConfig(xres=8, yres=6, march_max_iter=500, **_DEEP)
    want = _img(km.render_color_plain(scene, cfg))
    got = _march_host(libs["march"], "rt_march_deep_host", scene, cfg)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(_march_host(libs["march"], "rt_march_host", scene, cfg)).any(-1).mean() > 0.5


def test_host_k4_buffer_cap_12_matches_autograd(libs):
    """K4's buffer instance (its record pass the deep march) at refraction
    cap 12 and 3 laps a call (43 laps, 40 frames) on the box of planes, in
    one band into a buffer filled with RECORD_FILL and in bands of 2 rows:
    its records show a pixel whose chain of nested raymarch calls is 12
    deep; its image is the deep march's bit for bit; its cotangents are
    autograd's of the plain march (the implicit VJP) per scene leaf within
    0.02 (tests/test_pallas_bwd.py:306-321)."""
    scene = glass_box(rtt)
    cfg = rtt.RenderConfig(xres=8, yres=6, march_max_iter=500, **_DEEP)
    cap = kmb.count_sites(cfg)
    assert (cap, kmb.count_frames(cfg)) == (43, 40) and kmb.buffered(cfg)
    assert kmb.unsupported_reason(scene, cfg) is None
    lib, tables = libs["march_bwd"], kt.pack_scene(scene)
    ptrs, n, pixels = [t.data_ptr() for t in tables], scene.objects.count, cfg.xres * cfg.yres
    args = kmb.launch_args(cfg, None, CPU)
    rng = np.random.default_rng(12)
    g = Color(*(torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres)).astype(np.float32))
                for _ in range(3)))
    want, vjp = kb.plain_vjp(scene, cfg)
    image = _march_host(libs["march"], "rt_march_deep_host", scene, cfg)
    buf = torch.full((pixels * kmb.RECORD_WORDS * cap,), kb.RECORD_FILL, dtype=torch.int32)
    block, prim, bands = kb.launch_buffered(lib, lib.rt_march_bwd_buf_host, ptrs, n, CPU, cfg,
                                            args, g, True, cap_words=kmb.RECORD_WORDS * cap,
                                            extra=(cap,), buf=buf)
    assert bands == 1
    assert int(kmb.nesting(buf, cap, pixels).max()) == 12
    assert int(kb.recorded(buf, cap, kmb.LAP_WORDS, pixels).max()) > kmb.SITE_CAP
    np.testing.assert_array_equal(_img(prim), image)
    np.testing.assert_array_equal(image, _img(want))
    ref = vjp(g)
    assert_leaf_grads_close(scene, kb.split_block(block, n), ref, 0.02)
    banded, prim, bands = kb.launch_buffered(lib, lib.rt_march_bwd_buf_host, ptrs, n, CPU, cfg,
                                             args, g, True, cap_words=kmb.RECORD_WORDS * cap,
                                             extra=(cap,),
                                             budget=2 * cfg.xres * 4 * kmb.RECORD_WORDS * cap)
    assert bands == 3
    np.testing.assert_array_equal(_img(prim), image)
    assert_leaf_grads_close(scene, kb.split_block(banded, n), ref, 0.02)


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_host_k1_bank_of_1101_textures(libs, filt):
    """K1's host body on the default scene whose floor reads texture 1 100
    of a bank of 1 101: bit for bit the same scene with the floor's texture
    alone (texture 0 of a bank of 1), so the meta row it reads is the last;
    within the golden budget of the plain textured trace (the host build's
    libm rounds a few sky pixels apart from torch's, as for one texture)."""
    big, alone = bank_scene(rtt, 1101, filt), bank_scene(rtt, 1, filt)
    assert big.textures.packed.shape[0] == 1101
    assert int(big.materials.texture_id[big.objects.mat[0]]) == 1100
    cfg = rtt.RenderConfig(xres=64, yres=48)
    got = _trace_host(libs["trace"], big, cfg)
    np.testing.assert_array_equal(got, _trace_host(libs["trace"], alone, cfg))
    _compare(_img(kt.render_color_plain(big, cfg)), got, **GOLDEN)
    untextured = _img(kt.render_color_plain(rtt.default_scene(device="cpu")[0], cfg))
    assert (np.abs(got - untextured).max(-1) > 1e-3)[cfg.yres // 2:].mean() > 0.5  # the floor


def test_deep_march_and_large_bank_reasons():
    """Refraction caps 11 to 64 go to the deep instances (K3's
    march_fwd_deep, K4's buffer instance at any lap count); 65 is refused,
    naming the 64-frame stack. A bank past 1 024 textures goes to the
    global-table builds of K1-K4 and stages no meta row; an atlas of 2^31
    texels is taken too (the kernels' texel index is 64-bit)."""
    scene = rtt.default_scene(device="cpu")[0]
    for cap in range(11, 65):
        cfg = rtt.RenderConfig(use_raymarching=True, max_refractions=cap, refraction_unroll=None,
                               raymarch_max_reflections=1)
        assert km.unsupported_reason(scene, cfg) is None and km.deep(cfg), cap
        assert kmb.unsupported_reason(scene, cfg) is None and kmb.buffered(cfg), cap
        assert km.library_name(scene, cfg) == "march_fwd_deep"
    cfg = rtt.RenderConfig(use_raymarching=True, max_refractions=10, refraction_unroll=None)
    assert not km.deep(cfg) and not kmb.buffered(cfg)
    assert km.library_name(scene, cfg) == "march_fwd"
    past = cfg.with_(max_refractions=65)
    for mod in (km, kmb):
        reason = mod.unsupported_reason(scene, past)
        assert "task stack holds 64 frames" in reason, mod.__name__

    def fake(shape):  # a scene of 5 objects with a bank of ``shape``
        return types.SimpleNamespace(objects=types.SimpleNamespace(count=5),
                                     textures=types.SimpleNamespace(
                                         packed=types.SimpleNamespace(shape=shape)))

    big = fake((60000, 1, 1, 12))
    assert kt.size_reason(big) is None
    # an atlas of 2^31 texels or more: the kernels index it in 64 bits
    assert kt.size_reason(fake((2049, 1024, 1024, 12))) is None
    assert kt.staged_meta(1024) == 1024 and kt.staged_meta(1025) == 0
    bank = bank_scene(rtt)
    trace_cfg, march_cfg = rtt.RenderConfig(), rtt.RenderConfig(use_raymarching=True)
    for mod, c in ((kt, trace_cfg), (kb, trace_cfg), (km, march_cfg), (kmb, march_cfg)):
        assert mod.unsupported_reason(bank, c) is None, mod.__name__
    for name, shared in (("trace_fwd", kt.SHARED_TABLE_MAX), ("trace_bwd", kb.SHARED_TABLE_MAX),
                         ("march_bwd", kb.SHARED_TABLE_MAX)):
        assert kt.library(name, 5, shared, 1024) == name
        assert kt.library(name, 5, shared, 1025) == name + "_global"
    assert km.library_name(bank, march_cfg) == "march_fwd_global"
    huge = fake((2, 2**15, 2**15, 12))  # 2^31 texels: indexed in 64 bits
    for mod, c in ((kt, trace_cfg), (kb, trace_cfg), (km, march_cfg), (kmb, march_cfg)):
        assert mod.unsupported_reason(huge, c) is None, mod.__name__


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_deep_march_kernels():
    """On the card: K3's deep instance forced at cap 10 bit-equal to
    march_fwd, and at cap 12 (its wrapper's launch) bit-equal to the plain
    march with the tail off on the box and the default scene; K4's buffer
    instance at cap 12 on the box against autograd within 0.02, its image
    K3's; the bank of 1 101 textures through K1 and K3 (tail off) bit for
    bit against the plain versions, and through K2 and K4 against autograd
    within 0.01 and 0.02."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_rust_tpu_torch.ops import kernel_pack as kp

    default = rtt.default_scene()[0]
    cfg10 = rtt.RenderConfig(xres=160, yres=120, use_raymarching=True, glow_effect=1.0,
                             max_refractions=10, refraction_unroll=None)
    words = kp.launch_pack(default)
    ptrs, meta = kp.word_pointers(words, default.objects.count)
    lib = _build.load_cuda_library("march_fwd_deep")
    forced = kt.launch(lib, lib.rt_march_fwd, ptrs, default.objects.count, words.device, cfg10,
                       km.kernel_args(cfg10) + kp.texture_pointers(default, meta))
    np.testing.assert_array_equal(_img(forced), _img(km.render_color_kernel(default, cfg10)))
    for scene in (glass_box(rtt).to(torch.device("cuda")), default):
        cfg = rtt.RenderConfig(xres=64, yres=48, march_max_iter=2000, **_DEEP)
        before = km.DEEP_LAUNCHES
        got = _img(km.render_color_kernel(scene, cfg))
        assert km.DEEP_LAUNCHES - before == 1
        np.testing.assert_array_equal(got, _img(km.render_color_plain(scene, cfg)))
    box = glass_box(rtt).to(torch.device("cuda"))
    g = Color(*(torch.ones(cfg.yres, cfg.xres, device="cuda") for _ in range(3)))
    before = kmb.BUF_LAUNCHES
    grads, prim = kmb.render_grads_kernel(box, cfg, g, return_primal=True)
    assert kmb.BUF_LAUNCHES - before == 1
    np.testing.assert_array_equal(_img(prim), _img(km.render_color_kernel(box, cfg)))
    assert_leaf_grads_close(box, grads, kmb.render_grads_plain(box, cfg, g), 0.02)

    bank = bank_scene(rtt).to(torch.device("cuda"))
    for mod, fwd, c, budget in (
            (kb, kt, rtt.RenderConfig(xres=64, yres=48), 0.01),
            (kmb, km, rtt.RenderConfig(xres=64, yres=48, use_raymarching=True, glow_effect=1.0,
                                       march_max_iter=2000, march_floor_skip=False), 0.02)):
        np.testing.assert_array_equal(_img(fwd.render_color_kernel(bank, c)),
                                      _img(fwd.render_color_plain(bank, c)))
        g = Color(*(torch.ones(c.yres, c.xres, device="cuda") for _ in range(3)))
        assert_leaf_grads_close(bank, mod.render_grads_kernel(bank, c, g),
                                mod.render_grads_plain(bank, c, g), budget)
