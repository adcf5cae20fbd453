"""Image textures in the PyTorch port against the JAX package.

- The PNG reader (``utils/image.py:load_png``) against PIL, which the JAX
  package reads textures with, on files written here with each row filter
  at 8 and 16 bits; ``load_texture`` gives None where the JAX one does and
  raises on an interlaced file.
- ``default_scene`` with ``bar.png`` in its texture directory gives the same
  leaves in both packages, the atlas included (the fault of the port's first
  slice, which ignored the file).
- The samplers (``ops/texture.py``): the packed one against the four-gather
  one, the JAX sampler and the scalar oracle, all exact.
- The plain textured trace against the eager JAX trace (the JAX kernel
  test's budget, tests/test_pallas.py:597-616: 8% of pixels, mean 0.03) and
  against the textured goldens (tests/test_parity.py:192-214: 2%, 0.015);
  the plain textured march against the eager JAX march.
- Plain autograd against ``jax.vjp`` per scene leaf (tests/test_pallas_bwd.py:
  29-96: relative L2 0.01, norm floor 1e-2, on pixels whose forwards agree).
- The texture fetch of the trace kernel (K1a, ``csrc/trace_body.cuh``) and
  its adjoint in the backward kernel (``csrc/trace_bwd_body.cuh``), built
  for the host with g++, against the plain sampler (bit for bit) and its
  autograd. The whole host-built bodies run on textured scenes in
  tests/test_torch_kernel_trace.py and tests/test_torch_kernel_bwd.py.

JAX runs eagerly, op by op, and its gradients are module fixtures. The card
tests run with ``python -m pytest --noconftest -m cuda
tests/test_torch_texture.py``.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import cli
from ray_rust_tpu_torch.models.material import build_material_table, load_texture
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops.texture import sample_texture, sample_texture_packed
from ray_rust_tpu_torch.utils.image import load_png, save_png

from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    one_torch_thread, textured_scene, two_texture_scene)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_BUDGET = dict(frac_budget=0.02, mean_tol=0.015)  # tests/test_parity.py:192-214
KERNEL_BUDGET = dict(frac_budget=0.08, mean_tol=0.03)  # tests/test_pallas.py:597-616


def _compare(ref, got, frac_budget, mean_tol, tol=1e-3):
    diff = np.abs(got - ref)
    bad_frac = (diff.max(-1) > tol).mean()
    print(f"{bad_frac:.3%} of pixels differ > {tol}, mean {diff.mean():.3g}")
    assert np.isfinite(got).all()
    assert bad_frac <= frac_budget, f"{bad_frac:.2%} pixels > {tol} (budget {frac_budget:.0%})"
    assert diff.mean() <= mean_tol, f"mean diff {diff.mean():.4f} > {mean_tol}"


def _img(col):
    return np.stack([c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                     else np.asarray(c) for c in col], -1)


def _port(jax_scene):
    return rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")


def _jax_cfg(cfg, **extra):
    import dataclasses

    import ray_rust_tpu as rt

    return rt.RenderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                           **extra)


def _jax_trace(scene, jcfg):
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, jcfg)
    return _img(trace_image(scene, jcfg, vi, eye))


def fixture_texture():
    """The goldens' 256x256 noise texture (tests/goldens/gen_textured.py)."""
    return np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8)


# -- the PNG reader ----------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(img, depth=8, filters=(0,), interlace=False, ctype=2):
    """PNG bytes of ``img`` ((H, W, C) uint8 or uint16 samples), each row
    written with ``filters[row % len(filters)]``; ``interlace``: Adam7
    passes, rows unfiltered."""
    h, w, c = img.shape
    bpp = c * depth // 8
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = raw.reshape(h, w * bpp).astype(np.int32)

    def filtered(y, kind, rows):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kind]
        return bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()

    if interlace:
        data = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
            sub = img[y0::dy, x0::dx]
            if sub.size:
                rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
                data += b"".join(b"\0" + r.tobytes() for r in rows)
    else:
        data = b"".join(filtered(y, filters[y % len(filters)], raw) for y in range(h))

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


_FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,), "paeth": (4,),
            "mixed": (0, 1, 2, 3, 4)}


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("filt", sorted(_FILTERS))
def test_load_png_matches_pil(tmp_path, filt, depth):
    from PIL import Image

    rng = np.random.default_rng(depth)
    img = rng.integers(0, 2 ** depth, (11, 17, 3)).astype(np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "t.png"
    path.write_bytes(_png(img, depth, _FILTERS[filt]))
    want = Image.open(path)
    assert want.mode == "RGB"
    got = load_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (11, 17, 3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(load_texture(str(path)), got)


def _write_pil(path, mode):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (6, 9, 3)).astype(np.uint8)
    im = Image.fromarray(rgb, "RGB")
    (im.convert("P") if mode == "P" else im.convert(mode)).save(path)


@pytest.mark.parametrize("case", ["RGBA", "L", "LA", "P", "missing", "no image"])
def test_load_texture_none_where_jax_gives_none(tmp_path, case):
    from ray_rust_tpu.models.material import load_texture as jax_load_texture

    path = tmp_path / "bar.png"
    if case == "no image":
        path.write_bytes(b"this is not an image file\n" * 4)
    elif case != "missing":
        _write_pil(path, case)
    assert jax_load_texture(str(path)) is None
    assert load_texture(str(path)) is None


def test_interlaced_png_raises(tmp_path):
    """PIL (so the JAX package) textures with an Adam7 file; the port does
    not decode it, and must not quietly leave the floor untextured."""
    from PIL import Image

    from ray_rust_tpu.models.material import load_texture as jax_load_texture

    img = np.random.default_rng(1).integers(0, 256, (13, 10, 3)).astype(np.uint8)
    path = tmp_path / "bar.png"
    path.write_bytes(_png(img, interlace=True))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    assert jax_load_texture(str(path)) is not None
    with pytest.raises(ValueError, match="bar.png.*interlaced"):
        load_texture(str(path))
    with pytest.raises(ValueError, match="interlaced"):
        rtt.default_scene(texture_dir=str(tmp_path), device="cpu")


# -- the texture file of the default scene (ROADMAP queue 3) ------------------

@pytest.mark.parametrize("case", ["nearest", "bilinear", "no bar.png"])
def test_default_scene_texture_dir_as_jax(tmp_path, case):
    """With ``bar.png`` in the texture directory both packages texture the
    floor with it; without it neither does."""
    import ray_rust_tpu as rt

    filt = int(case == "bilinear")
    if case != "no bar.png":
        save_png(str(tmp_path / "bar.png"), fixture_texture())
    want = rtt.scene_to_numpy(rt.default_scene(texture_dir=str(tmp_path), texture_filter=filt)[0])
    scene, _ = rtt.default_scene(texture_dir=str(tmp_path), texture_filter=filt, device="cpu")
    got = rtt.scene_to_numpy(scene)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    if case == "no bar.png":
        assert scene.textures is None and not any(p.startswith("textures") for p in got)
    else:
        np.testing.assert_array_equal(got["textures.data"][0], fixture_texture())
        assert int(scene.materials.texture_id[0]) == 0


def test_textured_jax_scene_carries_across(tmp_path):
    """uint8 atlas in, uint8 atlas out; integer tables int32, floats f32."""
    import ray_rust_tpu as rt

    jax_scene = two_texture_scene(rt)
    scene = _port(jax_scene)
    assert scene.textures.data.dtype == scene.textures.packed.dtype == torch.uint8
    assert scene.textures.heights.dtype == torch.int32
    back = rtt.scene_to_numpy(scene)
    for path, w in rtt.scene_to_numpy(jax_scene).items():
        assert back[path].dtype == w.dtype, path
        np.testing.assert_array_equal(back[path], w, err_msg=path)
    assert back["textures.packed"].shape == (2, 200, 128, 12)


def test_pack_textures_equals_jax_words():
    """The kernel atlas holds the JAX kernel's packed words
    (pallas_trace.py:_pack_textures) without its 128-lane chunking."""
    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.pallas_trace import _pack_textures

    jax_scene = two_texture_scene(rt)
    tbl, meta = (np.asarray(a) for a in _pack_textures(jax_scene))
    atlas, got_meta = (a.numpy() for a in kt.pack_textures(_port(jax_scene)))
    t, hmax, wmax, _ = atlas.shape
    per_tex = -(-(hmax * wmax) // 128) * 128
    words = tbl.reshape(4, -1)[:, :t * per_tex].reshape(4, t, per_tex)[:, :, :hmax * wmax]
    np.testing.assert_array_equal(atlas.reshape(t, hmax * wmax, 4),
                                  words.transpose(1, 2, 0).astype(np.int32))
    np.testing.assert_array_equal(got_meta[:, [0, 1, 3]], meta[:, [0, 1, 3]])
    np.testing.assert_array_equal(got_meta[:, 2], np.arange(t) * hmax * wmax)
    assert kt.pack_textures(rtt.default_scene(texture_dir="/nonexistent", device="cpu")[0]) is None


# -- the samplers -------------------------------------------------------------

_UVS = [(0.0, 0.0), (0.3, 0.7), (0.999, 0.001), (1.5, 2.25), (-0.3, -1.7),
        (-5.25, 3.8), (0.5, -0.5), (12.34, -56.78)]  # tests/test_texture.py:45-48


@pytest.fixture(scope="module")
def small_banks():
    """tests/test_texture.py:29-41's two textures, as both packages stack
    them, and the textures."""
    from ray_rust_tpu.models.material import MaterialSpec as JaxSpec
    from ray_rust_tpu.models.material import build_material_table as jax_build

    rng = np.random.default_rng(42)
    texs = [rng.integers(0, 256, (3, 5, 3), np.uint8), rng.integers(0, 256, (7, 4, 3), np.uint8)]
    _, jax_bank = jax_build([JaxSpec(name=f"m{i}", texture=t) for i, t in enumerate(texs)])
    _, bank = build_material_table([rtt.MaterialSpec(name=f"m{i}", texture=t)
                                    for i, t in enumerate(texs)])
    return bank, jax_bank, texs


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
@pytest.mark.parametrize("tex_id", [0, 1])
def test_sample_texture_matches_jax_and_oracle(small_banks, filt, tex_id):
    """Twin of tests/test_texture.py:51-66, and the JAX sampler bit for bit."""
    import jax.numpy as jnp

    from ray_rust_tpu.ops.texture import _sample_texture

    from .oracle import OMat, lookup_texture

    bank, jax_bank, texs = small_banks
    u = np.float32([a for a, _ in _UVS])
    v = np.float32([b for _, b in _UVS])
    tid = np.full(u.shape, tex_id, np.int32)
    fid = np.full(u.shape, filt, np.int32)
    t = [torch.from_numpy(a) for a in (tid, fid, u, v)]
    got = _img(sample_texture(bank, *t))
    np.testing.assert_array_equal(_img(sample_texture_packed(bank, *t)), got)
    np.testing.assert_array_equal(
        _img(_sample_texture(jax_bank, *(jnp.asarray(a) for a in (tid, fid, u, v)))), got)
    mat = OMat(diffuse=(1, 1, 1), specular=(0, 0, 0), pn=0, t=0.0, n=0.0, texture=texs[tex_id],
               texture_filter=["nearest", "bilinear"][filt])
    want = np.stack([lookup_texture(mat, np.float32(a), np.float32(b)) for a, b in _UVS])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sample_texture_packed_matches_gather():
    """Twin of tests/test_pallas.py:622-645: one gather of the packed atlas
    equals the four-gather sampler exactly, both filters mixed per hit."""
    rng = np.random.default_rng(11)
    _, bank = build_material_table([
        rtt.MaterialSpec(name="a", texture=rng.integers(0, 256, (7, 13, 3)).astype(np.uint8)),
        rtt.MaterialSpec(name="b", texture=rng.integers(0, 256, (16, 8, 3)).astype(np.uint8))])
    n = 4096
    u = torch.from_numpy(rng.uniform(-3.0, 3.0, n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3.0, 3.0, n).astype(np.float32))
    tid = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    for filt in (torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32),
                 torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))):
        np.testing.assert_array_equal(_img(sample_texture_packed(bank, tid, filt, u, v)),
                                      _img(sample_texture(bank, tid, filt, u, v)))


# -- the plain textured render against JAX and the goldens --------------------

@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_plain_textured_trace_matches_jax(filt):
    """tests/test_pallas.py:597-616's scene and config at 64x48: the floor
    seen directly, in the mirror and through the glass."""
    import ray_rust_tpu as rt

    jax_scene = textured_scene(rt, filt)
    cfg = rtt.RenderConfig(xres=64, yres=48, max_reflections=2, refraction_unroll=2)
    ref = _jax_trace(jax_scene, _jax_cfg(cfg))
    got = _img(rtt.render_color(_port(jax_scene), cfg))
    _compare(ref, got, **KERNEL_BUDGET)


def test_plain_two_textures_match_jax():
    """tests/test_pallas.py:679-722's two textures, two filters, at 160x32."""
    import ray_rust_tpu as rt

    jax_scene = two_texture_scene(rt)
    cfg = rtt.RenderConfig(xres=160, yres=32, max_reflections=1, refraction_unroll=0)
    ref = _jax_trace(jax_scene, _jax_cfg(cfg))
    got = _img(rtt.render_color(_port(jax_scene), cfg))
    _compare(ref, got, **KERNEL_BUDGET)


@pytest.mark.parametrize("name,filt", [("default_textured_nearest_320x240", 0),
                                       ("default_textured_bilinear_160x120", 1)])
def test_plain_textured_trace_matches_golden(tmp_path, name, filt):
    """The textured goldens at full depth (tests/test_parity.py:192-214),
    with the fixture texture written as ``bar.png``."""
    save_png(str(tmp_path / "bar.png"), fixture_texture())
    scene, _ = rtt.default_scene(texture_dir=str(tmp_path), texture_filter=filt, device="cpu")
    ref = np.load(os.path.join(_REPO, "tests", "goldens", f"{name}.npz"))["img"]
    h, w = ref.shape[:2]
    got = _img(rtt.render_color(scene, rtt.RenderConfig(xres=w, yres=h, refraction_unroll=None)))
    _compare(ref, got, **GOLDEN_BUDGET)


def test_plain_textured_march_matches_jax():
    """The plain march reads textures through the same ``lookup_diffuse``;
    against the eager JAX march (``march_chunk=1``) at 16x12 with glow. A
    2000-step budget (both sides) keeps the eager JAX march cheap."""
    import ray_rust_tpu as rt

    jax_scene = textured_scene(rt, 1)
    cfg = rtt.RenderConfig(xres=16, yres=12, use_raymarching=True, glow_effect=1.0,
                           march_max_iter=2000)
    ref = _jax_trace(jax_scene, _jax_cfg(cfg, march_tiles=1, march_chunk=1))
    got = _img(rtt.render_color(_port(jax_scene), cfg))
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


def test_cli_textures_the_floor_with_bar_png(tmp_path, monkeypatch):
    """The CLI loads ``bar.png`` from the working directory, as the JAX CLI
    does (ray_rust_tpu/cli.py:74)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["32", "24", "-o", "plain.png", "--device", "cpu"]) == 0
    save_png("bar.png", fixture_texture())
    assert cli.main(["32", "24", "-o", "textured.png", "--device", "cpu"]) == 0
    cfg = rtt.RenderConfig(xres=32, yres=24, xfov=1.0, yfov=24 / 32)
    want = rtt.render_u8(rtt.default_scene(texture_dir=".", device="cpu")[0], cfg)
    textured = load_png("textured.png")
    np.testing.assert_array_equal(textured, want)
    floor = slice(16, 24)  # the rows below the horizon
    assert not np.array_equal(textured[floor], load_png("plain.png")[floor])


# -- gradients ----------------------------------------------------------------

_GRAD_CFG = dict(xres=32, yres=16, max_reflections=2, refraction_unroll=1,
                 grad_distance_cutoff=2e3)  # tests/test_pallas_bwd.py:140-149


@pytest.fixture(scope="module")
def jax_textured_vjp():
    """tests/test_pallas_bwd.py:116-149's scene and config: its eager jnp
    image and vjp."""
    import jax

    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.rays import camera_rays
    from ray_rust_tpu.ops.trace import trace_image

    scene = textured_scene(rt, 1, camera=(0.37, -150.3, -300.0))
    cfg = _jax_cfg(rtt.RenderConfig(**_GRAD_CFG))

    def fwd(s):
        vi, eye = camera_rays(s.camera.position, s.camera.rotation, cfg)
        return trace_image(s, cfg, vi, eye)

    img, vjp = jax.vjp(fwd, scene)
    return scene, _img(img), vjp


def test_plain_textured_gradient_matches_jax_vjp(jax_textured_vjp):
    import jax.numpy as jnp

    from ray_rust_tpu.models.vec import Color as JaxColor

    from .test_torch_kernel_bwd import assert_boundary_only

    jax_scene, jax_img, vjp = jax_textured_vjp
    scene = _port(jax_scene)
    paths = list(rtt.scene_to_numpy(scene))
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    params = {p: t for p, t in zip(paths, leaves) if t.requires_grad}
    img = rtt.render_color(scene.with_tensors(leaves), rtt.RenderConfig(**_GRAD_CFG))
    agree = np.abs(_img(img) - jax_img).max(-1) < 1e-4
    print(f"forwards agree on {agree.mean():.2%} of pixels")
    assert agree.mean() >= 0.88
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
        b = np.asarray(want[path], np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2)
        assert rel <= 0.01, f"{path}: relative L2 {rel:.2e} (norm {np.linalg.norm(b):.3g})"
    # the texture moves the image: the floor's uv reaches its position
    assert np.linalg.norm(want["objects.org.z"]) > 0


# -- the kernels' texture fetch, built for the host ---------------------------

def _fetch_cases(bank, n=2048, seed=3):
    """Texture ids and uv: moderate, negative, on texel edges, and so large
    that u*w leaves int32 (the horizon's far floor)."""
    rng = np.random.default_rng(seed)
    t = bank.data.shape[0]
    u = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    v = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    u[:64] = np.round(u[:64] * 8) / 8  # whole and half texels
    u[64:96] = rng.uniform(-1e12, 1e12, 32)
    v[96:128] = np.float32([3e9, -3e9, 1e30, -1e30] * 8)
    tid = rng.integers(0, t, n).astype(np.int32)
    return tid, u, v


def _bank_and_filters():
    rng = np.random.default_rng(9)
    specs = [rtt.MaterialSpec(name="a", texture=rng.integers(0, 256, (7, 13, 3)).astype(np.uint8),
                              texture_filter=0),
             rtt.MaterialSpec(name="b", texture=rng.integers(0, 256, (16, 8, 3)).astype(np.uint8),
                              texture_filter=1),
             rtt.MaterialSpec(name="c", texture=rng.integers(0, 256, (5, 5, 3)).astype(np.uint8),
                              texture_filter=1)]
    table, bank = build_material_table(specs)
    scene = rtt.default_scene(device="cpu")[0]._replace(materials=table, textures=bank)
    return scene, bank


def _ptr(a):
    return a.ctypes.data_as(_build.ctypes.c_void_p)


def test_host_texture_fetch_equals_plain_sampler(tmp_path):
    """K1a's fetch (``fetch_texture``) bit for bit against the plain sampler,
    Nearest and Bilinear, with the meta filters of pack_textures."""
    lib = _build.build_host_library(tmp_path, "trace")
    scene, bank = _bank_and_filters()
    tex = kt.pack_textures(scene)
    tid, u, v = _fetch_cases(bank)
    rgb = np.zeros((tid.size, 3), np.float32)
    p, i = _build.ctypes.c_void_p, _build.ctypes.c_int
    lib.rt_fetch_texture_host.argtypes = [i, p, p, p, p, p, i, i, i, p]
    lib.rt_fetch_texture_host.restype = None
    lib.rt_fetch_texture_host(tid.size, _ptr(tid), _ptr(u), _ptr(v),
                              *kt.texture_args(tex, torch.device("cpu")), _ptr(rgb))
    filt = scene.materials.texture_filter[torch.from_numpy(tid).long()]
    want = _img(sample_texture_packed(bank, torch.from_numpy(tid), filt, torch.from_numpy(u),
                                      torch.from_numpy(v)))
    assert (filt == 1).any() and (filt == 0).any()
    np.testing.assert_array_equal(rgb, want)


def test_host_texture_fetch_adjoint_matches_autograd(tmp_path):
    """K2's textured site adjoint (``fetch_texture_adj``): the cotangent of
    (u, v) against autograd of the plain sampler."""
    lib = _build.build_host_library(tmp_path, "trace_bwd")
    scene, bank = _bank_and_filters()
    tex = kt.pack_textures(scene)
    tid, u, v = _fetch_cases(bank, seed=4)
    u, v = u[128:], v[128:]  # finite slopes only
    tid = np.ascontiguousarray(tid[128:])
    g = np.random.default_rng(5).standard_normal((tid.size, 3)).astype(np.float32)
    gu, gv = np.zeros(tid.size, np.float32), np.zeros(tid.size, np.float32)
    p, i = _build.ctypes.c_void_p, _build.ctypes.c_int
    lib.rt_fetch_texture_adj.argtypes = [i, p, p, p, p, p, p, i, i, i, p, p]
    lib.rt_fetch_texture_adj.restype = None
    lib.rt_fetch_texture_adj(tid.size, _ptr(tid), _ptr(u), _ptr(v), _ptr(g),
                             *kt.texture_args(tex, torch.device("cpu")), _ptr(gu), _ptr(gv))
    ut, vt = torch.from_numpy(u).requires_grad_(), torch.from_numpy(v).requires_grad_()
    filt = scene.materials.texture_filter[torch.from_numpy(tid).long()]
    col = sample_texture_packed(bank, torch.from_numpy(tid), filt, ut, vt)
    want = torch.autograd.grad(tuple(col), (ut, vt), tuple(torch.from_numpy(g.T.copy())))
    np.testing.assert_allclose(gu, want[0].numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(gv, want[1].numpy(), rtol=1e-5, atol=1e-3)
    assert not gu[(filt == 0).numpy()].any()  # Nearest: no slope
    assert np.abs(gu).max() > 1.0


# -- the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_cuda_textured_kernel_matches_plain(tmp_path, filt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    save_png(str(tmp_path / "bar.png"), fixture_texture())
    scene, _ = rtt.default_scene(texture_dir=str(tmp_path), texture_filter=filt)
    cfg = rtt.RenderConfig(xres=320, yres=240)
    before = kt.LAUNCHES
    got = _img(rtt.render_color(scene, cfg))
    torch.cuda.synchronize()
    assert kt.LAUNCHES == before + 1
    np.testing.assert_array_equal(got, _img(kt.render_color_plain(scene, cfg)))


@pytest.mark.cuda
def test_cuda_textured_gradient_goes_through_k2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = textured_scene(rtt, 1, camera=(0.37, -150.3, -300.0)).to("cuda")
    cfg = rtt.RenderConfig(**_GRAD_CFG)
    rng = np.random.default_rng(6)
    g = rtt.Color(*(torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).cuda()
                    for _ in range(3)))
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    params = [t for t in leaves if t.requires_grad]
    before = (kt.LAUNCHES, kb.LAUNCHES)
    img = rtt.render_color(scene.with_tensors(leaves), cfg)
    got = torch.autograd.grad(tuple(img), params, tuple(g), allow_unused=True)
    torch.cuda.synchronize()
    assert (kt.LAUNCHES, kb.LAUNCHES) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(_img(img), _img(kt.render_color_plain(scene, cfg)))
    want = kb.leaf_grads(scene, kb.render_grads_plain(scene, cfg, g))
    for (path, w), gr in zip(want.items(), got):
        a = np.zeros(w.shape, np.float32) if gr is None else gr.cpu().numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" not in path:
            b = w.cpu().numpy()
            assert np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2) <= 0.01, path
