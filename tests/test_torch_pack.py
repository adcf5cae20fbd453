"""The scene pack and its pull-back (ops/kernel_pack.py) against the plain
pack, autograd of it and the JAX package's ``_pack_scene`` and its VJP.

On the CPU: the kernels' per-entry bodies (``csrc/pack_body.cuh``) built
for the host with g++, held bit for bit against ``kernel_trace.pack_scene``
(and the texture meta rows of ``pack_textures``) and against the JAX
package's ``_pack_scene`` on the same numpy leaves; the pull-back body
against autograd of ``pack_scene`` and against ``jax.vjp(pack_f32, scene)``
as ``ray_rust_tpu/ops/pallas_trace.py:1656-1661`` takes it; the atlas cache;
the leaf checks; the CPU route, which takes the plain pack. Three scenes:
the default scene, the default scene with the goldens' noise as ``bar.png``
where a Nearest and a Bilinear material share one texture, and a floor
with 100 spheres over four shared materials.

Tolerance: the pack copies leaves, so it is bit-equal. The pull-back is
bit-equal where a material has one object; where objects share one it sums
their column in object index order, and autograd and JAX may sum in
another, so those entries are held within relative L2 1e-6.

The kernels themselves run only on a card (the ``cuda`` tests, which decide
inside the test whether there is one): ``python -m pytest --noconftest -m
cuda tests/test_torch_pack.py``.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.material import TextureBank
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_pack as kp
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.parallel import sgd_train_step
from ray_rust_tpu_torch.utils.image import save_png

from .test_torch_kernel_trace import _many_spheres, _on_cpu, one_torch_thread  # noqa: F401

CASES = ["default", "bar_png_shared_texture", "101_objects"]


def _case_scene(pkg, name, tex_dir):
    """The case's scene, built by ``pkg`` (either package)."""
    if name == "default":
        return pkg.default_scene(**_on_cpu(pkg))[0]
    if name == "101_objects":
        return _many_spheres(pkg, 100)
    bar = importlib.import_module(pkg.__name__ + ".models.material").load_texture(
        os.path.join(tex_dir, "bar.png"))
    mats = [pkg.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0), pattern=2,
                             pattern_scale=300.0, pattern_angle_scale=0.2, texture=bar),
            pkg.MaterialSpec(name="ball", diffuse=(0.5, 0.5, 0.5), pattern_scale=80.0,
                             texture_filter=1, texture=bar),
            pkg.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24)]
    objs = [pkg.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            pkg.SphereSpec("ball", 120.0, (30.0, -160.0, 180.0)),
            pkg.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0))]
    scene, _ = pkg.build_scene(mats, objs, (0.3, -150.0, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0),
                               **_on_cpu(pkg))
    # the Bilinear ball takes the floor's texture: texture 0 has a Nearest
    # and a Bilinear owner, texture 1 none
    m = scene.materials
    tid = m.texture_id.at[1].set(0) if pkg is not rtt else m.texture_id.clone().index_fill_(
        0, torch.tensor([1]), 0)
    return scene._replace(materials=m._replace(texture_id=tid))


@pytest.fixture(scope="module")
def tex_dir(tmp_path_factory):
    """A folder holding the goldens' noise texture as ``bar.png``."""
    d = tmp_path_factory.mktemp("bar")
    save_png(str(d / "bar.png"),
             np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def scenes(tex_dir):
    """Each case's scene on the CPU."""
    return {name: _case_scene(rtt, name, tex_dir) for name in CASES}


def _block(k, scene):
    """A seeded cotangent block of the backward kernels' shape."""
    n = scene.objects.count
    return torch.from_numpy(np.random.default_rng(k).standard_normal(
        (n + 1, kb.GRAD_COLS)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(scenes, tex_dir):
    """Each case's ``_pack_scene`` tables and ``jax.vjp(pack_f32, scene)``
    of :func:`_block`, the JAX scene built from the same specs and held
    leaf for leaf against the port's: (tables, {leaf path: cotangent})."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.pallas_trace import _pack_scene

    out = {}
    for k, name in enumerate(CASES):
        js = _case_scene(rt, name, tex_dir)
        for path, a in rtt.scene_to_numpy(js).items():
            np.testing.assert_array_equal(rtt.scene_to_numpy(scenes[name])[path], a)
        tables = [np.asarray(a) for a in _pack_scene(js)]
        n = tables[0].shape[0]
        block = _block(k, scenes[name]).numpy()

        def pack_f32(s):
            ft, _, c, lt = _pack_scene(s)
            return ft, c, lt

        _, vjp = jax.vjp(pack_f32, js)
        pad = jnp.zeros(1, jnp.float32)
        (ct,) = vjp((jnp.asarray(block[:n, :kp.F32_COLS]),
                     jnp.concatenate([jnp.asarray(block[n, 0:7]), pad]).reshape(1, 8),
                     jnp.concatenate([jnp.asarray(block[n, 7:10]), pad]).reshape(1, 4)))
        out[name] = (tables, rtt.scene_to_numpy(ct))
    return out


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.build_host_library(tmp_path_factory.mktemp("pack_host"), "pack_scene")


def _host_pack(lib, scene):
    """The pack body's host build on a CPU scene: (tables, meta)."""
    n, m, n_tex, texels = kp.sizes(scene)
    out = torch.empty(kp.pack_words(n, n_tex), dtype=torch.int32)
    ptrs = kp.leaf_pointers(scene)
    lib.rt_pack_scene_host(ptrs.buffer_info()[0], n, m, n_tex, texels, out.data_ptr(), None)
    return kp.split_words(out, n, n_tex)


def _host_vjp(lib, scene, block):
    """The pull-back body's host build: the cotangents of the float leaves."""
    n, m = scene.objects.count, scene.materials.pn.shape[0]
    out = torch.empty(sum(t.numel() for t in kp.float_leaves(scene)), dtype=torch.float32)
    assert lib.rt_pack_scene_vjp(block.data_ptr(), scene.objects.mat.data_ptr(), n, m,
                                 out.data_ptr(), 0, None) == 0
    return kp.split_vjp(kp.float_leaves(scene), out)


def _float_paths(scene):
    return [p for p, t in zip(rtt.scene_to_numpy(scene), scene.tensors())
            if t.is_floating_point()]


def _shared_materials(scene):
    """The material rows two or more objects share."""
    counts = np.bincount(scene.objects.mat.cpu().numpy(),
                         minlength=scene.materials.pn.shape[0])
    return counts > 1


def _hold_vjp(scene, got, want):
    """Hold pull-back cotangents ``got`` against ``want`` (numpy or tensors
    by float leaf): bit-equal, but relative L2 1e-6 on the rows of shared
    materials."""
    shared = _shared_materials(scene)
    assert len(got) == len(want) == len(_float_paths(scene))
    for path, g, w in zip(_float_paths(scene), got, want):
        g, w = (np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)
                for a in (g, w))
        assert g.shape == w.shape, path
        if path.startswith("materials.") and shared.any():
            np.testing.assert_array_equal(g[~shared], w[~shared], err_msg=path)
            rel = np.linalg.norm(g[shared] - w[shared]) / max(np.linalg.norm(w[shared]), 1e-30)
            assert rel <= 1e-6, (path, rel)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("case", CASES)
def test_host_pack_equals_pack_scene_and_jax(host_lib, scenes, jax_ref, case):
    scene = scenes[case]
    tables, meta = _host_pack(host_lib, scene)
    for got, plain, jax_t in zip(tables, kt.pack_scene(scene), jax_ref[case][0]):
        assert got.dtype == plain.dtype and got.shape == plain.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      plain.detach().numpy().view(np.uint32))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), jax_t.view(np.uint32))
    tex = kt.pack_textures(scene)
    assert (meta is None) == (tex is None)
    if tex is not None:
        np.testing.assert_array_equal(meta.numpy(), tex[1].numpy())
    if case == "bar_png_shared_texture":  # Bilinear wins the shared texture
        assert meta[:, 3].tolist() == [1, 0]


@pytest.mark.parametrize("case", CASES)
def test_host_vjp_equals_autograd_and_jax(host_lib, scenes, jax_ref, case):
    scene = scenes[case]
    jax_ct = jax_ref[case][1]
    block = _block(CASES.index(case), scene)
    got = _host_vjp(host_lib, scene, block)
    _hold_vjp(scene, got, kp.pack_scene_vjp(scene, block))  # autograd of pack_scene
    _hold_vjp(scene, got, [jax_ct[p] for p in _float_paths(scene)])
    # the leaves the tables do not read get zeros, as under jax.vjp
    for path, g in zip(_float_paths(scene), got):
        if path.startswith("materials.frac") or path.startswith("camera.pyr"):
            assert not g.any(), path


def test_leaf_grads_on_cpu_is_autograd_of_pack_scene(scenes):
    """leaf_grads (the oracle paths' pull-back) on a CPU scene: autograd of
    the plain pack, zeros for the leaves the tables do not read."""
    scene = scenes["default"]
    block = _block(0, scene)
    got = kb.leaf_grads(scene, kb.split_block(block, scene.objects.count))
    assert list(got) == _float_paths(scene)
    for path, want in zip(got, kp.pack_scene_vjp(scene, block)):
        assert torch.equal(got[path], want), path


def test_cpu_route_takes_the_plain_pack(scenes):
    kp.LAUNCHES = kp.VJP_LAUNCHES = 0
    scene = scenes["bar_png_shared_texture"]
    tables, meta = kp.pack_tables(scene)
    for got, want in zip(tables, kt.pack_scene(scene)):
        assert torch.equal(got, want)
    assert torch.equal(meta, kt.pack_textures(scene)[1])
    block = torch.ones((scene.objects.count + 1, kb.GRAD_COLS))
    assert kp.pack_scene_vjp(scene, block)[0].shape == scene.objects.org.x.shape
    rtt.render_color(scene, rtt.RenderConfig(xres=8, yres=6))
    assert kp.LAUNCHES == 0 and kp.VJP_LAUNCHES == 0


def test_atlas_is_built_once_per_bank(scenes):
    bank = scenes["bar_png_shared_texture"].textures
    first = kp.texture_atlas(bank.packed)
    assert kp.texture_atlas(bank.packed) is first
    torch.testing.assert_close(first, kp.atlas_words(bank.packed), rtol=0, atol=0)
    other = TextureBank(bank.data, bank.heights, bank.widths, bank.packed.clone())
    second = kp.texture_atlas(other.packed)
    assert second is not first and torch.equal(second, first)
    packed = other.packed
    packed[0, 0, 0, 0] = (int(packed[0, 0, 0, 0]) + 1) % 256  # in place: a new version
    third = kp.texture_atlas(packed)
    assert third is not second and int(third[0, 0, 0, 0]) != int(second[0, 0, 0, 0])
    assert kp.texture_atlas(bank.packed) is first


def test_changed_texture_filter_changes_the_meta(host_lib, scenes):
    scene = scenes["default"]
    tex = scenes["bar_png_shared_texture"].textures
    mats = scene.materials
    textured = scene._replace(textures=tex, materials=mats._replace(
        texture_id=torch.tensor([0, -1, -1, -1], dtype=torch.int32)))
    assert _host_pack(host_lib, textured)[1][0, 3] == 0  # the floor: Nearest
    bilinear = textured._replace(materials=textured.materials._replace(
        texture_filter=torch.tensor([1, 0, 0, 0], dtype=torch.int32)))
    meta = _host_pack(host_lib, bilinear)[1]
    assert meta[0, 3] == 1 and torch.equal(meta, kt.pack_textures(bilinear)[1])


@pytest.mark.parametrize("change", ["float64", "strided", "int64"])
def test_leaf_the_pack_does_not_take_raises(scenes, change):
    scene = scenes["101_objects"]
    o, m = scene.objects, scene.materials
    if change == "float64":
        scene = scene._replace(objects=o._replace(radius=o.radius.double()))
    elif change == "strided":
        wide = torch.stack([o.org.x, o.org.x], 1)
        scene = scene._replace(objects=o._replace(org=o.org._replace(x=wide[:, 0])))
    else:
        scene = scene._replace(materials=m._replace(pattern=m.pattern.long()))
    with pytest.raises(ValueError, match="the pack kernel takes leaf"):
        kp.leaf_pointers(scene)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_pack_and_pull_back(scenes, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = scenes[case].to("cuda")
    kp.LAUNCHES = kp.VJP_LAUNCHES = 0
    tables, meta = kp.pack_tables(scene)
    for got, want in zip(tables, kt.pack_scene(scene)):
        assert torch.equal(got.view(torch.int32), want.detach().view(torch.int32))
    if meta is not None:
        assert torch.equal(meta, kt.pack_textures(scene)[1])
    block = _block(CASES.index(case), scene).cuda()
    got = kp.pack_scene_vjp(scene, block)
    _hold_vjp(scene, got, kp.pack_scene_vjp_plain(scene, kp.split_block(block,
                                                                         scene.objects.count)))
    assert kp.LAUNCHES == 1 and kp.VJP_LAUNCHES == 1


@pytest.mark.cuda
def test_cuda_training_step_packs_once_and_pulls_back_once(monkeypatch):
    """One 1080p training step: one pack launch, one pull-back launch, the
    K1 and K2 launches, and no call of the plain pack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def plain_pack(scene):
        raise AssertionError("the plain pack ran on a CUDA scene")

    for mod in (kt, kp, kb):
        monkeypatch.setattr(mod, "pack_scene", plain_pack)
    scene = rtt.default_scene(device="cuda")[0]
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    cfg = rtt.RenderConfig(xres=1920, yres=1080)
    target = torch.zeros((cfg.yres, cfg.xres, 3), device="cuda")
    kp.LAUNCHES = kp.VJP_LAUNCHES = kt.LAUNCHES = kb.LAUNCHES = 0
    _, loss = sgd_train_step(scene.with_tensors(leaves), cfg, target)
    torch.cuda.synchronize()
    assert (kp.LAUNCHES, kp.VJP_LAUNCHES, kt.LAUNCHES, kb.LAUNCHES) == (1, 1, 1, 1)
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_cuda_strided_leaf_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    o = scene.objects
    wide = torch.stack([o.radius, o.radius], 1)
    bad = scene._replace(objects=o._replace(radius=wide[:, 0]))
    with pytest.raises(ValueError, match="the pack kernel takes leaf"):
        kt.render_color_kernel(bad, rtt.RenderConfig(xres=32, yres=16))
