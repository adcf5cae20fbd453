"""Scene files in the PyTorch port (``models/serialize.py``) against the JAX
package.

Twins of tests/test_serialize.py (all five) on ``device="cpu"``, and the
holds across the packages: each package reads the other's file to the same
leaves (``scene_to_numpy``), both write the same text, and a file naming a
texture opens the same atlas in both.
"""

import numpy as np
import pytest

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.serialize import (
    DeserializeError,
    deserialize_scene,
    serialize_scene,
)
from ray_rust_tpu_torch.utils.image import save_png

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


def _load(text, **kw):
    return deserialize_scene(text, device="cpu", **kw)


def _assert_same_leaves(a, b):
    a, b = rtt.scene_to_numpy(a), rtt.scene_to_numpy(b)
    assert a.keys() == b.keys()
    for path in a:
        np.testing.assert_array_equal(np.asarray(a[path]), np.asarray(b[path]), err_msg=path)


def _spheres(pkg, n=30, seed=11):
    """A floor and ``n`` seeded spheres over two materials, one glowing."""
    rng = np.random.default_rng(seed)
    mats = [pkg.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3), pn=8,
                             glow_dist=3.0),
            pkg.MaterialSpec(name="m1", diffuse=(0.1, 0.5, 0.9), pattern=1)]
    objs = [pkg.FloorSpec("m0", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0), uvmap=2)]
    for _ in range(n):
        c = rng.uniform(-300, 300, 3)
        objs.append(pkg.SphereSpec(f"m{int(rng.integers(0, 2))}", float(rng.uniform(10, 50)),
                                   tuple(float(v) for v in c), uvmap=3))
    kw = {"device": "cpu"} if pkg is rtt else {}
    return pkg.build_scene(mats, objs, (0.0, 0.0, -400.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), **kw)


def test_roundtrip_exact():
    scene, meta = rtt.default_scene(device="cpu")
    s2, m2, caps = _load(serialize_scene(scene, meta))
    cfg = rtt.RenderConfig(xres=32, yres=24, max_refractions=1)
    np.testing.assert_array_equal(rtt.render_u8(scene, cfg), rtt.render_u8(s2, cfg))
    assert caps == {"max_reflections": 3, "max_refractions": 10}
    _assert_same_leaves(scene, s2)
    assert m2.material_names == meta.material_names and m2.camera_motion == ()


def test_serialize_reference_quirks():
    scene, meta = rtt.default_scene(device="cpu")
    text = serialize_scene(scene, meta)
    # the compile-time constants and an empty motion, whatever the scene (render.rs:741-743)
    assert "max_reflections: 3" in text
    assert "max_refractions: 10" in text
    assert "camera_motion: []" in text
    assert text.startswith("---\n")
    # unit enum variants as plain strings (serde_yaml 0.8)
    assert "pattern: RepeatedGradation" in text
    assert "texture_filter: Nearest" in text


def test_unknown_material_raises():
    bad = """---
camera:
  position: {x: 0.0, y: 0.0, z: 0.0}
  pyr: {x: 0.0, y: 0.0, z: 0.0}
camera_motion: []
max_reflections: 3
max_refractions: 10
materials: {}
objects:
- Sphere:
    material: nope
    r: 10.0
    org: {x: 0.0, y: 0.0, z: 0.0}
    uvmap: XY
"""
    with pytest.raises(DeserializeError, match="couldn't find material nope"):
        _load(bad)


def test_serde_yaml_09_tags_accepted():
    scene, meta = rtt.default_scene(device="cpu")
    text = serialize_scene(scene, meta)
    # "- Sphere:" maps rewritten as 0.9's "- !Sphere" tags
    tagged = text.replace("- Sphere:\n", "- !Sphere\n").replace("- Floor:\n", "- !Floor\n")
    assert "!Sphere" in tagged and "!Floor" in tagged
    s2, _, _ = _load(tagged)
    assert s2.objects.count == scene.objects.count
    _assert_same_leaves(scene, s2)


_MOTION = """camera_motion:
- camera:
    position: {x: 10.0, y: -150.0, z: -300.0}
    pyr: {x: 0.0, y: -1.57, z: -1.57}
  velocity: {x: 1.0, y: 0.0, z: 0.0}
  camera_target: {x: 0.0, y: -30.0, z: 172.0}
  duration: 2.0
"""


def test_camera_motion_roundtrip():
    scene, meta = rtt.default_scene(device="cpu")
    # a keyframe spliced in (the reference always writes [], but reads them)
    text = serialize_scene(scene, meta).replace("camera_motion: []\n", _MOTION)
    _, m2, _ = _load(text)
    assert len(m2.camera_motion) == 1
    kf = m2.camera_motion[0]
    assert kf.duration == 2.0
    assert kf.camera_target == (0.0, -30.0, 172.0)
    assert kf.velocity == (1.0, 0.0, 0.0)


# -- across the packages -------------------------------------------------------

@pytest.mark.parametrize("which", ["default", "spheres"])
def test_files_cross_between_packages(which):
    """The port writes the JAX package's text; each package loads the
    other's file to the same leaves, and the keyframes alike."""
    import ray_rust_tpu as rt
    from ray_rust_tpu.models import serialize as jser

    jax_scene, jax_meta = rt.default_scene() if which == "default" else _spheres(rt)
    scene, meta = rtt.default_scene(device="cpu") if which == "default" else _spheres(rtt)
    _assert_same_leaves(jax_scene, scene)
    text = serialize_scene(scene, meta)
    jax_text = jser.serialize_scene(jax_scene, jax_meta)
    assert text == jax_text
    text = text.replace("camera_motion: []\n", _MOTION)
    ours, ours_meta, ours_caps = _load(text)
    theirs, theirs_meta, theirs_caps = jser.deserialize_scene(text)
    _assert_same_leaves(ours, theirs)
    _assert_same_leaves(ours, _load(jax_text)[0])
    assert ours_caps == theirs_caps
    a, b = ours_meta.camera_motion[0], theirs_meta.camera_motion[0]
    assert (a.velocity, a.camera_target, a.duration) == (b.velocity, b.camera_target, b.duration)
    _assert_same_leaves(a.camera, b.camera)


def test_texture_name_opens_the_same_atlas(tmp_path):
    """A file naming ``bar.png`` (the default scene's floor where the file
    lies) opens it from ``texture_dir`` in both packages: the same texture
    bank, Nearest and Bilinear, and the port's file loads back to its
    scene."""
    import ray_rust_tpu as rt
    from ray_rust_tpu.models import serialize as jser

    tex = np.random.default_rng(101).integers(0, 256, (24, 40, 3)).astype(np.uint8)
    save_png(str(tmp_path / "bar.png"), tex)
    for filt in (0, 1):
        scene, meta = rtt.default_scene(texture_dir=str(tmp_path), texture_filter=filt,
                                        device="cpu")
        # a name relative to the file's texture directory
        meta = rtt.SceneMeta(meta.material_names, ("bar.png",) + meta.texture_names[1:],
                             meta.bg)
        text = serialize_scene(scene, meta)
        assert "texture_name: bar.png" in text
        ours, _, _ = _load(text, texture_dir=str(tmp_path))
        theirs, _, _ = jser.deserialize_scene(text, texture_dir=str(tmp_path))
        assert ours.textures is not None
        _assert_same_leaves(ours, theirs)
        _assert_same_leaves(ours, scene)
        np.testing.assert_array_equal(ours.textures.data[0].numpy(), tex)
