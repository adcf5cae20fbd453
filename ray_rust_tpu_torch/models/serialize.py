"""YAML scene (de)serialization, wire-compatible with reference scene files.

PyTorch counterpart of ``ray_rust_tpu/models/serialize.py``, with its
semantics: ``RenderEnv::serialize``/``deserialize`` (src/render.rs:735-798)
and the serial forms (materials render.rs:65-80, objects render.rs:319-339,
camera render.rs:600-615), in serde_yaml 0.8's conventions:

* externally tagged enums are single-key maps (``- Sphere: {...}``); the
  reader also accepts serde_yaml 0.9's ``!Sphere`` tags;
* unit enum variants are plain strings (``pattern: Solid``);
* the camera-motion newtype is a bare list;
* :func:`serialize_scene` writes the compile-time MAX_REFLECTIONS /
  MAX_REFRACTIONS and an empty camera_motion, as the reference does
  (render.rs:741-743);
* textures are re-opened from ``texture_name`` under ``texture_dir`` on load
  (render.rs:215), and an object whose material is missing is an error
  (render.rs:414-419).

A scene is read from the host's tensors and built on the device the caller
asks for (``cuda`` by default), as :func:`~.scene.build_scene` builds it.
"""

from __future__ import annotations

import os
from typing import Tuple

import yaml

from ..config import REF_MAX_REFLECTIONS, REF_MAX_REFRACTIONS
from .material import (
    FILTER_IDS,
    FILTER_NAMES,
    PATTERN_IDS,
    PATTERN_NAMES,
    UVMAP_IDS,
    UVMAP_NAMES,
    MaterialSpec,
    load_texture,
)
from .scene import (
    KIND_SPHERE,
    Camera,
    CameraKeyframe,
    FloorSpec,
    Scene,
    SceneMeta,
    SphereSpec,
    build_scene,
    scene_to_numpy,
)
from .vec import v3

__all__ = ["serialize_scene", "deserialize_scene", "DeserializeError"]


def _vec_yaml(x, y, z):
    return {"x": float(x), "y": float(y), "z": float(z)}


def _color_yaml(r, g, b):
    return {"r": float(r), "g": float(g), "b": float(b)}


def serialize_scene(scene: Scene, meta: SceneMeta) -> str:
    """Scene -> reference-format YAML string (render.rs:735-760)."""
    a = scene_to_numpy(scene)  # one copy to the host

    def vec(prefix, i=None):
        return _vec_yaml(*(a[f"{prefix}.{c}"] if i is None else a[f"{prefix}.{c}"][i]
                           for c in "xyz"))

    def color(prefix, i):
        return _color_yaml(*(a[f"materials.{prefix}.{c}"][i] for c in "rgb"))

    materials = {}
    # only the materials that objects use (render.rs:751-756)
    for i in set(int(m) for m in a["objects.mat"]):
        name = meta.material_names[i]
        materials[name] = {
            "name": name,
            "diffuse": color("diffuse", i),
            "specular": color("specular", i),
            "pn": int(a["materials.pn"][i]),
            "t": float(a["materials.transparency"][i]),
            "n": float(a["materials.refraction"][i]),
            "glow_dist": float(a["materials.glow_dist"][i]),
            "frac": color("frac", i),
            "pattern": PATTERN_NAMES[int(a["materials.pattern"][i])],
            "pattern_scale": float(a["materials.pattern_scale"][i]),
            "pattern_angle_scale": float(a["materials.pattern_angle_scale"][i]),
            "texture_name": meta.texture_names[i],
            "texture_filter": FILTER_NAMES[int(a["materials.texture_filter"][i])],
        }

    objects = []
    for i in range(scene.objects.count):
        body = {"material": meta.material_names[int(a["objects.mat"][i])]}
        uv = UVMAP_NAMES[int(a["objects.uvmap"][i])]
        if int(a["objects.kind"][i]) == KIND_SPHERE:
            body.update(r=float(a["objects.radius"][i]), org=vec("objects.org", i), uvmap=uv)
            objects.append({"Sphere": body})
        else:
            body.update(org=vec("objects.org", i), face_normal=vec("objects.normal", i),
                        uvmap=uv)
            objects.append({"Floor": body})

    doc = {
        "camera": {"position": vec("camera.position"), "pyr": vec("camera.pyr")},
        # the reference writes its constants and an empty motion (render.rs:741-743)
        "camera_motion": [],
        "max_reflections": REF_MAX_REFLECTIONS,
        "max_refractions": REF_MAX_REFRACTIONS,
        "materials": materials,
        "objects": objects,
    }
    return "---\n" + yaml.safe_dump(doc, sort_keys=False)


class _TaggedLoader(yaml.SafeLoader):
    """Reads serde_yaml 0.9's local tags (``!Sphere``) as single-key maps."""


def _tag_to_map(loader, tag_suffix, node):
    if isinstance(node, yaml.MappingNode):
        return {tag_suffix: loader.construct_mapping(node, deep=True)}
    if isinstance(node, yaml.SequenceNode):
        return {tag_suffix: loader.construct_sequence(node, deep=True)}
    return {tag_suffix: loader.construct_scalar(node)}


yaml.add_multi_constructor("!", _tag_to_map, Loader=_TaggedLoader)


def _get_vec(d) -> Tuple[float, float, float]:
    return (float(d["x"]), float(d["y"]), float(d["z"]))


class DeserializeError(ValueError):
    """Scene-file error (the reference's DeserializeError, render.rs:341-366)."""


def _variant(v) -> str:
    """A unit enum variant: a plain string, or a single-key map or tag."""
    if isinstance(v, str):
        return v
    if isinstance(v, dict) and len(v) == 1:
        return next(iter(v))
    raise DeserializeError(f"bad enum variant {v!r}")


def _material(name: str, m: dict, texture_dir: str) -> MaterialSpec:
    spec = MaterialSpec(
        name=name,
        diffuse=(m["diffuse"]["r"], m["diffuse"]["g"], m["diffuse"]["b"]),
        specular=(m["specular"]["r"], m["specular"]["g"], m["specular"]["b"]),
        pn=int(m["pn"]),
        transparency=float(m["t"]),
        refraction=float(m["n"]),
        glow_dist=float(m.get("glow_dist", 0.0)),
        frac=(m["frac"]["r"], m["frac"]["g"], m["frac"]["b"]),
        pattern=PATTERN_IDS[_variant(m["pattern"])],
        pattern_scale=float(m.get("pattern_scale", 1.0)),
        pattern_angle_scale=float(m.get("pattern_angle_scale", 1.0)),
        texture_filter=FILTER_IDS[_variant(m.get("texture_filter", "Nearest"))],
    )
    tex_name = m.get("texture_name", "")
    if tex_name:
        spec.texture_name = tex_name
        spec.texture = load_texture(os.path.join(texture_dir, tex_name))
    return spec


def _object(entry, known):
    if not isinstance(entry, dict) or len(entry) != 1:
        raise DeserializeError(f"malformed object entry {entry!r}")
    (variant, body), = entry.items()
    mat = body["material"]
    if mat not in known:
        raise DeserializeError(f"Render{variant} couldn't find material {mat}")
    uv = UVMAP_IDS[_variant(body.get("uvmap", "XY"))]
    if variant == "Sphere":
        return SphereSpec(mat, float(body["r"]), _get_vec(body["org"]), uv)
    if variant == "Floor":
        return FloorSpec(mat, _get_vec(body["org"]), _get_vec(body["face_normal"]), uv)
    raise DeserializeError(f"unknown object variant {variant}")


def _keyframe(kf) -> CameraKeyframe:
    c = kf["camera"]
    target = kf.get("camera_target")
    return CameraKeyframe(
        camera=Camera.from_pyr(v3(*_get_vec(c["position"])), v3(*_get_vec(c["pyr"]))),
        velocity=_get_vec(kf["velocity"]),
        camera_target=_get_vec(target) if target is not None else None,
        duration=float(kf["duration"]),
    )


def deserialize_scene(text: str, texture_dir: str = ".", device="cuda"):
    """YAML string -> ``(Scene, SceneMeta, caps)`` per render.rs:762-798, the
    scene on ``device``; ``caps`` holds the file's ``max_reflections`` and
    ``max_refractions``. Raises :class:`DeserializeError` on an object whose
    material is missing."""
    doc = yaml.load(text, Loader=_TaggedLoader)
    if not isinstance(doc, dict):
        raise DeserializeError("scene file is not a mapping")
    mat_specs = [_material(name, m, texture_dir) for name, m in doc.get("materials", {}).items()]
    known = {s.name for s in mat_specs}
    objects = [_object(entry, known) for entry in doc.get("objects", [])]
    cam = doc["camera"]
    scene, meta = build_scene(
        materials=mat_specs,
        objects=objects,
        camera_position=_get_vec(cam["position"]),
        camera_pyr=_get_vec(cam["pyr"]),
        # the file carries no light (render.rs:736-760): the default scene's
        light=(50.0, 60.0, -50.0),
        camera_motion=tuple(_keyframe(kf) for kf in doc.get("camera_motion") or []),
        device=device,
    )
    caps = {
        "max_reflections": int(doc.get("max_reflections", REF_MAX_REFLECTIONS)),
        "max_refractions": int(doc.get("max_refractions", REF_MAX_REFRACTIONS)),
    }
    return scene, meta, caps
