"""Scene: stacked object table + material table + camera + light.

PyTorch counterpart of ``ray_rust_tpu/models/scene.py``. All objects live in
one structure-of-arrays table with a ``kind`` discriminator; every leaf is a
tensor, and a render runs on the device those tensors lie on
(:meth:`Scene.to`). The constructors put them on ``cuda`` unless the caller
passes another ``device``; where there is no CUDA device, torch's own error
is raised rather than a silent CPU scene.

:func:`scene_from_numpy` builds a :class:`Scene` from a flat dict of numpy
leaves keyed by dotted field path (``"objects.org.x"``), the layout
:func:`scene_to_numpy` writes for any scene of the same structure — including
the JAX package's, whose field names are the same. That is how one scene is
carried into both packages, its texture atlas too.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from .material import (
    MaterialSpec,
    MaterialTable,
    TextureBank,
    UVMAP_XY,
    build_material_table,
)
from .quat import Quat
from .vec import Color, Vec3, v3

__all__ = [
    "KIND_SPHERE",
    "KIND_FLOOR",
    "ObjectTable",
    "Camera",
    "Scene",
    "SceneMeta",
    "CameraKeyframe",
    "SphereSpec",
    "FloorSpec",
    "build_scene",
    "default_scene",
    "leaf_paths",
    "scene_from_numpy",
    "scene_to_numpy",
]

KIND_SPHERE = 0
KIND_FLOOR = 1


class ObjectTable(NamedTuple):
    """All scene objects stacked; leaves have leading dim ``(N,)``. Spheres
    use ``org``/``radius``, floors ``org``/``normal``; unused fields are 0."""

    kind: torch.Tensor  # (N,) int32
    org: Vec3
    radius: torch.Tensor
    normal: Vec3
    mat: torch.Tensor  # (N,) int32 material row
    uvmap: torch.Tensor  # (N,) int32

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Camera(NamedTuple):
    """Camera pose (render.rs:617-622). ``rotation`` drives ray generation;
    ``pyr`` is kept for serialization parity."""

    position: Vec3
    pyr: Vec3
    rotation: Quat

    @staticmethod
    def from_pyr(position: Vec3, pyr: Vec3) -> "Camera":
        return Camera(position, pyr, Quat.from_pyr(pyr))


@dataclasses.dataclass
class CameraKeyframe:
    """Animation keyframe (render.rs:634-640), kept on the host:
    ``animation.render_frames`` interpolates the camera there and renders
    each frame."""

    camera: Camera
    velocity: tuple
    camera_target: Optional[tuple]
    duration: float


def _map_tensors(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map_tensors(fn, t) for t in tree))


class Scene(NamedTuple):
    objects: ObjectTable
    materials: MaterialTable
    camera: Camera
    light: Vec3  # normalized direction toward the light
    textures: Optional[TextureBank] = None

    @property
    def device(self) -> torch.device:
        return self.light.x.device

    def to(self, device) -> "Scene":
        return _map_tensors(lambda t: t.to(device), self)

    def tensors(self) -> list:
        out = []
        _map_tensors(out.append, self)
        return out

    def with_tensors(self, tensors) -> "Scene":
        """The same scene with its tensors replaced by ``tensors``, given in
        the order of :meth:`tensors`."""
        it = iter(tensors)
        return _map_tensors(lambda _: next(it), self)


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static host-side companion to :class:`Scene`."""

    material_names: tuple
    texture_names: tuple
    bg: str = "default_sky"
    camera_motion: tuple = ()  # of CameraKeyframe


@dataclasses.dataclass
class SphereSpec:
    material: str
    r: float
    org: tuple
    uvmap: int = UVMAP_XY


@dataclasses.dataclass
class FloorSpec:
    material: str
    org: tuple
    face_normal: tuple
    uvmap: int = UVMAP_XY


def build_scene(materials: List[MaterialSpec], objects: list, camera_position,
                camera_pyr, light, camera_motion: tuple = (), bg: str = "default_sky",
                device="cuda"):
    """Assemble the scene tensors + static meta from host specs, on
    ``device``. Objects keep their order: the nearest-hit scan tie-breaks to
    the lowest index (render.rs:1003-1015) and index 0 ends the bounce loop
    (render.rs:1187-1189). The camera quaternion and the light are computed
    on the host, so every device gets the same values."""
    mat_ids = {m.name: i for i, m in enumerate(materials)}
    table, bank = build_material_table(materials)

    kinds, orgs, radii, normals, mats, uvmaps = [], [], [], [], [], []
    for o in objects:
        if isinstance(o, SphereSpec):
            kinds.append(KIND_SPHERE)
            radii.append(o.r)
            normals.append((0.0, 0.0, 0.0))
        elif isinstance(o, FloorSpec):
            kinds.append(KIND_FLOOR)
            radii.append(0.0)
            normals.append(o.face_normal)
        else:
            raise TypeError(f"unknown object spec {o!r}")
        if o.material not in mat_ids:
            raise KeyError(f"couldn't find material {o.material}")
        orgs.append(o.org)
        mats.append(mat_ids[o.material])
        uvmaps.append(o.uvmap)

    def vec_col(rows):
        a = torch.tensor(np.asarray(rows, np.float32))
        return Vec3(a[:, 0].clone(), a[:, 1].clone(), a[:, 2].clone())

    def i32(vals):
        return torch.tensor(np.asarray(vals, np.int32))

    objs = ObjectTable(
        kind=i32(kinds),
        org=vec_col(orgs),
        radius=torch.tensor(np.asarray(radii, np.float32)),
        normal=vec_col(normals),
        mat=i32(mats),
        uvmap=i32(uvmaps),
    )
    scene = Scene(
        objects=objs,
        materials=table,
        camera=Camera.from_pyr(v3(*camera_position), v3(*camera_pyr)),
        light=v3(*light).normalized(),
        textures=bank,
    ).to(device)
    meta = SceneMeta(
        material_names=tuple(m.name for m in materials),
        texture_names=tuple(m.texture_name for m in materials),
        bg=bg,
        camera_motion=tuple(camera_motion),
    )
    return scene, meta


def default_scene(texture_dir: str = ".", texture_filter: int = 0, device="cuda"):
    """The reference's built-in scene (src/main.rs:154-276): a floor, two
    mirror spheres, a red sphere and a glass sphere. The floor takes the
    texture ``<texture_dir>/bar.png`` where that is an RGB PNG
    (:func:`~.material.load_texture`), filtered by ``texture_filter`` (0 =
    Nearest, the reference's default, render.rs:59-63; 1 = Bilinear), and
    keeps its gradation pattern otherwise."""
    import os

    from .material import PATTERN_GRADATION, UVMAP_ZX

    pi = float(np.pi)
    floor = MaterialSpec(
        name="floor",
        diffuse=(1.0, 1.0, 0.0),
        pattern=PATTERN_GRADATION,
        pattern_scale=300.0,
        pattern_angle_scale=0.2,
        texture_filter=texture_filter,
    ).texture_ok(os.path.join(texture_dir, "bar.png"))
    mirror = MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24)
    red = MaterialSpec(name="red", diffuse=(0.8, 0.0, 0.0), pn=24,
                       glow_dist=5.0)
    transparent = MaterialSpec(name="transparent", transparency=1.0,
                               refraction=1.5, frac=(1.49998, 1.49999, 1.5))
    objects = [
        FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=UVMAP_ZX),
        SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
        SphereSpec("mirror", 80.0, (-200.0, -30.0, 172.0)),
        SphereSpec("red", 80.0, (-200.0, -200.0, 172.0)),
        SphereSpec("transparent", 100.0, (70.0, -200.0, 150.0)),
    ]
    return build_scene(
        materials=[floor, mirror, red, transparent],
        objects=objects,
        camera_position=(0.0, -150.0, -300.0),
        camera_pyr=(0.0, -pi / 2.0, -pi / 2.0),
        light=(50.0, 60.0, -50.0),
        device=device,
    )


def _leaf_paths(tree, prefix=""):
    for name in tree._fields:
        leaf = getattr(tree, name)
        if leaf is None:
            continue
        path = prefix + name
        if hasattr(leaf, "_fields"):
            yield from _leaf_paths(leaf, path + ".")
        elif hasattr(leaf, "packed"):  # the JAX package's TextureBank, a class
            for field in TextureBank._fields:
                yield f"{path}.{field}", getattr(leaf, field)
        else:
            yield path, leaf


def leaf_paths(scene) -> list:
    """The dotted paths of a scene's leaves, in the order of
    :meth:`Scene.tensors` (the keys of :func:`scene_to_numpy`)."""
    return [path for path, _ in _leaf_paths(scene)]


def scene_to_numpy(scene) -> dict:
    """Flat ``{dotted path: numpy array}`` of a scene's leaves. Works on any
    NamedTuple tree whose leaves convert with ``np.asarray``."""
    out = {}
    for path, leaf in _leaf_paths(scene):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        out[path] = np.asarray(leaf)
    return out


def _leaf_dtype(a: np.ndarray) -> torch.dtype:
    """f32 for float leaves; uint8 (the texture atlas) stays uint8; other
    integer leaves become int32."""
    if a.dtype == np.uint8:
        return torch.uint8
    return torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32


def scene_from_numpy(leaves: dict, device="cuda") -> Scene:
    """Build a :class:`Scene` on ``device`` from :func:`scene_to_numpy`'s
    layout. Float leaves become f32 tensors, uint8 leaves stay uint8, other
    integer leaves become int32; an optional part (the textures) is None
    when no leaf lies under it."""

    def build(cls, prefix):
        fields = []
        for name, typ in typing.get_type_hints(cls).items():
            path = prefix + name
            if typing.get_origin(typ) is Union:  # Optional[...]
                typ = next(a for a in typing.get_args(typ) if a is not type(None))
                if not any(k.startswith(path + ".") for k in leaves):
                    fields.append(None)
                    continue
            if typ is torch.Tensor:
                a = np.asarray(leaves[path])
                fields.append(torch.tensor(a, dtype=_leaf_dtype(a), device=device))
            else:  # a nested NamedTuple
                fields.append(build(typ, path + "."))
        return cls(*fields)

    return build(Scene, "")
