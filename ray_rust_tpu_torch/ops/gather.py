"""Per-hit object/material fields by index gather.

PyTorch counterpart of ``ray_rust_tpu/ops/gather.py``. The JAX package
fetches the differentiable fields with a one-hot matrix product, a
workaround for slow scatter-add gradients on the TPU; here every field is a
plain index gather, whose gradient is an ``index_add``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import KIND_SPHERE, Scene
from ..models.vec import Color, Vec3

__all__ = ["HitFields", "gather_hit_fields", "surface_normal_from"]


class HitFields(NamedTuple):
    """All per-hit fields the shading/bounce path needs."""

    kind: torch.Tensor  # int32
    uvmap: torch.Tensor  # int32
    pattern: torch.Tensor  # int32
    texture_id: torch.Tensor  # int32, -1 = none
    texture_filter: torch.Tensor  # int32

    org: Vec3
    normal: Vec3
    diffuse: Color
    specular: Color
    pn: torch.Tensor
    transparency: torch.Tensor
    refraction: torch.Tensor
    pattern_scale: torch.Tensor
    pattern_angle_scale: torch.Tensor


def gather_hit_fields(scene: Scene, idx) -> HitFields:
    """Fetch every needed object/material field at ``idx`` (any shape)."""
    objs, mats = scene.objects, scene.materials
    idx = idx.long()
    m = objs.mat.long()[idx]
    return HitFields(
        kind=objs.kind[idx],
        uvmap=objs.uvmap[idx],
        pattern=mats.pattern[m],
        texture_id=mats.texture_id[m],
        texture_filter=mats.texture_filter[m],
        org=objs.org.take(idx),
        normal=objs.normal.take(idx),
        diffuse=mats.diffuse.take(m),
        specular=mats.specular.take(m),
        pn=mats.pn[m],
        transparency=mats.transparency[m],
        refraction=mats.refraction[m],
        pattern_scale=mats.pattern_scale[m],
        pattern_angle_scale=mats.pattern_angle_scale[m],
    )


def surface_normal_from(fields: HitFields, pt: Vec3) -> Vec3:
    """Sphere ``(pt-org)/|pt-org|`` (render.rs:443-445) or the floor's stored
    face normal (render.rs:553-555)."""
    sphere_n = (pt - fields.org).normalized()
    return sphere_n.where(fields.kind == KIND_SPHERE, fields.normal)
