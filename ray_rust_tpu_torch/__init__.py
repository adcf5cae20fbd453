"""ray_rust_tpu_torch — the differentiable ray tracer ported to PyTorch and CUDA.

A port of ``ray_rust_tpu`` (JAX) for NVIDIA Hopper GPUs, slice by slice.
It has the forward render in trace mode and in march mode with glow, and
the gradient in both: the plain PyTorch path (differentiable on the CPU)
and hand-written CUDA kernels for the card (``ops/kernel_trace.py``,
``ops/kernel_march.py``, ``ops/kernel_trace_bwd.py``,
``ops/kernel_march_bwd.py``). It imports ``torch`` and numpy, never JAX.
"""

from .config import RenderConfig
from .models.material import (
    FILTER_BILINEAR,
    FILTER_NEAREST,
    MaterialSpec,
    MaterialTable,
    PATTERN_CHECKERBOARD,
    PATTERN_GRADATION,
    PATTERN_SOLID,
    TextureBank,
    UVMAP_LL,
    UVMAP_XY,
    UVMAP_YZ,
    UVMAP_ZX,
)
from .models.quat import Quat
from .models.scene import (
    Camera,
    CameraKeyframe,
    FloorSpec,
    KIND_FLOOR,
    KIND_SPHERE,
    ObjectTable,
    Scene,
    SceneMeta,
    SphereSpec,
    build_scene,
    default_scene,
    scene_from_numpy,
    scene_to_numpy,
)
from .models.vec import Color, Vec3, color, v3
from .renderer import render, render_color, render_u8, to_u8

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "MaterialSpec",
    "MaterialTable",
    "TextureBank",
    "Quat",
    "Camera",
    "CameraKeyframe",
    "FloorSpec",
    "SphereSpec",
    "ObjectTable",
    "Scene",
    "SceneMeta",
    "build_scene",
    "default_scene",
    "scene_from_numpy",
    "scene_to_numpy",
    "Color",
    "Vec3",
    "v3",
    "color",
    "render",
    "render_color",
    "render_u8",
    "to_u8",
    "KIND_FLOOR",
    "KIND_SPHERE",
    "PATTERN_SOLID",
    "PATTERN_CHECKERBOARD",
    "PATTERN_GRADATION",
    "FILTER_NEAREST",
    "FILTER_BILINEAR",
    "UVMAP_XY",
    "UVMAP_YZ",
    "UVMAP_ZX",
    "UVMAP_LL",
]
