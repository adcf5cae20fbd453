"""Camera ray generation (render.rs:806-815).

PyTorch counterpart of ``ray_rust_tpu/ops/rays.py``: the ``(H, W)`` grid of
eye directions, rotated by the camera quaternion, on the camera's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..models.quat import Quat
from ..models.vec import Vec3

__all__ = ["camera_rays", "fov_scales"]


def fov_scales(cfg: RenderConfig):
    """``(2·xfov, 2·yfov)`` rounded in f32, as the JAX package computes them."""
    two = np.float32(2.0)
    return float(two * np.float32(cfg.xfov)), float(two * np.float32(cfg.resolved_yfov()))


def camera_rays(camera_position: Vec3, camera_rotation: Quat, cfg: RenderConfig):
    """``eye = normalize(rot · (1, (ix - xres/2)·2·xfov/xres,
    -(iy - yres/2)·2·yfov/yres))`` with integer ``xres/2``; the origin is the
    camera position. Returns ``(vi, eye)`` as Vec3 of ``(H, W)`` tensors."""
    xres, yres = cfg.xres, cfg.yres
    dev = camera_position.x.device
    sx, sy = fov_scales(cfg)

    ix = torch.arange(xres, dtype=torch.int32, device=dev).expand(yres, xres)
    iy = torch.arange(yres, dtype=torch.int32, device=dev)[:, None].expand(yres, xres)

    # The divisors are device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds differently from a
    # true division (the JAX package's and the trace kernel's).
    def res(n):
        return torch.tensor(float(n), device=dev)

    ex = torch.ones((yres, xres), dtype=torch.float32, device=dev)
    ey = (ix - xres // 2).to(torch.float32) * sx / res(xres)
    ez = -(iy - yres // 2).to(torch.float32) * sy / res(yres)

    eye = camera_rotation.transform(Vec3(ex, ey, ez)).normalized()
    vi = camera_position.broadcast_to((yres, xres))
    return vi, eye
