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

__all__ = ["camera_rays", "fov_scales", "window"]


def fov_scales(cfg: RenderConfig):
    """``(2·xfov, 2·yfov)`` rounded in f32, as the JAX package computes them."""
    two = np.float32(2.0)
    return float(two * np.float32(cfg.xfov)), float(two * np.float32(cfg.resolved_yfov()))


def window(cfg: RenderConfig, origin=(0, 0), shape=None) -> tuple:
    """``(row0, col0, h, w)``: the window of ``cfg``'s frame whose top-left
    pixel is ``origin = (row0, col0)`` and whose size is ``shape = (h, w)``
    (the whole frame by default), as the JAX kernels' ``origin=`` and
    ``shape=`` give it. Raises ValueError unless it lies in the frame and
    holds a pixel."""
    row0, col0 = (int(v) for v in origin)
    h, w = (cfg.yres, cfg.xres) if shape is None else (int(v) for v in shape)
    if not (0 <= row0 and 0 <= col0 and 0 < h and 0 < w
            and row0 + h <= cfg.yres and col0 + w <= cfg.xres):
        raise ValueError(f"window {h}x{w} at ({row0}, {col0}) is not in the "
                         f"{cfg.yres}x{cfg.xres} frame")
    return row0, col0, h, w


def camera_rays(camera_position: Vec3, camera_rotation: Quat, cfg: RenderConfig,
                origin=(0, 0), shape=None, rows=None):
    """``eye = normalize(rot · (1, (ix - xres/2)·2·xfov/xres,
    -(iy - yres/2)·2·yfov/yres))`` with integer ``xres/2``; the origin is the
    camera position. Returns ``(vi, eye)`` as Vec3 of ``(H, W)`` tensors, or
    of the window's ``(h, w)`` (:func:`window`): its pixels keep their global
    ``ix``, ``iy`` and the frame's ``xres``, ``yres``, so each is the whole
    frame's bit for bit. ``rows`` (a sequence of row indices) takes those
    whole rows instead, in that order: ``(len(rows), W)``, each pixel again
    the whole frame's."""
    xres, yres = cfg.xres, cfg.yres
    dev = camera_position.x.device
    sx, sy = fov_scales(cfg)
    if rows is None:
        row0, col0, h, w = window(cfg, origin, shape)
        iy = torch.arange(row0, row0 + h, dtype=torch.int32, device=dev)
    else:
        if not all(0 <= int(r) < yres for r in rows) or not len(rows):
            raise ValueError(f"rows {rows} are not rows of the {yres}x{xres} frame")
        col0, h, w = 0, len(rows), xres
        iy = torch.tensor([int(r) for r in rows], dtype=torch.int32, device=dev)

    ix = torch.arange(col0, col0 + w, dtype=torch.int32, device=dev).expand(h, w)
    iy = iy[:, None].expand(h, w)

    # The divisors are device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds differently from a
    # true division (the JAX package's and the trace kernel's).
    def res(n):
        return torch.tensor(float(n), device=dev)

    ex = torch.ones((h, w), dtype=torch.float32, device=dev)
    ey = (ix - xres // 2).to(torch.float32) * sx / res(xres)
    ez = -(iy - yres // 2).to(torch.float32) * sy / res(yres)

    eye = camera_rotation.transform(Vec3(ex, ey, ez)).normalized()
    vi = camera_position.broadcast_to((h, w))
    return vi, eye
