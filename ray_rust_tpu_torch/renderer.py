"""Top-level render entry points.

PyTorch counterpart of ``ray_rust_tpu/renderer.py``. A render runs on the
device of the scene's tensors:

- CUDA: the trace kernel (``ops/kernel_trace.py``) in trace mode, the march
  kernel (``ops/kernel_march.py``) in march mode, or ``NotImplementedError``
  naming the ROADMAP item that would cover the request;
- CPU: the plain PyTorch version, differentiable by autograd in trace mode.

March mode has no gradient yet on either device: a march render of a scene
that requires grad raises rather than return an autograd gradient that is
not the JAX package's implicit one.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import RenderConfig
from .models.scene import Scene
from .models.vec import Color
from .ops import kernel_march, kernel_trace

__all__ = ["render_color", "render_u8", "to_u8"]


def render_color(scene: Scene, cfg: RenderConfig) -> Color:
    """Forward render: scene -> Color of ``(H, W)`` planes on the scene's
    device."""
    dev = scene.device
    grad = any(t.requires_grad for t in scene.tensors())
    if cfg.use_raymarching and grad:
        raise NotImplementedError(
            "march-mode gradients are not ported yet (ROADMAP queue 1 item 6: the "
            "implicit VJP _march_while_vjp, and kernel K4)")
    kernels = kernel_march if cfg.use_raymarching else kernel_trace
    if dev.type == "cpu":
        return kernels.render_color_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render path for device {dev}")
    if grad:
        raise NotImplementedError(
            "gradients on the card need the backward kernel, which is not "
            "ported yet (ROADMAP queue 2, K2); render on the CPU for autograd")
    reason = kernels.unsupported_reason(scene, cfg)
    if reason is not None:
        raise NotImplementedError(f"no CUDA render path: {reason}")
    return kernels.render_color_kernel(scene, cfg)


def to_u8(img: Color) -> torch.Tensor:
    """Float color -> ``(H, W, 3)`` uint8 with the reference's saturating
    conversion ``(c*255).min(255) as u8`` (src/main.rs:148-152): truncation
    toward zero; negatives and NaNs clamp to 0."""
    def chan(c):
        c = torch.nan_to_num(c * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
        return torch.clamp(torch.trunc(torch.clamp(c, max=255.0)), 0.0, 255.0).to(torch.uint8)

    return torch.stack([chan(img.r), chan(img.g), chan(img.b)], dim=-1)


def render_u8(scene: Scene, cfg: RenderConfig) -> np.ndarray:
    """Render straight to a host ``(H, W, 3)`` uint8 array."""
    with torch.no_grad():
        return to_u8(render_color(scene, cfg)).cpu().numpy()
