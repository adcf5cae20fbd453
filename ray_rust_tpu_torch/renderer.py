"""Top-level render entry points.

PyTorch counterpart of ``ray_rust_tpu/renderer.py``. A render runs on the
device of the scene's tensors:

- CUDA: the trace kernel (``ops/kernel_trace.py``) in trace mode, the march
  kernel (``ops/kernel_march.py``) in march mode, or ``NotImplementedError``
  naming what the kernels do not cover. A scene that requires grad goes
  through ``kernel_trace_bwd.TraceRender`` (the trace kernel forward, the
  backward kernel K2) or ``kernel_march_bwd.MarchRender`` (the march kernel
  forward, the march backward kernel K4) under autograd;
- CPU: the plain PyTorch version, differentiable by autograd, through the
  march's implicit VJP in march mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import RenderConfig
from .models.scene import Scene
from .models.vec import Color
from .ops import kernel_march, kernel_march_bwd, kernel_trace, kernel_trace_bwd

__all__ = ["render_color", "render_u8", "to_u8"]


def render_color(scene: Scene, cfg: RenderConfig) -> Color:
    """Forward render: scene -> Color of ``(H, W)`` planes on the scene's
    device."""
    dev = scene.device
    march = cfg.use_raymarching
    kernels = kernel_march if march else kernel_trace
    if dev.type == "cpu":
        return kernels.render_color_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render path for device {dev}")
    if any(t.requires_grad for t in scene.tensors()):
        grads = kernel_march_bwd if march else kernel_trace_bwd
        reason = grads.unsupported_reason(scene, cfg)
        if reason is not None:
            raise NotImplementedError(f"no CUDA gradient path: {reason}")
        return grads.render_color_grad(scene, cfg)
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
