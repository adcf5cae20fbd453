"""Inverse rendering: the loss and a plain SGD step on one device.

PyTorch counterpart of ``render_loss`` and ``sgd_train_step`` in
``ray_rust_tpu/parallel/train.py``. The gradient is taken through
``renderer.render_color``: on a CUDA scene the trace kernel renders and the
trace backward kernel differentiates in trace mode
(``ops/kernel_trace_bwd.py``), the march kernel and the march backward
kernel in march mode (``ops/kernel_march_bwd.py``); on the CPU autograd
differentiates the plain version, a march through its implicit VJP
(``ops/march.py``).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..renderer import render_color

__all__ = ["render_loss", "sgd_train_step"]


def render_loss(scene: Scene, cfg: RenderConfig, target_rgb: torch.Tensor) -> torch.Tensor:
    """MSE between the rendered image and an ``(H, W, 3)`` float target."""
    img = render_color(scene, cfg)
    stacked = torch.stack([img.r, img.g, img.b], dim=-1)
    return torch.mean((stacked - target_rgb) ** 2)


def sgd_train_step(scene: Scene, cfg: RenderConfig, target, lr: float = 1e-2,
                   grad_clip: float = 1e3):
    """One SGD step against ``target`` on the leaves of ``scene`` that
    require grad (float leaves; mark them with ``requires_grad_``):
    ``p - lr * clip(nan_to_num(g), -grad_clip, grad_clip)``, where non-finite
    gradient entries count as 0 (silhouette subgradients and near-tangent
    rays are heavy-tailed). Every other leaf is left as it is, and so is a
    trained leaf the render does not read. Returns ``(new_scene, loss)``;
    the new scene's trained leaves are fresh leaves that require grad, so
    steps chain."""
    leaves = scene.tensors()
    params = [t for t in leaves if t.requires_grad]
    if not params:
        raise ValueError("no leaf of the scene requires grad: nothing to train")
    loss = render_loss(scene, cfg, target)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grad_of = {id(p): g for p, g in zip(params, grads)}
    new = []
    with torch.no_grad():
        for t in leaves:
            if t.requires_grad:
                g = grad_of[id(t)]
                if g is not None:
                    g = torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0),
                                    -grad_clip, grad_clip)
                    t = t - lr * g
                t = t.detach().requires_grad_()
            new.append(t)
    return scene.with_tensors(new), loss.detach()
