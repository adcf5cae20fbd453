"""Inverse rendering on one device: the loss, a plain SGD step, and the
optimizer step with its state.

PyTorch counterpart of ``render_loss``, ``sgd_train_step``, ``TrainState``
and ``make_train_step`` in ``ray_rust_tpu/parallel/train.py`` (the device
mesh and its gradient all-reduce come with the multi-device layer).
``torch.optim`` takes optax's role: :class:`SceneAdam` is the inverse
rendering example's ``optax.chain(clip_by_global_norm, multi_transform(
{adam, set_to_zero}))``, and :func:`train_state_from_numpy` carries the JAX
package's ``TrainState`` with its optax Adam state across. The gradient is
taken through
``renderer.render_color``: on a CUDA scene the trace kernel renders and the
trace backward kernel differentiates in trace mode
(``ops/kernel_trace_bwd.py``), the march kernel and the march backward
kernel in march mode (``ops/kernel_march_bwd.py``); on the CPU autograd
differentiates the plain version, a march through its implicit VJP
(``ops/march.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import Scene, leaf_paths, scene_from_numpy
from ..renderer import render_color

__all__ = ["render_loss", "sgd_train_step", "TrainState", "make_train_step", "SceneAdam",
           "train_state_from_numpy", "EXAMPLE_TRAINED"]


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


class TrainState(NamedTuple):
    """A scene and the optimizer over its leaves: a ``torch.optim``
    optimizer whose parameters are tensors of ``scene`` (the JAX package's
    ``opt_state``, an optax state; ``checkpoint.py`` saves and restores
    both)."""

    scene: Scene
    opt_state: torch.optim.Optimizer


def _nonfinite_to_zero(g: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def make_train_step(cfg: RenderConfig, optimizer):
    """``step(state, target) -> (state, loss)``: the MSE against an
    ``(H, W, 3)`` target, the gradient of every float leaf of the scene
    through ``renderer.render_color`` (the kernels on a CUDA scene, autograd
    of the plain version on the CPU), non-finite entries as 0 (silhouette
    subgradients and near-tangent rays are heavy-tailed; one NaN would
    poison every leaf through the clip and Adam's second moment), then
    ``optimizer.update(grads, state.opt_state, state.scene)`` with the
    gradients in ``Scene.tensors()``'s order of float leaves (a
    :class:`SceneAdam`; ``optimizer.init(scene)`` gives the state's
    ``opt_state``). The optimizer updates the scene's leaves in place, so
    the returned state is ``state``; integer leaves never change."""

    def step(state: TrainState, target):
        leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
                  for t in state.scene.tensors()]
        params = [t for t in leaves if t.requires_grad]
        loss = render_loss(state.scene.with_tensors(leaves), cfg, target)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _nonfinite_to_zero(g)
                 for p, g in zip(params, grads)]
        with torch.no_grad():
            optimizer.update(grads, state.opt_state, state.scene)
        return state, loss.detach()

    return step


# The inverse rendering example's trained leaves (examples/inverse_rendering.py:
# param_labels): the objects' centres and radii and the materials' diffuse
# colours; every other leaf is frozen.
EXAMPLE_TRAINED = ("objects.org.x", "objects.org.y", "objects.org.z", "objects.radius",
                   "materials.diffuse.r", "materials.diffuse.g", "materials.diffuse.b")


class SceneAdam:
    """The inverse rendering example's optimizer
    (``examples/inverse_rendering.py:111-117``):
    ``optax.chain(optax.clip_by_global_norm(1.0),
    optax.multi_transform({"opt": optax.adam(lr), "frozen": optax.set_to_zero()},
    labels))`` over a scene, with ``torch.optim.Adam`` (b1 0.9, b2 0.999,
    eps 1e-8: optax's defaults, eps_root 0) on the leaves at the dotted
    paths :data:`EXAMPLE_TRAINED` and every other leaf frozen. The global
    norm is taken over every float leaf's gradient, frozen ones too, before
    the split, as the chain takes it."""

    trained = EXAMPLE_TRAINED
    max_norm = 1.0

    def __init__(self, lr: float):
        self.lr = lr

    def trained_leaves(self, scene: Scene) -> list:
        """``(k, path)`` of each trained leaf: its position among the scene's
        float leaves, and its dotted path, in ``Scene.tensors()``'s order."""
        paths = [p for p, t in zip(leaf_paths(scene), scene.tensors()) if t.is_floating_point()]
        missing = set(self.trained) - set(paths)
        if missing:
            raise ValueError(f"no float leaves {sorted(missing)} in the scene")
        return [(k, p) for k, p in enumerate(paths) if p in self.trained]

    def init(self, scene: Scene) -> torch.optim.Adam:
        """Adam over the scene's trained leaves (the tensors themselves, which
        it updates in place), its moments zero and its step 0 from the start
        (as optax's ``init``, so a fresh state and a restored one have the
        same structure)."""
        floats = [t for t in scene.tensors() if t.is_floating_point()]
        params = [floats[k] for k, _ in self.trained_leaves(scene)]
        adam = torch.optim.Adam(params, lr=self.lr)
        for p in params:  # the state torch.optim.Adam makes at its first step
            adam.state[p] = {"step": torch.tensor(0.0),
                             "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                             "exp_avg_sq": torch.zeros_like(p,
                                                            memory_format=torch.preserve_format)}
        return adam

    def update(self, grads: list, adam: torch.optim.Adam, scene: Scene) -> None:
        """One step: ``grads`` are the gradients of the scene's float leaves
        in ``Scene.tensors()``'s order."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [torch.where(norm < self.max_norm, g, g / norm * self.max_norm) for g in grads]
        for p, (k, _) in zip(adam.param_groups[0]["params"], self.trained_leaves(scene)):
            p.grad = grads[k]
        adam.step()
        adam.zero_grad(set_to_none=True)


def train_state_from_numpy(leaves: dict, optimizer: SceneAdam, mu: dict, nu: dict, count,
                           device="cuda") -> TrainState:
    """The port's :class:`TrainState` from the JAX package's: the scene's
    leaves as :func:`scene_from_numpy` takes them, and optax Adam's first and
    second moments ``mu``, ``nu`` (``{dotted path: array}`` for the trained
    leaves) and its step ``count``."""
    scene = scene_from_numpy(leaves, device=device)
    adam = optimizer.init(scene)
    for p, (_, path) in zip(adam.param_groups[0]["params"], optimizer.trained_leaves(scene)):
        state = adam.state[p]
        state["exp_avg"].copy_(torch.tensor(np.asarray(mu[path], np.float32)))
        state["exp_avg_sq"].copy_(torch.tensor(np.asarray(nu[path], np.float32)))
        state["step"].fill_(int(count))
    return TrainState(scene, adam)
