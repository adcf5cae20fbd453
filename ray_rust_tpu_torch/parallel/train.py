"""Inverse rendering: the loss, a plain SGD step, and the optimizer step
with its state, on one device or over a ``(dp, sp)`` mesh.

PyTorch counterpart of ``render_loss``, ``sgd_train_step``, ``TrainState``
and ``make_train_step`` in ``ray_rust_tpu/parallel/train.py``. With a mesh
(``parallel/shard.py``), each of this process's cells renders its window of
the frame and sums its squared error against its window of the target on
its device; the loss is the frame's mean, and autograd sums the cells'
gradients on the scene's leaves (the JAX package's replicated scene, whose
gradient XLA sums over the mesh). Across processes (a mesh whose cells
belong to every rank of the ``torch.distributed`` group,
``multihost.global_mesh``) the trained leaves' gradients and the loss are
summed by one ``all_reduce`` (NCCL on the card's tensors, gloo through host
copies), and only then are non-finite entries zeroed, as the JAX step
zeroes the global gradient ``jax.value_and_grad`` returns
(``ray_rust_tpu/parallel/train.py:60-70``): a NaN on one rank makes the
entry 0 on every rank.

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
from .shard import Mesh, cell_shape, process_rank, render_tiles

__all__ = ["render_loss", "reduce_gradients", "sgd_train_step", "TrainState", "make_train_step",
           "SceneAdam", "train_state_from_numpy", "EXAMPLE_TRAINED"]


def render_loss(scene: Scene, cfg: RenderConfig, target_rgb: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """MSE between the rendered image and an ``(H, W, 3)`` float target.
    With ``mesh``, the part of the frame's mean that this process's cells
    hold: each cell renders its window (``shard.render_tiles``) and sums its
    squared error against the target's window on its device; the sums, on
    the scene's device, over ``3·H·W``. On a mesh of one process that is the
    frame's loss; across processes the parts sum to it
    (:func:`reduce_gradients`). Raises ValueError where the image does not
    divide over the mesh."""
    if mesh is None:
        img = render_color(scene, cfg)
        stacked = torch.stack([img.r, img.g, img.b], dim=-1)
        return torch.mean((stacked - target_rgb) ** 2)
    cell_shape(cfg.yres, cfg, mesh)
    total = torch.zeros((), dtype=torch.float32, device=scene.device)
    for tile in render_tiles(scene, cfg, mesh):
        (r0, c0), (h, w) = tile.origin, tile.color.r.shape
        stacked = torch.stack(tuple(tile.color), dim=-1)
        want = target_rgb[r0:r0 + h, c0:c0 + w].to(stacked.device)
        total = total + torch.sum((stacked - want) ** 2).to(scene.device)
    return total / (3 * cfg.yres * cfg.xres)


def _spans_ranks(mesh: Optional[Mesh]) -> bool:
    """Whether a step over ``mesh`` sums its gradient across processes: its
    cells belong to every rank of the default group (in a group of one
    rank, where the sum is the identity, too). A mesh of this process alone
    in a larger group sums nothing; any other set of ranks raises."""
    import torch.distributed as dist

    if mesh is None or not (dist.is_available() and dist.is_initialized()):
        return False
    ranks = {c[3] for c in mesh.cells()}
    if ranks == set(range(dist.get_world_size())):
        return True
    if ranks == {process_rank()}:
        return False
    raise ValueError(f"a training mesh holds this process's cells alone or every rank's, "
                     f"not ranks {sorted(ranks)} of {dist.get_world_size()}")


def _nonfinite_to_zero(g: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def reduce_gradients(grads: list, loss: torch.Tensor, mesh: Optional[Mesh] = None):
    """The global gradient and loss of a step over ``mesh``: where its cells
    belong to every rank (:func:`_spans_ranks`), ``grads`` (a tensor for
    each trained leaf, in ``Scene.tensors()``'s order, zeros for a leaf the
    render does not reach) and ``loss`` summed over the ranks by one
    ``all_reduce(SUM)`` of their concatenation (NCCL on its device, any
    other backend through a host copy); then each gradient's non-finite
    entries as 0. Every rank must call it with the same shapes. Returns
    ``(grads, loss)``."""
    if _spans_ranks(mesh):
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        buf = flat if dist.get_backend() == "nccl" else flat.cpu()
        dist.all_reduce(buf)
        flat = buf.to(flat.device)
        parts = torch.split(flat, [g.numel() for g in grads] + [1])
        grads = [part.view_as(g) for part, g in zip(parts, grads)]
        loss = parts[-1].reshape(())
    return [_nonfinite_to_zero(g) for g in grads], loss


def _gradients(loss: torch.Tensor, leaves: list, params: list) -> list:
    """The gradient of ``loss`` for each of ``leaves``: autograd's for those
    among ``params`` that it reaches, zeros for every other."""
    got = torch.autograd.grad(loss, params, allow_unused=True)
    by_id = {id(p): g for p, g in zip(params, got)}
    return [torch.zeros_like(t) if by_id.get(id(t)) is None else by_id[id(t)] for t in leaves]


def sgd_train_step(scene: Scene, cfg: RenderConfig, target, lr: float = 1e-2,
                   grad_clip: float = 1e3, mesh: Optional[Mesh] = None):
    """One SGD step against ``target`` on the leaves of ``scene`` that
    require grad (float leaves; mark them with ``requires_grad_``):
    ``p - lr * clip(nan_to_num(g), -grad_clip, grad_clip)``, where non-finite
    gradient entries count as 0 (silhouette subgradients and near-tangent
    rays are heavy-tailed). Every other leaf is left as it is, and so is a
    trained leaf the render does not read. With ``mesh``, the loss over its
    cells (:func:`render_loss`) and the gradient summed across ranks before
    the zeroing (:func:`reduce_gradients`). Returns
    ``(new_scene, loss)``; the new scene's trained leaves are fresh leaves
    that require grad, so steps chain."""
    leaves = scene.tensors()
    params = [t for t in leaves if t.requires_grad]
    if not params:
        raise ValueError("no leaf of the scene requires grad: nothing to train")
    loss = render_loss(scene, cfg, target, mesh)
    grads, loss = reduce_gradients(_gradients(loss, params, params), loss.detach(), mesh)
    grad_of = {id(t): g for t, g in zip(params, grads)}
    new = []
    with torch.no_grad():
        for t in leaves:
            if t.requires_grad:
                t = (t - lr * torch.clamp(grad_of[id(t)], -grad_clip, grad_clip))
                t = t.detach().requires_grad_()
            new.append(t)
    return scene.with_tensors(new), loss


class TrainState(NamedTuple):
    """A scene and the optimizer over its leaves: a ``torch.optim``
    optimizer whose parameters are tensors of ``scene`` (the JAX package's
    ``opt_state``, an optax state; ``checkpoint.py`` saves and restores
    both)."""

    scene: Scene
    opt_state: torch.optim.Optimizer


def make_train_step(cfg: RenderConfig, optimizer, mesh: Optional[Mesh] = None):
    """``step(state, target) -> (state, loss)``: the MSE against an
    ``(H, W, 3)`` target, the gradient of every float leaf of the scene
    through ``renderer.render_color`` (the kernels on a CUDA scene, autograd
    of the plain version on the CPU), over the cells of ``mesh`` and summed
    across its ranks where given (:func:`render_loss`,
    :func:`reduce_gradients`), non-finite entries as 0 (silhouette
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
        loss = render_loss(state.scene.with_tensors(leaves), cfg, target, mesh)
        grads, loss = reduce_gradients(_gradients(loss, params, params), loss.detach(), mesh)
        with torch.no_grad():
            optimizer.update(grads, state.opt_state, state.scene)
        return state, loss

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
