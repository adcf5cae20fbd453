"""Checkpoint and resume for inverse-rendering runs.

PyTorch counterpart of ``ray_rust_tpu/checkpoint.py``. The reference's only
persistence is the scene YAML (src/render.rs:735-798, the CLI's ``-s`` and
``-d``); a training run must also survive preemption with its optimizer
state. A state is a tree of named tuples (a :class:`Scene`, a
``parallel.TrainState``) or dicts whose leaves are tensors, ``None`` or a
``torch.optim`` optimizer:

* its tensors, and each optimizer's state tensors (for Adam its step and
  moments), go into one compressed ``.npz``, no pickle;
* the header records the structure, each saved tensor's name (its dotted
  path; the optimizer's as ``<path>.state.<index>.<key>``), shape and dtype,
  in ``Scene.tensors()``'s order; :func:`restore` checks it against a
  template and raises on any difference, so a checkpoint never loads into
  the wrong structure;
* writes are atomic (a temporary file, then ``os.replace``);
* :func:`latest_step` and :func:`all_steps` manage steps with plain files,
  and :class:`Checkpointer` keeps the last N.

Restored tensors go to the template's device with its dtype; a restored
optimizer is the template's kind with its hyperparameters, over the
restored tensors. Scene metadata is host state: persist it beside the
checkpoint with ``models/serialize.py``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "all_steps", "Checkpointer", "leaves", "structure"]

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _path_for(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def _children(node, prefix: str):
    """A named tuple's or dict's ``(dotted prefix, child)`` pairs."""
    if hasattr(node, "_fields"):
        return [(f"{prefix}{name}.", getattr(node, name)) for name in node._fields]
    if isinstance(node, dict):
        return [(f"{prefix}{key}.", child) for key, child in node.items()]
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at {prefix or 'the root'!r}")


def leaves(node, prefix: str = "", optimizers: bool = True) -> list:
    """``(name, tensor)`` of every tensor :func:`save` writes for the state
    ``node``, in tree order; with ``optimizers=False`` the state's own
    tensors only, without the optimizers' state."""
    if node is None:
        return []
    if isinstance(node, torch.Tensor):
        return [(prefix[:-1], node)]
    if isinstance(node, torch.optim.Optimizer):
        if not optimizers:
            return []
        return [(f"{prefix}state.{i}.{key}", torch.as_tensor(value))
                for i, state in sorted(node.state_dict()["state"].items())
                for key, value in state.items()]
    return [leaf for path, child in _children(node, prefix)
            for leaf in leaves(child, path, optimizers)]


def structure(state) -> list:
    """``[name, shape, dtype]`` of each tensor :func:`save` writes for
    ``state``: what :func:`restore` holds a checkpoint to."""
    return [[name, list(t.shape), str(t.dtype).replace("torch.", "")]
            for name, t in leaves(state)]


def save(directory: str, step: int, state: Any) -> str:
    """Atomically write ``state`` as ``step_<step>.npz`` in ``directory``;
    the file's path."""
    os.makedirs(directory, exist_ok=True)
    payload = {f"leaf_{i:05d}": t.detach().cpu().numpy()
               for i, (_, t) in enumerate(leaves(state))}
    header = json.dumps({"step": step, "structure": structure(state)})
    payload["__header__"] = np.frombuffer(header.encode(), np.uint8)
    final = _path_for(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final



def _rebuild(node, prefix: str, arrays: dict, fresh: dict):
    """``node`` with each of its tensors replaced by ``fresh[id(tensor)]``
    and each optimizer by one of its kind over those tensors, its state
    from ``arrays`` (by name)."""
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        return fresh[id(node)]
    if isinstance(node, torch.optim.Optimizer):
        groups = []
        for group in node.param_groups:
            if any(id(p) not in fresh for p in group["params"]):
                raise ValueError(f"{prefix[:-1]}: an optimizer's parameters must be tensors "
                                 "of the state it is saved with")
            groups.append({**{k: v for k, v in group.items() if k != "params"},
                           "params": [fresh[id(p)] for p in group["params"]]})
        opt = type(node)(groups, **node.defaults)
        saved = node.state_dict()
        saved["state"] = {i: {key: torch.from_numpy(arrays[f"{prefix}state.{i}.{key}"])
                              for key in state}
                          for i, state in saved["state"].items()}
        opt.load_state_dict(saved)  # the moments to their parameters' device and dtype
        return opt
    children = [_rebuild(child, path, arrays, fresh) for path, child in _children(node, prefix)]
    if isinstance(node, dict):
        return dict(zip(node, children))
    return type(node)(*children)


def restore(directory: str, template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load a checkpoint into the structure of ``template``; ``step=None``
    loads the latest. The stored structure must equal ``template``'s
    (:func:`structure`), else ``ValueError``. Returns ``(state, step)``,
    each tensor on its template tensor's device with its dtype (and
    requiring grad where it does)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    with np.load(_path_for(directory, step)) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        stored = header["structure"]
        arrays = {name: z[f"leaf_{i:05d}"] for i, (name, _, _) in enumerate(stored)}
    want = structure(template)
    if want != stored:
        raise ValueError("checkpoint structure mismatch:\n"
                         f"  stored:   {stored}\n  template: {want}")
    fresh = {}
    for name, t in leaves(template, optimizers=False):
        new = torch.from_numpy(arrays[name]).to(device=t.device, dtype=t.dtype)
        fresh[id(t)] = new.requires_grad_() if t.requires_grad else new
    return _rebuild(template, "", arrays, fresh), header["step"]


def all_steps(directory: str) -> list:
    """Sorted step numbers checkpointed under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


class Checkpointer:
    """Keep-last-N manager around :func:`save` and :func:`restore`.

    >>> ckpt = Checkpointer(run_dir, keep=3)
    >>> state, start = ckpt.restore_or(init_state)   # resume if possible
    >>> for step in range(start, n_steps):
    ...     state, loss = train_step(state, target)
    ...     if step % 100 == 0:
    ...         ckpt.save(step, state)
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, state: Any) -> str:
        path = save(self.directory, step, state)
        if self.keep:
            for old in all_steps(self.directory)[:-self.keep]:
                os.unlink(_path_for(self.directory, old))
        return path

    def restore_or(self, init_state: Any) -> Tuple[Any, int]:
        """Resume from the latest checkpoint as ``(state, step + 1)``, or
        return ``(init_state, 0)``."""
        step = latest_step(self.directory)
        if step is None:
            return init_state, 0
        state, step = restore(self.directory, init_state, step)
        return state, step + 1
