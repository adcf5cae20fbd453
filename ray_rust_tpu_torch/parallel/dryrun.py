"""Multi-device dry run: a sharded forward render and one sharded training
step on a ``(dp, sp)`` mesh.

PyTorch counterpart of ``ray_rust_tpu/parallel/dryrun.py``, called by
``entry.dryrun_multichip``. The JAX run's kernel leg (``shard_map`` and the
Pallas kernel in interpret mode against the jnp path) becomes a check of the
kernels themselves: on the card the sharded render, K1 launched on every
cell's window, equals the whole frame's launch bit for bit (on the CPU the
windowed plain version equals the whole plain frame).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["card_devices", "run"]


def card_devices(n_devices: int) -> list:
    """``n_devices`` mesh cells on the cards: one a card where there are as
    many, else every cell on card 0. RuntimeError where there is no card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device: pass devices (e.g. [torch.device('cpu')] * n)")
    if count >= n_devices:
        return [torch.device("cuda", k) for k in range(n_devices)]
    return [torch.device("cuda", 0)] * n_devices


def run(n_devices: int, devices=None) -> None:
    """Build a mesh of ``n_devices`` cells on ``devices`` (by default
    :func:`card_devices`), ``sp = 2`` where ``n_devices`` is even, render
    the default scene sharded over it and take one SGD step on every float
    leaf; raises AssertionError where a check fails."""
    from .. import RenderConfig, default_scene, render_color
    from .shard import make_mesh, render_sharded
    from .train import sgd_train_step

    devices = card_devices(n_devices) if devices is None else list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise AssertionError(f"need {n_devices} devices, have {len(devices)} ({devices})")
    sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(devices, dp=n_devices // sp, sp=sp)

    H = 8 * mesh.shape["dp"]
    W = 16 * mesh.shape["sp"]
    # the JAX run's shallow depths, which change nothing of the sharding
    cfg = RenderConfig(xres=W, yres=H, max_reflections=2, max_refractions=1, refraction_unroll=1)
    scene, _ = default_scene(device=devices[0])

    with torch.no_grad():
        img = render_sharded(scene, cfg, mesh)
        whole = render_color(scene, cfg)
    for a, b in zip(img, whole):
        if not torch.equal(a.to(b.device), b):
            raise AssertionError("the sharded render is not the whole frame's bit for bit "
                                 f"({int((a.to(b.device) != b).sum())} values differ)")

    target = torch.zeros((H, W, 3), dtype=torch.float32, device=devices[0])
    trained = scene.with_tensors([t.detach().clone().requires_grad_() if t.is_floating_point()
                                  else t for t in scene.tensors()])
    new_scene, loss = sgd_train_step(trained, cfg, target, lr=1e-3, mesh=mesh)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    moved = float((new_scene.objects.org.x - scene.objects.org.x).detach().abs().max())
    if not np.isfinite(moved):
        raise AssertionError(f"non-finite step {moved}")

    print(f"dryrun_multichip ok: mesh {dict(mesh.shape)}, image {H}x{W}, "
          f"loss {float(loss):.5f}")
