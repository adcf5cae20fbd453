"""Multi-process rendering over ``torch.distributed``.

PyTorch counterpart of ``ray_rust_tpu/parallel/multihost.py``. The
reference's only gather is an intra-process mpsc channel funneling scanline
buffers to the main thread (src/render.rs:846,861-886). Here every process
(rank) renders the cells of a global mesh that lie on its own devices, and
the frame is gathered only when it is written out.

Usage, one process per card (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``, or the arguments)::

    from ray_rust_tpu_torch.parallel import multihost, sgd_train_step
    multihost.init_distributed()            # False, and nothing done, in one process
    mesh = multihost.global_mesh()          # (dp, sp) over every rank's device
    img = multihost.render_multihost(scene, cfg, mesh)   # (H, W, 3) on every rank
    # a training step: each rank its cells' loss and gradient, then one
    # all_reduce of the trained leaves' gradients and the loss (train.py);
    # every rank holds the same scene, leaves and (H, W, 3) target
    scene, loss = sgd_train_step(scene, cfg, target, lr=1e-3, mesh=mesh)

run as ``torchrun --nproc_per_node=N script.py`` (N cards, NCCL), or with
``init_distributed(backend="gloo")`` for two ranks on one card.

The backend is named, never guessed after a failure: NCCL where each rank
holds its own card (the default where CUDA is available), gloo where the
caller asks for it: CPU ranks, or two ranks on one card, which NCCL
refuses. Gloo's collectives take CPU tensors, so under gloo the gather goes
through host copies.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.scene import Scene
from .shard import Mesh, cell_shape, process_rank, render_sharded, render_tiles

__all__ = ["init_distributed", "is_primary", "world_size", "local_device", "global_mesh",
           "render_multihost"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> bool:
    """Join the default process group; returns whether it spans more than
    one process.

    ``coordinator_address`` (``host:port``, or a ``tcp://`` URL) defaults to
    ``MASTER_ADDR`` and ``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``
    and ``process_id`` to ``RANK``. With no coordinator anywhere it does
    nothing, as the JAX package's does: the same program runs in one process
    on a laptop's CPU, on one card, or on many. ``backend`` defaults to
    ``nccl`` where CUDA is available (each rank then takes its card,
    :func:`local_device`); elsewhere the caller names one (``gloo``). A
    backend that fails raises; none is swapped for another. ``timeout``
    (seconds; torch's default where None) bounds how long a collective waits
    for the other ranks before it raises.
    """
    if dist.is_initialized():
        return world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not coordinator_address:
        return False
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    if backend is None:
        if not torch.cuda.is_available():
            raise ValueError("init_distributed: no CUDA device for nccl; name a backend "
                             "(backend='gloo')")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device(process_id))
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kw)
    return True


def world_size() -> int:
    """The processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """Whether this process is rank 0 (the only one, without a group)."""
    return process_rank() == 0


def local_device(rank: Optional[int] = None) -> torch.device:
    """The device a rank renders on: CUDA device ``LOCAL_RANK`` (else the
    rank) modulo the card count, so that two ranks on one card share it;
    the CPU where there is no card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    rank = int(os.environ.get("LOCAL_RANK", process_rank() if rank is None else rank))
    return torch.device("cuda", rank % torch.cuda.device_count())


def global_mesh(dp: Optional[int] = None, sp: int = 1, devices=None) -> Mesh:
    """``(dp, sp)`` mesh over every rank's local devices (``devices``, as
    many on every rank; by default :func:`local_device`): rank 0's cells,
    then rank 1's, and so on, row-major. Every rank builds the same mesh and
    renders its own cells."""
    local = [local_device()] if devices is None else list(devices)
    n = world_size()
    devs = [d for _ in range(n) for d in local]
    ranks = [r for r in range(n) for _ in local]
    if dp is None:
        dp = len(devs) // sp
    return Mesh(devs, dp, sp, ranks)


def render_multihost(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> np.ndarray:
    """Render sharded over the global mesh, each rank its own cells, and
    gather the full ``(H, W, 3)`` float image to every rank as numpy (cheap
    for frames; ranks other than 0 may drop it). Only the gather
    communicates: rays are independent. Every rank must hold as many cells
    as every other."""
    with torch.no_grad():
        if not mesh.multiprocess:
            return render_sharded(scene, cfg, mesh).to_array().cpu().numpy()
        h, w = cell_shape(cfg.yres, cfg, mesh)
        by_rank = {}
        for i, j, _, r in mesh.cells():
            by_rank.setdefault(r, []).append((i, j))
        if sorted(by_rank) != list(range(world_size())) or len(
                {len(v) for v in by_rank.values()}) != 1:
            raise ValueError("render_multihost: every rank of the group must hold as many "
                             f"cells: { {r: len(v) for r, v in by_rank.items()} }")
        tiles = render_tiles(scene, cfg, mesh)  # in mesh order, as by_rank lists them
        dev = tiles[0].color.r.device
        mine = torch.stack([torch.stack([c.to(dev) for c in t.color]) for t in tiles])
        if dist.get_backend() != "nccl":  # gloo: collectives on host tensors
            mine = mine.cpu()
        parts = [torch.empty_like(mine) for _ in range(world_size())]
        dist.all_gather(parts, mine)
    img = np.empty((cfg.yres, cfg.xres, 3), np.float32)
    for r, ijs in by_rank.items():
        for (i, j), part in zip(ijs, parts[r].cpu().numpy()):
            img[i * h:(i + 1) * h, j * w:(j + 1) * w] = part.transpose(1, 2, 0)
    return img
