"""Entry points: a forward render of the flagship path and the
multi-device dry run.

PyTorch counterparts of ``entry`` and ``dryrun_multichip`` in the repository
root's ``__graft_entry__.py`` (the JAX package's). Both run on the card
unless the caller names another device. The JAX entry's re-run in a clean
subprocess works around JAX's platform lock and has no counterpart: torch
takes the devices it is given. On the card::

    python -m ray_rust_tpu_torch.entry
"""

from __future__ import annotations

import torch

from .config import RenderConfig
from .models.scene import default_scene
from .parallel.dryrun import run
from .renderer import render_color

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """``(fn, example_args)``: the forward render of the flagship path
    (default scene, Whitted trace, full reference depths) at 128x96, the
    scene on ``device`` (the card by default)."""
    scene, _ = default_scene(device="cuda" if device is None else device)
    cfg = RenderConfig(xres=128, yres=96)

    def fn(scene):
        return render_color(scene, cfg)

    return fn, (scene,)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """A mesh of ``n_devices`` cells, a sharded forward render and one full
    sharded training step (``parallel/dryrun.py``): on the cards, one a cell
    where there are as many and else every cell on card 0, or every cell on
    ``device``."""
    run(n_devices, None if device is None else [torch.device(device)] * n_devices)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", [tuple(c.shape) for c in out])
    dryrun_multichip(8)
