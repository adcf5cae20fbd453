"""Weak-scaling harness.

PyTorch counterpart of ``ray_rust_tpu/parallel/scaling.py``. It times the
same per-device workload at growing mesh sizes (weak scaling: the image
grows with the mesh, ``H = rows_per_device * n`` over an ``(n, 1)`` mesh),
so perfect scaling is a constant time and

    efficiency(n) = t(1 device) / t(n devices).

Each size times the sharded forward render (``shard.render_sharded``) and,
with ``train``, one sharded SGD step on every float leaf
(``train.sgd_train_step(..., mesh=)``), the best of ``iters`` calls after
one untimed call: by CUDA events on a card, by the host's clock on the CPU.
On the card::

    python -m ray_rust_tpu_torch.parallel.scaling

Cells that repeat one device (``devices=[cuda:0] * 2``, or ``[cpu] * 2`` in
the tests) share it, so their efficiency measures the mesh's overhead on
one device, not scaling.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import default_scene
from .shard import make_mesh, render_sharded
from .train import sgd_train_step

__all__ = ["measure_scaling", "format_report"]


def _time_best(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Best-of-``iters`` time of ``fn`` in seconds (the first call excluded
    by the caller): CUDA events on ``device``'s current stream for a card,
    the host's clock otherwise."""
    best = np.inf
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def measure_scaling(
    device_counts: Optional[List[int]] = None,
    rows_per_device: int = 128,
    width: int = 256,
    cfg: Optional[RenderConfig] = None,
    train: bool = True,
    iters: int = 3,
    devices=None,
) -> List[Dict]:
    """Weak-scaling sweep over growing device meshes.

    For each n in ``device_counts`` (default: 1, 2, 4, ... up to the count
    of ``devices``, which default to every CUDA device; RuntimeError where
    there is none) renders an ``(n * rows_per_device, width)`` image sharded
    over an ``(n, 1)`` mesh of the first n devices, and optionally runs one
    full fwd+bwd training step. Returns a list of dicts with per-n times and
    efficiencies, the JAX harness's keys.
    """
    if devices is None:
        devices = [row[0] for row in make_mesh().devices]  # every CUDA device
    devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = []
        n = 1
        while n <= len(devices):
            device_counts.append(n)
            n *= 2
    scene, _ = default_scene(device=devices[0])
    # the JAX step trains every float leaf
    trained = scene.with_tensors([t.detach().clone().requires_grad_() if t.is_floating_point()
                                  else t for t in scene.tensors()])

    results: List[Dict] = []
    for n in device_counts:
        if n > len(devices):
            break
        mesh = make_mesh(devices[:n], dp=n, sp=1)
        h = rows_per_device * n
        c = (cfg or RenderConfig()).with_(xres=width, yres=h)

        def fwd():
            with torch.no_grad():
                return render_sharded(scene, c, mesh)

        fwd()  # the first call: the kernels' builds and loads
        t_fwd = _time_best(fwd, iters, devices[0])
        entry: Dict = {
            "devices": n,
            "image": (h, width),
            "fwd_s": t_fwd,
            "fwd_rays_per_s_per_device": h * width / t_fwd / n,
        }
        if train:
            target = torch.zeros((h, width, 3), dtype=torch.float32, device=devices[0])
            step = lambda: sgd_train_step(trained, c, target, lr=1e-3, mesh=mesh)  # noqa: E731
            step()
            entry["step_s"] = _time_best(step, iters, devices[0])
        results.append(entry)

    base = results[0]
    for r in results:
        r["fwd_efficiency"] = base["fwd_s"] / r["fwd_s"]
        if train and "step_s" in r:
            r["step_efficiency"] = base["step_s"] / r["step_s"]
    return results


def format_report(results: List[Dict]) -> str:
    """The JAX harness's table, line for line."""
    lines = [
        f"{'devices':>8} {'image':>12} {'fwd ms':>9} {'fwd eff':>8} "
        f"{'step ms':>9} {'step eff':>9}"
    ]
    for r in results:
        step_ms = f"{r['step_s'] * 1e3:9.1f}" if "step_s" in r else " " * 9
        step_eff = (
            f"{r['step_efficiency'] * 100:8.1f}%" if "step_efficiency" in r else " " * 9
        )
        lines.append(
            f"{r['devices']:>8} {str(r['image']):>12} {r['fwd_s'] * 1e3:9.1f} "
            f"{r['fwd_efficiency'] * 100:7.1f}% {step_ms} {step_eff}"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_report(measure_scaling()))
