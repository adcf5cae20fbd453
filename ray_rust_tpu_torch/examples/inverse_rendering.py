"""Inverse rendering: recover scene parameters by gradient descent.

PyTorch counterpart of ``examples/inverse_rendering.py``: render a target
image of the default scene, move the red sphere (object 3) by (30, -25, 20)
and wash its material's diffuse colour to 0.4, then train the centres,
radii and diffuse colours with Adam (the global gradient norm clipped to
1.0; ``parallel.SceneAdam``) until the render matches the target,
with checkpoint and resume (``checkpoint.py``). On a CUDA scene each step
runs the pack kernel, K1 and the MSE forward, K2 and the pull-back
backward (``renderer.render_color``); on the CPU autograd of the plain
version.

    python -m ray_rust_tpu_torch.examples.inverse_rendering --size 320
    python -m ray_rust_tpu_torch.examples.inverse_rendering --steps 60 --size 64 --device cpu

Exit code 0 when the last step's loss is below 1e-2, as the JAX example's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import checkpoint
from ..config import RenderConfig
from ..models.scene import Scene, default_scene
from ..parallel.train import SceneAdam, TrainState, make_train_step
from ..renderer import render_color, render_u8
from ..utils.image import save_png

RED = 3  # the red sphere, object 3 of the default scene (src/main.rs:222)


def perturbed(scene: Scene, shift=(30.0, -25.0, 20.0)) -> Scene:
    """A copy of ``scene`` (its own tensors, which the optimizer may update
    in place) with the red sphere moved by ``shift`` and its material's
    diffuse colour washed to 0.4: the parameters the optimizer must
    recover."""
    scene = scene.with_tensors([t.clone() for t in scene.tensors()])
    for c, d in zip(scene.objects.org, shift):
        c[RED] += d
    for c in scene.materials.diffuse:
        c[int(scene.objects.mat[RED])] = 0.4
    return scene


def example_config(size: int) -> RenderConfig:
    """``size`` x 3/4 size; a shallow trace: inverse rendering needs smooth,
    well-conditioned gradients more than deep specular chains."""
    return RenderConfig(xres=size, yres=size * 3 // 4, max_reflections=2, refraction_unroll=1)


def problem(cfg: RenderConfig, device):
    """``(target_scene, target, scene0)``: the default scene, its
    ``(H, W, 3)`` render under ``cfg`` and the perturbed start."""
    target_scene, _ = default_scene(device=device)
    with torch.no_grad():
        target = render_color(target_scene, cfg).to_array()
    return target_scene, target, perturbed(target_scene)


def red_error(state: TrainState, target_scene: Scene) -> float:
    """``|dx_red|``: how far the red sphere's x is from the target's."""
    return abs(float(state.scene.objects.org.x[RED]) - float(target_scene.objects.org.x[RED]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--size", type=int, default=160, help="image width (height = 3/4)")
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--ckpt_dir", default=None, help="checkpoint/resume directory")
    p.add_argument("--ckpt_every", type=int, default=50)
    p.add_argument("--out", default=None, help="write before/after/target PNGs here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    cfg = example_config(args.size)
    target_scene, target, scene0 = problem(cfg, args.device)
    opt = SceneAdam(args.lr)
    step_fn = make_train_step(cfg, opt)
    state = TrainState(scene0, opt.init(scene0))
    start = 0
    ck = checkpoint.Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck:
        state, start = ck.restore_or(state)
        if start:
            print(f"resumed from step {start}")

    t0 = time.time()
    loss = None
    for step in range(start, args.steps):
        state, loss = step_fn(state, target)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}  |dx_red| "
                  f"{red_error(state, target_scene):.2f}", flush=True)
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save(step, state)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n = args.steps - start
    if n > 0:
        print(f"{n} steps in {dt:.1f}s ({dt / n * 1e3:.1f} ms/step)")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_png(f"{args.out}/target.png", render_u8(target_scene, cfg))
        save_png(f"{args.out}/initial.png", render_u8(scene0, cfg))
        save_png(f"{args.out}/optimized.png", render_u8(state.scene, cfg))
        print(f"wrote {args.out}/{{target,initial,optimized}}.png")

    return 0 if (loss is None or float(loss) < 1e-2) else 1


if __name__ == "__main__":
    sys.exit(main())
