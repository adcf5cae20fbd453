#!/usr/bin/env python3
"""Time the port's kernels in the checkout this is run from, to compare two
checkouts on one card.

    cd <checkout> && python3 <path>/tools/kernel_times.py [--label NAME] [--out FILE]

It imports ``ray_rust_tpu_torch`` from the working directory, not from
beside this script, so one copy times any checkout of the port, older ones
too; it times with ``chip_smoke.cuda_ms`` from beside this script's folder
(CUDA events, 3 warm-ups, 10 calls each). On the default scene it times
the trace kernel (K1) per 1920x1080 frame, the trace backward (K2) and the
re-trace oracle (K5) per 1920x1080 cotangent, and the march kernel (K3)
and the march backward (K4) at 1280x720 with glow 1.0, through their
public wrappers; both march kernels also with ``march_floor_skip`` off
where the checkout's config has it. Prints one JSON line with the card's
name and power limit, and appends it to ``--out`` if given. Run two
checkouts in turns (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

# the timing loop of chip_smoke.py beside this script's folder
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--out", help="a JSON-lines file to append the line to")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    _build.prebuild(["trace_fwd", "march_fwd", "trace_bwd", "march_bwd", "trace_retrace"])
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=1920, yres=1080)
    mcfg = rtt.RenderConfig(xres=1280, yres=720, use_raymarching=True, glow_effect=1.0)
    rng = np.random.default_rng(0)

    def planes(c):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((c.yres, c.xres))
                                            .astype(np.float32)).cuda() for _ in range(3)))

    def ms(fn):
        return chip_smoke.cuda_ms(torch, fn)

    g, gm = planes(cfg), planes(mcfg)
    march = [("", mcfg)]
    if hasattr(mcfg, "march_floor_skip"):
        march.append((" floor tail off", mcfg.with_(march_floor_skip=False)))
    times = {}
    with torch.no_grad():
        times["K1 1920x1080"] = ms(lambda: kt.render_color_kernel(scene, cfg))
        for tag, c in march:
            times[f"K3 1280x720{tag}"] = ms(lambda c=c: km.render_color_kernel(scene, c))
    times["K2 1920x1080"] = ms(lambda: kb.render_grads_kernel(scene, cfg, g, return_primal=True))
    times["K5 1920x1080"] = ms(lambda: kr.render_grads_retrace(scene, cfg, g, return_primal=True))
    for tag, c in march:
        times[f"K4 1280x720{tag}"] = ms(lambda c=c: kmb.render_grads_kernel(scene, c, gm,
                                                                            return_primal=True))
    line = json.dumps({"label": args.label, "card": card, "ms": times})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
