#!/usr/bin/env python3
"""Whether the port's backward kernels and its training repeat themselves on
the card, bit for bit, in the checkout this is run from.

    cd <checkout> && python3 <path>/tools/repeat_probe.py [--label NAME] [--out FILE]
        [--launches 10] [--steps 20]

It imports ``ray_rust_tpu_torch`` from the working directory, so one copy
probes any checkout of the port. On one state it launches the trace
backward (K2) at 1920x1080 and the re-trace oracle (K5) at 1920x1080 on
the default scene, the march backward (K4) at 1280x720 with glow 1.0, and
K2 and K4 on chip_smoke's 1 024-sphere field at 160x120 (their
global-table builds), each ``--launches`` times on one seeded cotangent
(uniform in [-1, 1]), and gives for each the entries of the (n+1, 20)
tables that differ from the first launch in any later one and the largest
difference over the larger magnitude of the two entries, and (on a checkout
whose backward kernels sum in fixed point) the last launch's scale,
counts and lo digit width. Then, under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set before torch is imported), two twins of one
state take ``--steps`` steps each: ``sgd_train_step`` at 1920x1080 on the
material colours of the default scene against a target with the red
material 0.1 redder (chip_smoke.py's training), and the inverse-rendering
example's Adam step at 320x240 after 10 steps of its own; for each, the
first step whose losses differ (or null), the largest difference of the
losses, and whether the trained leaves are equal at the end. A failure of
a phase (a torch operation without a deterministic implementation raises)
is recorded under its name.

``--profile`` gives instead each kernel's, copy's and set's device time a
launch of each of those backward cases (torch.profiler, 5 launches).

Prints one JSON line with the card's name and power limit, and appends it
to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

# chip_smoke.py beside this script's folder: its sphere field
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def tables_diff(runs) -> dict:
    """How far the later launches' tables lie from the first's: entries
    that differ in any launch, of all entries, and the largest difference
    over the larger magnitude."""
    first = [t.detach().double().cpu() for t in runs[0]]
    entries = sum(t.numel() for t in first)
    differ, worst = 0, 0.0
    for run in runs[1:]:
        for a, b in zip(first, (t.detach().double().cpu() for t in run)):
            d = (a - b).abs()
            both_nan = a.isnan() & b.isnan()
            bad = (d > 0) | (a.isnan() != b.isnan())
            bad &= ~both_nan
            differ = max(differ, int(bad.sum()))
            scale = np.maximum(a.abs().numpy(), b.abs().numpy())
            with np.errstate(invalid="ignore", divide="ignore"):
                rel = np.where(bad.numpy(), d.numpy() / np.maximum(scale, 1e-30), 0.0)
            worst = max(worst, float(np.nan_to_num(rel, nan=np.inf).max()))
    return {"entries": entries, "differ": differ, "max_rel": worst}


def fixed_stats(lib_name) -> dict:
    """The last launch's fixed-point scale, counts and split of CUDA library
    ``lib_name`` (``chip_smoke.fixed_stats``), on a checkout whose backward
    kernels sum in fixed point; else {}."""
    from ray_rust_tpu_torch.ops import _build

    lib = _build.load_cuda_library(lib_name)
    return chip_smoke.fixed_stats(lib) if hasattr(lib, "rt_fixed_stats") else {}


def repeat_launches(torch, name, fn, launches, lib_name) -> dict:
    runs = [fn() for _ in range(launches)]
    torch.cuda.synchronize()
    out = {"launches": launches, **tables_diff(runs), "fixed": fixed_stats(lib_name)}
    print(f"  {name}: {out}", flush=True)
    return out


def device_times(torch, fn, reps=5) -> dict:
    """The card's time (ms a launch) of each kernel, copy and set that
    ``reps`` calls of ``fn`` (after one) make, by name, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key[:60]] = round(t / 1e3 / reps, 4)
    return out


def twins(torch, step, state, steps, leaves_of) -> dict:
    """Two deep copies of ``state`` take ``steps`` steps of ``step``; the
    losses and the end leaves compared."""
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    la, lb = [], []
    for _ in range(steps):
        a, loss_a = step(a)
        b, loss_b = step(b)
        la.append(float(loss_a))
        lb.append(float(loss_b))
    parted = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y), None)
    same = all(torch.equal(x, y) for x, y in zip(leaves_of(a), leaves_of(b)))
    return {"steps": steps, "parted_at": parted,
            "max_loss_diff": max(abs(x - y) for x, y in zip(la, lb)),
            "leaves_equal": same, "losses": la}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--out")
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="only the device time of each kernel, copy and set of 5 launches of "
                         "each backward (torch.profiler), by name")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    if not torch.cuda.is_available():
        print("repeat_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = smi.strip().splitlines()[0] if smi.strip() else torch.cuda.get_device_name(0)
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    result = {"label": args.label, "card": card}
    t0 = time.time()
    from ray_rust_tpu_torch.ops import _build

    _build.prebuild(["trace_fwd", "pack_scene", "trace_bwd", "trace_retrace", "march_fwd",
                     "march_bwd", "trace_bwd_global", "march_fwd_global", "march_bwd_global"])
    result["build_s"] = round(time.time() - t0, 1)

    scene = rtt.default_scene(device=dev)[0]
    field = chip_smoke.spheres_scene(rtt, 11, 1023, glow_dist=3.0).to(dev)

    def planes(cfg, seed):
        rng = np.random.default_rng(seed)
        return rtt.Color(*(torch.from_numpy(rng.uniform(-1, 1, (cfg.yres, cfg.xres))
                                            .astype(np.float32)).to(dev) for _ in range(3)))

    trace = rtt.RenderConfig(xres=1920, yres=1080)
    march = rtt.RenderConfig(xres=1280, yres=720, use_raymarching=True, glow_effect=1.0)
    small = rtt.RenderConfig(xres=160, yres=120)
    small_march = rtt.RenderConfig(xres=160, yres=120, use_raymarching=True, glow_effect=1.0,
                                   march_max_iter=2000)
    cases = {  # name: (function, its library)
        "K2 1920x1080": (lambda: kb.render_grads_kernel(scene, trace, g_trace), "trace_bwd"),
        "K5 1920x1080": (lambda: kr.render_grads_retrace(scene, trace, g_trace),
                         "trace_retrace"),
        "K4 1280x720": (lambda: kmb.render_grads_kernel(scene, march, g_march), "march_bwd"),
        "K2 1024 objects 160x120": (lambda: kb.render_grads_kernel(field, small, g_small),
                                    "trace_bwd_global"),
        "K4 1024 objects 160x120": (lambda: kmb.render_grads_kernel(field, small_march, g_small),
                                    "march_bwd_global"),
    }
    g_trace, g_march, g_small = planes(trace, 0), planes(march, 1), planes(small, 2)
    if args.profile:
        result["profile"] = {name: device_times(torch, fn) for name, (fn, _) in cases.items()}
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return 0
    result["kernels"] = {}
    for name, (fn, lib_name) in cases.items():
        try:
            result["kernels"][name] = repeat_launches(torch, name, fn, args.launches, lib_name)
        except Exception as e:  # noqa: BLE001 (recorded, the probe goes on)
            result["kernels"][name] = {"error": repr(e)}
            print(f"  {name}: {e!r}", flush=True)

    torch.use_deterministic_algorithms(True)
    from ray_rust_tpu_torch.examples import inverse_rendering as example
    from ray_rust_tpu_torch.parallel import SceneAdam, TrainState, make_train_step, sgd_train_step

    m = scene.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = rtt.render_color(scene._replace(materials=m._replace(
            diffuse=m.diffuse._replace(r=red))), trace).to_array()

    def grad(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    start = scene._replace(materials=m._replace(diffuse=grad(m.diffuse),
                                                specular=grad(m.specular)))

    def sgd(s):
        return sgd_train_step(s, trace, target, lr=chip_smoke.TRAIN_LR)

    def trained(s):
        return [t for t in s.tensors() if t.requires_grad]

    result["twins"] = {}
    try:
        result["twins"]["sgd 1920x1080"] = twins(torch, sgd, start, args.steps, trained)
    except Exception as e:  # noqa: BLE001
        result["twins"]["sgd 1920x1080"] = {"error": repr(e)}
    print(f"  sgd twins: {result['twins']['sgd 1920x1080']}", flush=True)
    try:
        cfg = example.example_config(chip_smoke.EXAMPLE_SIZE)
        _, ex_target, s0 = example.problem(cfg, dev)
        opt = SceneAdam(0.5)
        step = make_train_step(cfg, opt)
        state = TrainState(s0, opt.init(s0))
        for _ in range(10):
            state, _ = step(state, ex_target)
        result["twins"]["adam 320x240"] = twins(
            torch, lambda st: step(st, ex_target), state, args.steps,
            lambda st: list(st.scene.tensors()))
    except Exception as e:  # noqa: BLE001
        result["twins"]["adam 320x240"] = {"error": repr(e)}
    print(f"  adam twins: {result['twins']['adam 320x240']}", flush=True)
    result["seconds"] = round(time.time() - t0, 1)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
