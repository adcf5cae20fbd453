#!/usr/bin/env python3
"""How many fixed-point terms the port's backward kernels sum in one launch
on large frames, and what each launch's sum does with them, in the checkout
this is run from.

    cd <checkout> && python3 <path>/tools/terms_probe.py [--label NAME] [--out FILE]
        [--only SUBSTRING ...]

It imports ``ray_rust_tpu_torch`` from the working directory, so one copy
probes any checkout whose backward kernels sum in fixed point
(``csrc/fixed_sum.cuh``). Each case launches K2, K4 or K5 once through its
public wrapper on one seeded standard-normal cotangent and reads the
launch's ``rt_fixed_stats`` (``csrc/fixed_sum.cuh: last_fixed``): the
first scale, the scale taken, the runs, log2 of the nonzero terms rounded
up, the largest term's and the planes' exponent bounds, and, where the
checkout reports it, the lo digit's width (null on a checkout without it);
or the error a launch that raised named. A launch that raised, or that ran
twice with a lo digit narrower than 31 bits (its count past 2^32), is then
launched again as windows of whole rows (K2, K4: ``origin=``, ``shape=``),
twice as many until every window's count is at most 2^32: the windows'
log2 terms bound the frame's count, and on a checkout that returned the
frame's block, the float64 sum of the windows' blocks is held against it,
per scene leaf (relative L2, norm floor 1e-2, as ``chip_smoke.leaf_err``).
Every block that returned is launched a second time and compared bit for
bit, and its SHA-256 is given (``sha256``, the first 16 hex digits), so two
checkouts' blocks compare bit for bit. The cases: the box of six
transparent planes (42 reflections) at 320x240, 1920x1080 and 3840x2160
through K2 and K5; chip_smoke's 1 024-object field at 3840x2160 through
K2, and K4 at 2 000 and 10 000 steps; the glass cluster (39 laps) at
1280x720 and 3840x2160 and the default march at 3840x2160 through K4; the
main paths' shapes (K2 and K5 at 1920x1080, K4 at 1280x720) on the
default scene.

Prints one JSON line with the card's name and power limit, and appends it
to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

# chip_smoke.py beside this script's folder: its scenes, leaf_err and fixed_stats
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TERMS_LIMIT_BITS = 32  # the count a launch sums at the first run's digits (log2)


def past_limit(stats) -> bool:
    """Whether a returned launch summed more than 2^32 terms."""
    return stats["log2_terms"] > TERMS_LIMIT_BITS


def launch(torch, fn, lib):
    """``fn()`` once: (its table cotangents or None, ms by events, the
    error it raised or None, the stats)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        out = fn()
        err = None
    except RuntimeError as e:
        out, err = None, str(e)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), err, (None if err else chip_smoke.fixed_stats(lib))


def probe(torch, rtt, name, kind, scene, cfg, seed) -> dict:
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    dev = torch.device("cuda", 0)
    n = scene.objects.count
    rng = np.random.default_rng(seed)
    g = rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                     .astype(np.float32)).to(dev) for _ in range(3)))
    if kind == "K5":
        lib_name = "trace_retrace"
    elif kind == "K4":
        lib_name = ("march_bwd_buf" if kmb.buffered(cfg)
                    else kt.library("march_bwd", n, kb.SHARED_TABLE_MAX))
    else:
        lib_name = kt.library("trace_bwd", n, kb.SHARED_TABLE_MAX)
    lib = _build.load_cuda_library(lib_name)

    def run(origin=(0, 0), shape=None):
        r0, rows = origin[0], (shape or (cfg.yres,))[0]
        gw = rtt.Color(*(c[r0:r0 + rows].contiguous() for c in g))
        if kind == "K5":
            return lambda: kr.render_grads_retrace(scene, cfg, g)
        mod = kmb if kind == "K4" else kb
        return lambda: mod.render_grads_kernel(scene, cfg, gw, origin=origin, shape=shape)

    block, ms, err, stats = launch(torch, run(), lib)
    out = {"kernel": kind, "library": lib_name, "shape": [cfg.xres, cfg.yres],
           "objects": n, "ms": ms, "raised": err, "fixed": stats}
    print(f"  {name}: {ms:.1f} ms, raised {err!r}, {stats}", flush=True)
    if block is not None:
        out["sha256"] = hashlib.sha256(b"".join(
            t.detach().cpu().numpy().tobytes() for t in block)).hexdigest()[:16]
        again, ms2, _, _ = launch(torch, run(), lib)
        out["second_ms"] = ms2
        out["bit_equal"] = again is not None and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(block, again))
        print(f"    a second launch: bit-equal {out['bit_equal']} ({ms2:.1f} ms)", flush=True)
        del again
    if kind == "K5" or (err is None and not past_limit(stats)):
        return out
    nb = 4
    while nb <= cfg.yres:
        bands = chip_smoke.partition(cfg.yres, nb)
        rows, total, ok = [], None, True
        for r0, h in bands:
            b, bms, berr, bst = launch(torch, run((r0, 0), (h, cfg.xres)), lib)
            rows.append({"row0": r0, "rows": h, "ms": bms, "raised": berr, "fixed": bst})
            if berr is not None or past_limit(bst):
                ok = False
                break
            total = ([t.double() for t in b] if total is None
                     else [s + t.double() for s, t in zip(total, b)])
        if ok:
            break
        nb *= 2
    out["bands"] = rows
    logs = [r["fixed"]["log2_terms"] for r in rows]
    out["bands_log2_terms_bound"] = float(np.log2(sum(2.0 ** k for k in logs)))
    print(f"    in {len(rows)} windows of rows: log2 terms {logs} (the frame's count at most "
          f"2^{out['bands_log2_terms_bound']:.2f})", flush=True)
    if block is not None:
        worst, leaf = chip_smoke.leaf_err(name, scene, block, [t.float() for t in total])
        out["banded_f64_rel_l2"], out["banded_f64_leaf"] = worst, leaf
        print(f"    against the float64 sum of the windows' blocks: largest leaf relative L2 "
              f"{worst:.3g} ({leaf})", flush=True)
    return out


def cases(rtt):
    """name -> (kernel, scene, cfg)."""
    box, cluster = chip_smoke.box_scene(rtt), chip_smoke.glass_cluster(rtt)
    default = rtt.default_scene()[0]
    field = chip_smoke.spheres_scene(rtt, 11, 1023)
    field_glow = chip_smoke.spheres_scene(rtt, 11, 1023, glow_dist=3.0)
    march = dict(use_raymarching=True, glow_effect=1.0)
    out = {}
    for kind in ("K2", "K5"):
        for w, h in ((320, 240), (1920, 1080), (3840, 2160)):
            out[f"{kind} box {w}x{h}"] = (kind, box, rtt.RenderConfig(xres=w, yres=h,
                                                                       max_reflections=42))
    out["K2 1024 objects 3840x2160"] = ("K2", field, rtt.RenderConfig(xres=3840, yres=2160))
    for steps in (2000, 10000):
        out[f"K4 1024 objects 3840x2160 {steps} steps"] = (
            "K4", field_glow, rtt.RenderConfig(xres=3840, yres=2160, march_max_iter=steps,
                                               **march))
    for w, h in ((1280, 720), (3840, 2160)):
        out[f"K4 glass cluster {w}x{h}"] = ("K4", cluster, rtt.RenderConfig(
            xres=w, yres=h, raymarch_max_reflections=7, **march))
    out["K4 default 3840x2160"] = ("K4", default, rtt.RenderConfig(xres=3840, yres=2160,
                                                                   **march))
    out["K2 default 1920x1080"] = ("K2", default, rtt.RenderConfig(xres=1920, yres=1080))
    out["K5 default 1920x1080"] = ("K5", default, rtt.RenderConfig(xres=1920, yres=1080))
    out["K4 default 1280x720"] = ("K4", default, rtt.RenderConfig(xres=1280, yres=720, **march))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--out")
    ap.add_argument("--only", nargs="*", help="the cases whose names hold any of these")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("terms_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = smi.strip().splitlines()[0] if smi.strip() else torch.cuda.get_device_name(0)
    print(card, flush=True)
    t0 = time.time()
    _build.prebuild(["pack_scene", "trace_bwd", "trace_bwd_global", "trace_retrace",
                     "march_bwd", "march_bwd_global", "march_bwd_buf"])
    result = {"label": args.label, "card": card, "build_s": round(time.time() - t0, 1),
              "cases": {}}
    dev = torch.device("cuda", 0)
    for k, (name, (kind, scene, cfg)) in enumerate(cases(rtt).items()):
        if args.only and not any(s in name for s in args.only):
            continue
        try:
            result["cases"][name] = probe(torch, rtt, name, kind, scene.to(dev), cfg, k)
        except Exception as e:  # noqa: BLE001 (recorded, the probe goes on)
            result["cases"][name] = {"error": repr(e)}
            print(f"  {name}: {e!r}", flush=True)
        torch.cuda.empty_cache()
    result["seconds"] = round(time.time() - t0, 1)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
