"""Command-line interface: the reference's flag surface (src/main.rs:32-93).

PyTorch counterpart of ``ray_rust_tpu/cli.py``. Renders the default scene,
or a scene file's (``-d``), to a PNG on ``--device`` (default ``cuda``), in
trace mode or, with ``-m``, in march mode with an optional glow strength
``-g``, through the hand-written kernels on a card (``--no-pallas``: the
plain PyTorch version); ``-s`` writes the scene to a file::

    python -m ray_rust_tpu_torch.cli 1920 1080 -o out.png
    python -m ray_rust_tpu_torch.cli 1280 720 -m -g 1.0 -o out.png
    python -m ray_rust_tpu_torch.cli 1920 1080 -d scene.yaml -s copy.yaml -o out.png

The default scene's floor takes ``bar.png`` from the working directory as its
texture when that file is an RGB PNG, as the reference does
(src/main.rs:169); a scene file's textures open from the working directory.
A file's depth caps apply, with the CLI's overrides on top. A file with a
``camera_motion`` renders its frames to ``{output}{i}.png``
(``animation.render_frames``), each written by the native frame-writer pool
of ``max(1, threads // 2)`` threads (``-t``; ``utils/native.FrameWriter``)
while the card renders the next; when the pool has finished, a frame not on
disk whole makes the CLI say how many and exit 1. ``-w`` serves the web viewer on port ``-p``
(``webserver.py``) instead of writing a file::

    python -m ray_rust_tpu_torch.cli 1920 1080 -w -p 3000
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import RenderConfig
from .models.scene import default_scene
from .models.serialize import deserialize_scene, serialize_scene
from .renderer import render_u8
from .utils.image import gradient_prefill, save_png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray-rust-tpu-torch",
        description="Differentiable ray tracer, PyTorch + CUDA port",
    )
    p.add_argument("width", type=int, help="Width of the image [px]")
    p.add_argument("height", type=int, help="Height of the image [px]")
    p.add_argument("-t", "--threads", type=int, default=8,
                   help="thread count: half of it write camera-motion frames")
    p.add_argument("-o", "--output", default="foo.png", help="Output file name")
    p.add_argument("-m", "--raymarch", action="store_true", help="Use ray marching")
    p.add_argument("-g", "--gloweffect", type=float, default=None,
                   help="Enable glow effect and set its strength (ray marching)")
    p.add_argument("-s", "--serialize_file", default=None,
                   help="File name for serialized scene output")
    p.add_argument("-d", "--deserialize_file", default=None,
                   help="File name for deserialized scene input")
    p.add_argument("-w", "--webserver", action="store_true",
                   help="Launch a web server that responds with rendered images")
    p.add_argument("-p", "--port_no", type=int, default=3000,
                   help="Port number, if use web server")
    p.add_argument("--refraction_unroll", type=int, default=None,
                   help="Refraction depth cap (default 4)")
    p.add_argument("--max_refractions", type=int, default=None,
                   help="Override the refraction depth cap")
    p.add_argument("--max_reflections", type=int, default=None,
                   help="Override the reflection depth cap")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--no-pallas", action="store_true",
                   help="Render through the plain PyTorch version (the hand-written "
                        "kernels are the default on a card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name in ("width", "height", "threads", "output"):
        print(f"Value for {name}: {getattr(args, name)}")

    if args.deserialize_file:
        with open(args.deserialize_file) as f:
            scene, meta, caps = deserialize_scene(f.read(), device=args.device)
    else:
        scene, meta = default_scene(device=args.device)
        caps = {}
    caps.update({k: getattr(args, k)
                 for k in ("max_refractions", "max_reflections", "refraction_unroll")
                 if getattr(args, k) is not None})
    cfg = RenderConfig(xres=args.width, yres=args.height, xfov=1.0,
                       yfov=args.height / args.width,  # main.rs:135-136
                       use_raymarching=args.raymarch, glow_effect=args.gloweffect,
                       use_pallas=False if args.no_pallas else None, **caps)
    if args.webserver:
        from .webserver import run_webserver

        run_webserver(scene, meta, cfg, args.port_no)
        return 0
    if args.serialize_file:
        with open(args.serialize_file, "w") as f:
            f.write(serialize_scene(scene, meta))

    start = time.time()
    if meta.camera_motion:
        from .animation import render_frames
        from .utils.native import FrameWriter

        with FrameWriter(n_threads=max(1, args.threads // 2)) as writer:
            render_frames(scene, meta, cfg,
                          lambda i, data: writer.submit(f"{args.output}{i}.png", data))
        errors = writer.close()  # counted once every thread has finished
        if errors:
            print(f"frame writer: {errors} failed writes", file=sys.stderr)
            return 1
    else:
        buf = gradient_prefill(args.width, args.height)
        buf[:, :] = render_u8(scene, cfg)
        save_png(args.output, buf)
    elapsed = time.time() - start
    print("Rendering time: %d.%06d" % (int(elapsed), int((elapsed % 1) * 1e6)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
