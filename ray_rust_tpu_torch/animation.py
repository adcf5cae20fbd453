"""Camera keyframe animation.

PyTorch counterpart of ``ray_rust_tpu/animation.py``: ``render_frames`` and
the Hermite interpolation of the reference (src/render.rs:902-989). The
camera path is interpolated on the host; each frame replaces only the
camera's tensors, on the scene's device, and renders through
:func:`~.renderer.render_u8`.
"""

from __future__ import annotations

import numpy as np

from .config import RenderConfig
from .models.quat import Quat
from .models.scene import Scene, SceneMeta
from .models.vec import v3
from .renderer import render_u8

__all__ = ["FRAME_STEP", "hermite_interpolate_f32", "hermite_interpolate", "look_at_rotation",
           "render_frames"]

FRAME_STEP = 0.5  # frames per keyframe = duration / 0.5 (render.rs:941)


def hermite_interpolate_f32(t, x0, x1, v0, v1):
    """Cubic Hermite with unit span, in f32 (render.rs:907-916)."""
    t, x0, x1, v0, v1 = (np.float32(v) for v in (t, x0, x1, v0, v1))
    h = np.float32(1.0)
    d = x0
    c = v0
    r = x1 - x0 - h * v0
    s = v1 - v0
    a = (h * s - np.float32(2.0) * r) / h / h / h
    b = (-h * s + np.float32(3.0) * r) / h / h
    return a * t * t * t + b * t * t + c * t + d


def hermite_interpolate(t, x0, x1, v0, v1):
    """Per-component Hermite on 3-vectors (render.rs:918-924); host floats."""
    return tuple(float(hermite_interpolate_f32(t, x0[i], x1[i], v0[i], v1[i])) for i in range(3))


def look_at_rotation(camera_pos, target) -> Quat:
    """Look-at quaternion (render.rs:961-967): pitch and yaw from the delta,
    with the reference's axis convention; host tensors."""
    dx = target[0] - camera_pos[0]
    dy = target[1] - camera_pos[1]
    dz = target[2] - camera_pos[2]
    pitch = float(np.arctan2(dy, np.sqrt(dx * dx + dz * dz)))
    yaw = float(-np.arctan2(dz, dx))
    return (Quat.rotation(yaw, 0.0, 1.0, 0.0)
            * Quat.rotation(pitch, 0.0, 0.0, 1.0)
            * Quat.rotation(-np.pi / 2.0, 1.0, 0.0, 0.0))


def _on(q: Quat, device) -> Quat:
    return Quat(*(c.to(device) for c in q))


def render_frames(scene: Scene, meta: SceneMeta, cfg: RenderConfig, frame_proc) -> int:
    """Render the keyframed camera path of ``meta.camera_motion``, calling
    ``frame_proc(i, u8_image)`` for each frame (render.rs:926-989). Returns
    the frame count."""
    dev = scene.device
    motion = meta.camera_motion
    prev_pos = tuple(float(c) for c in scene.camera.position)
    prev_rot = scene.camera.rotation
    prev_velocity = (0.0, 0.0, 0.0)
    total = sum(kf.duration for kf in motion)
    accum = 0
    for kn, kf in enumerate(motion):
        v0 = prev_velocity
        v1 = kf.velocity
        kf_pos = tuple(float(c) for c in kf.camera.position)
        kf_rot = _on(kf.camera.rotation, dev)
        nframes = int(kf.duration / FRAME_STEP)
        print(f"keyframe {kn} / {len(motion)}, v0: {v0[0]},{v0[1]},{v0[2]}")
        for i in range(nframes):
            f = i / (kf.duration / FRAME_STEP)
            print(f"Rendering frame {accum} / {total}, v0: {v0[0]},{v0[1]}")
            pos = hermite_interpolate(f, prev_pos, kf_pos, v0, v1)
            if kf.camera_target is not None:
                rot = _on(look_at_rotation(pos, kf.camera_target), dev)
            else:
                rot = prev_rot.slerp(kf_rot, f)
            frame = scene._replace(
                camera=scene.camera._replace(position=v3(*pos, device=dev), rotation=rot))
            frame_proc(accum, render_u8(frame, cfg))
            accum += 1
        prev_pos = kf_pos
        prev_rot = kf_rot
        prev_velocity = kf.velocity
    return accum
