"""The PyTorch port's host apps against the JAX package: the CLI, the camera
animation and ``Quat.slerp``.

Twins on ``device="cpu"`` of tests/test_apps.py:14-46 (the CLI's static
render, its ``-s``/``-d`` round trip, march with glow) and :106-121 (the
Hermite path, the animation's frames), and of tests/test_quat_vec.py:46
(slerp); ``slerp``, ``hermite_interpolate`` and ``look_at_rotation`` held
against the JAX package's on the same inputs, and a scene file with a
``camera_motion`` rendered by the CLI to the JAX package's frames.
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import animation, cli
from ray_rust_tpu_torch.models.quat import Quat
from ray_rust_tpu_torch.models.scene import Camera, CameraKeyframe
from ray_rust_tpu_torch.models.serialize import serialize_scene
from ray_rust_tpu_torch.models.vec import v3
from ray_rust_tpu_torch.utils.image import load_png

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


def _argv(*args):
    return [*args, "--device", "cpu"]


def test_cli_static_render(tmp_path):
    out = tmp_path / "out.png"
    assert cli.main(_argv("32", "24", "-o", str(out), "--max_refractions", "1")) == 0
    img = load_png(str(out))
    assert img.shape == (24, 32, 3)
    assert img.mean() > 1  # not black


def test_cli_serialize_deserialize(tmp_path):
    yml, out1, out2 = tmp_path / "scene.yaml", tmp_path / "a.png", tmp_path / "b.png"
    cli.main(_argv("32", "24", "-o", str(out1), "-s", str(yml), "--max_refractions", "1"))
    assert yml.exists()
    cli.main(_argv("32", "24", "-o", str(out2), "-d", str(yml), "--max_refractions", "1"))
    np.testing.assert_array_equal(load_png(str(out1)), load_png(str(out2)))


def test_cli_raymarch_glow(tmp_path):
    out = tmp_path / "m.png"
    assert cli.main(_argv("24", "16", "-m", "-g", "1.0", "-o", str(out),
                          "--max_refractions", "1")) == 0
    assert load_png(str(out)).shape == (16, 24, 3)


def test_animation_hermite():
    f = animation.hermite_interpolate_f32
    # endpoints and velocity consistency (render.rs:907-916)
    assert f(0.0, 1.0, 5.0, 0.0, 0.0) == 1.0
    assert abs(f(1.0, 1.0, 5.0, 0.0, 0.0) - 5.0) < 1e-5
    eps = 1e-3
    d = (f(eps, 0.0, 1.0, 2.0, -1.0) - f(0.0, 0.0, 1.0, 2.0, -1.0)) / eps
    assert abs(d - 2.0) < 0.05  # the derivative at t = 0 is v0


def _keyframes(pkg, scene):
    return (pkg.CameraKeyframe(camera=pkg.Camera.from_pyr(pkg.v3(50.0, -150.0, -300.0),
                                                          scene.camera.pyr),
                               velocity=(10.0, 0.0, 0.0), camera_target=None, duration=1.0),
            pkg.CameraKeyframe(camera=pkg.Camera.from_pyr(pkg.v3(100.0, -150.0, -300.0),
                                                          scene.camera.pyr),
                               velocity=(0.0, 0.0, 0.0), camera_target=(0.0, -30.0, 172.0),
                               duration=1.0))


def test_animation_frames():
    scene, meta = rtt.default_scene(device="cpu")
    meta2 = rtt.SceneMeta(meta.material_names, meta.texture_names, meta.bg,
                          camera_motion=_keyframes(rtt, scene))
    frames = []
    cfg = rtt.RenderConfig(xres=24, yres=16, max_refractions=1)
    n = animation.render_frames(scene, meta2, cfg, lambda i, img: frames.append((i, img)))
    assert n == 4  # duration 1.0 / 0.5 per keyframe
    assert [i for i, _ in frames] == [0, 1, 2, 3]
    assert frames[0][1].shape == (16, 24, 3)
    assert not np.array_equal(frames[0][1], frames[1][1])  # the camera moved


def _jax_quat(q):
    from ray_rust_tpu.models.quat import Quat as JQuat

    return JQuat.new(*(float(c) for c in q))


def _q(q):
    return np.array([float(c) for c in q], np.float32)


def test_slerp_endpoints_and_long_path():
    a = Quat.from_pyr(v3(0.1, 0.2, 0.3))
    b = Quat.from_pyr(v3(-0.5, 1.0, 0.4))
    probe = v3(0.3, -1.2, 2.0)

    def rot(q, vec=probe):
        return np.array([float(c) for c in q.transform(vec)])
    # the endpoints act as the same rotation (the long path may return -q)
    for got, want in ((a.slerp(b, 0.0), a), (a.slerp(b, 1.0), b)):
        np.testing.assert_allclose(rot(got), rot(want), atol=1e-4)
    # the degenerate (identical) case returns self
    np.testing.assert_allclose(float(a.slerp(a, 0.5).x), float(a.x), atol=1e-7)
    # the long path: -b takes the sign fix (quat.rs:116-118), a non-unit
    # quaternion of the same direction
    bneg = Quat(-b.x, -b.y, -b.z, -b.w)
    vec = v3(1.0, -2.0, 0.5)
    d1 = a.slerp(b, 0.5).transform(vec).normalized()
    d2 = a.slerp(bneg, 0.5).transform(vec).normalized()
    np.testing.assert_allclose([float(c) for c in d1], [float(c) for c in d2], atol=1e-4)


def test_slerp_hermite_look_at_match_jax():
    """On the same inputs: slerp (ordinary, long path, degenerate) within f32
    rounding, the Hermite path bit for bit, the look-at quaternion within
    f32 rounding."""
    from ray_rust_tpu import animation as janim
    from ray_rust_tpu.models.quat import Quat as JQuat

    a = Quat.from_pyr(v3(0.1, 0.2, 0.3))
    b = Quat.from_pyr(v3(-0.5, 1.0, 0.4))
    bneg = Quat(-b.x, -b.y, -b.z, -b.w)
    for o in (b, bneg, a):
        for t in (0.0, 0.25, 0.5, 1.0):
            want = _jax_quat(a).slerp(_jax_quat(o), t)
            np.testing.assert_allclose(_q(a.slerp(o, t)), _q(want), rtol=0, atol=2e-6)
    rng = np.random.default_rng(4)
    for _ in range(16):
        x0, x1, v0, v1 = (tuple(rng.uniform(-300, 300, 3)) for _ in range(4))
        t = float(rng.uniform(0, 1))
        assert (animation.hermite_interpolate(t, x0, x1, v0, v1)
                == janim.hermite_interpolate(t, x0, x1, v0, v1))
        target = tuple(rng.uniform(-300, 300, 3))
        np.testing.assert_allclose(_q(animation.look_at_rotation(x0, target)),
                                   _q(janim.look_at_rotation(x0, target)), rtol=0, atol=2e-6)
    assert isinstance(janim.look_at_rotation((0, 0, 0), (1, 2, 3)), JQuat)
    assert animation.FRAME_STEP == janim.FRAME_STEP


def test_cli_camera_motion_frames_match_jax(tmp_path, monkeypatch):
    """A scene file with two keyframes (one slerped, one looking at a
    target): the CLI writes ``{output}{i}.png`` frames, as many as the JAX
    package's ``render_frames`` makes of the same file, each frame's camera
    the JAX one's within f32 rounding and its file ``render_u8`` of it."""
    from ray_rust_tpu import animation as janim
    from ray_rust_tpu.models import serialize as jser

    scene, meta = rtt.default_scene(device="cpu")
    text = serialize_scene(scene, meta).replace("camera_motion: []\n", """camera_motion:
- camera:
    position: {x: 50.0, y: -150.0, z: -300.0}
    pyr: {x: 0.2, y: -1.5707964, z: -1.5707964}
  velocity: {x: 10.0, y: 0.0, z: 0.0}
  duration: 1.0
- camera:
    position: {x: 100.0, y: -150.0, z: -300.0}
    pyr: {x: 0.0, y: -1.5707964, z: -1.5707964}
  velocity: {x: 0.0, y: 0.0, z: 0.0}
  camera_target: {x: 0.0, y: -30.0, z: 172.0}
  duration: 1.5
""")
    (tmp_path / "motion.yaml").write_text(text)

    def pose(cam):
        return np.array([float(c) for c in (*cam.position, *cam.rotation)], np.float32)
    # the JAX package's camera path for the same file, its renders left out
    js, jm, _ = jser.deserialize_scene(text)
    jax_poses = []
    monkeypatch.setattr(janim, "render_u8",
                        lambda s, c: jax_poses.append(pose(s.camera)) or np.zeros((1, 1, 3)))
    n = janim.render_frames(js, jm, None, lambda i, img: None)
    assert n == int(1.0 / janim.FRAME_STEP) + int(1.5 / janim.FRAME_STEP) == 5

    frames = []
    real = animation.render_u8

    def render(s, c):
        frames.append((pose(s.camera), real(s, c)))
        return frames[-1][1]
    monkeypatch.setattr(animation, "render_u8", render)
    monkeypatch.chdir(tmp_path)
    assert cli.main(_argv("24", "16", "-d", "motion.yaml", "-o", "frame",
                          "--max_refractions", "1")) == 0
    files = sorted(p.name for p in tmp_path.glob("frame*.png"))
    assert files == sorted(f"frame{i}.png" for i in range(n))
    assert len(frames) == n
    for i, ((got, img), want) in enumerate(zip(frames, jax_poses)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=f"frame {i}")
        np.testing.assert_array_equal(load_png(str(tmp_path / f"frame{i}.png")), img)
    assert not np.array_equal(frames[0][1], frames[-1][1])


def test_keyframe_camera_follows_the_scene_device():
    """Each frame replaces only the camera's tensors, on the scene's device:
    the keyframes' cameras stay on the host."""
    scene, meta = rtt.default_scene(device="cpu")
    kf = _keyframes(rtt, scene)
    assert isinstance(kf[0], CameraKeyframe) and isinstance(kf[0].camera, Camera)
    seen = []
    meta2 = rtt.SceneMeta(meta.material_names, meta.texture_names, meta.bg, camera_motion=kf)
    cfg = rtt.RenderConfig(xres=4, yres=4, max_refractions=1)

    def proc(i, img):
        seen.append(img.shape)
    with pytest.MonkeyPatch.context() as mp:
        cams = []
        real = animation.render_u8
        mp.setattr(animation, "render_u8", lambda s, c: cams.append(s.camera) or real(s, c))
        animation.render_frames(scene, meta2, cfg, proc)
    assert len(seen) == 4
    for cam in cams:
        assert all(t.device == scene.device and t.dtype == torch.float32
                   for t in (*cam.position, *cam.rotation))
