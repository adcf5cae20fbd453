"""The PyTorch port's plain trace path and entry points against the JAX package.

Scenes are carried into the port with ``scene_from_numpy``. Image budgets
are the JAX package's own: 5% of pixels off by more than 1e-3 and a mean
difference of 0.02 between two implementations (tests/test_parity.py:24),
2% and 0.01 against a golden (tests/test_parity.py:152-161). Knife-edge
pixels (the horizon row, silhouettes) flip under a different rounding
order; the budgets carry them.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu.ops.rays import camera_rays as jax_camera_rays
from ray_rust_tpu.ops.trace import trace_image as jax_trace_image
from ray_rust_tpu.renderer import to_u8 as jax_to_u8
from ray_rust_tpu_torch import cli
from ray_rust_tpu_torch.ops.rays import camera_rays
from ray_rust_tpu_torch.ops.trace import trace_image
from ray_rust_tpu_torch.utils.image import load_png

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compare(ref, got, frac_budget=0.05, tol=1e-3, mean_tol=0.02):
    diff = np.abs(got - ref)
    bad_frac = (diff.max(-1) > tol).mean()
    assert bad_frac <= frac_budget, (
        f"{bad_frac:.1%} pixels differ > {tol} (budget {frac_budget:.0%}); "
        f"mean {diff.mean():.4f} max {diff.max():.3f}"
    )
    assert diff.mean() <= mean_tol, f"mean diff {diff.mean():.4f} > {mean_tol}"


def _jax_trace(scene, cfg):
    vi, eye = jax_camera_rays(scene.camera.position, scene.camera.rotation, cfg)
    out = jax_trace_image(scene, cfg, vi, eye)
    return np.stack([np.asarray(c) for c in out], -1)


def _port_trace(jax_scene, cfg):
    scene = rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")
    vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, cfg)
    return trace_image(scene, cfg, vi, eye).to_array().numpy()


def forty_sphere_scene():
    """tests/test_parity.py:75-102's seeded 40-object scene (JAX side)."""
    rng = np.random.default_rng(7)
    mats = [
        rt.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3), pn=8),
        rt.MaterialSpec(name="m1", diffuse=(0.1, 0.5, 0.9), specular=(0.0, 0.0, 0.0), pn=0),
    ]
    objs = [rt.FloorSpec("m0", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0))]
    for _ in range(39):
        c = rng.uniform(-300, 300, 3)
        c[2] = rng.uniform(100, 600)
        r = rng.uniform(10, 50)
        m = int(rng.integers(0, 2))
        objs.append(rt.SphereSpec(f"m{m}", float(r), tuple(float(v) for v in c)))
    scene, _ = rt.build_scene(mats, objs, (0.0, 0.0, -400.0),
                              (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0))
    return scene


def test_plain_trace_matches_jax_default_scene():
    """The JAX kernel test's config (tests/test_pallas.py:36)."""
    scene, _ = rt.default_scene()
    kw = dict(xres=64, yres=48, max_reflections=2, refraction_unroll=2)
    ref = _jax_trace(scene, rt.RenderConfig(**kw))
    got = _port_trace(scene, rtt.RenderConfig(**kw))
    assert got.shape == (48, 64, 3)
    _compare(ref, got)


def test_plain_trace_matches_jax_forty_spheres():
    """The 40-object parity scene at its JAX test config (40x30, one level of
    refraction)."""
    scene = forty_sphere_scene()
    kw = dict(xres=40, yres=30, max_refractions=1)
    ref = _jax_trace(scene, rt.RenderConfig(**kw))
    got = _port_trace(scene, rtt.RenderConfig(**kw))
    _compare(ref, got)


def test_plain_golden_default_trace_320x240():
    """Full reference depths (3 reflections, 10 refractions) against the
    oracle's golden image."""
    ref = np.load(os.path.join(_REPO, "tests", "goldens", "default_trace_320x240.npz"))["img"]
    scene, _ = rtt.default_scene(device="cpu")
    cfg = rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)
    got = rtt.render_color(scene, cfg).to_array().numpy()
    _compare(ref, got, frac_budget=0.02, mean_tol=0.01)


def test_to_u8_equals_jax():
    vals = np.array([np.nan, np.inf, -np.inf, -0.5, -0.0, 0.0, 0.001, 0.5, 0.999,
                     1.0, 1.0001, 2.0, 255.0, 1e30], np.float32)
    rng = np.random.default_rng(8)
    planes = [np.concatenate([vals, rng.uniform(-0.5, 1.5, 50).astype(np.float32)])
              .reshape(4, 16) for _ in range(3)]
    want = np.asarray(jax_to_u8(rt.Color(*map(jnp.asarray, planes))))
    got = rtt.to_u8(rtt.Color(*map(torch.from_numpy, planes))).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_cli_cpu_writes_render_u8(tmp_path):
    out = tmp_path / "out.png"
    assert cli.main(["32", "24", "-o", str(out), "--device", "cpu"]) == 0
    png = load_png(str(out))
    scene, _ = rtt.default_scene(device="cpu")
    want = rtt.render_u8(scene, rtt.RenderConfig(xres=32, yres=24, yfov=24 / 32))
    assert png.shape == (24, 32, 3)
    np.testing.assert_array_equal(png, want)


def test_cli_refuses_unported_flags(tmp_path):
    import pytest

    for flag in (["-w"], ["-s", "scene.yaml"], ["-d", "scene.yaml"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            cli.main(["8", "8", "-o", str(tmp_path / "x.png"), "--device", "cpu"] + flag)


def test_port_imports_without_jax():
    code = ("import sys, ray_rust_tpu_torch, ray_rust_tpu_torch.cli, ray_rust_tpu_torch.parallel; "
            "print('jax' in sys.modules or 'ray_rust_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
