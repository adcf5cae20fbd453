"""The PyTorch port's foundation modules against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; results
come back as numpy arrays. Math, modulo, camera and sky: ops written in the
same order in both packages, so they agree to a few ulp or exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu.ops.rays import camera_rays as jax_camera_rays
from ray_rust_tpu.ops.sky import default_sky as jax_default_sky
from ray_rust_tpu.utils import fastmath as jfm
from ray_rust_tpu.utils import modutil as jmu
from ray_rust_tpu_torch.ops.rays import camera_rays
from ray_rust_tpu_torch.ops.sky import default_sky
from ray_rust_tpu_torch.utils import fastmath as tfm
from ray_rust_tpu_torch.utils import modutil as tmu

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


def _ulp_diff(a, b):
    """Distance in units in the last place between two f32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seeded(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    wide = rng.standard_normal(n // 2) * np.exp(rng.uniform(-8, 8, n // 2))
    unit = rng.uniform(-1.0, 1.0, n - n // 2)
    return np.concatenate([wide, unit]).astype(np.float32)


_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.4142135, 2.4142137,
                     1e-30, -1e30, 3.0e38], np.float32)


@pytest.mark.parametrize("name", ["atan", "asin"])
def test_fastmath_unary_within_2ulp(name):
    x = np.concatenate([_seeded(), _SPECIAL])
    if name == "asin":
        x = np.clip(x, -1.0, 1.0)
    want = np.asarray(getattr(jfm, name)(jnp.asarray(x)))
    got = getattr(tfm, name)(_t(x)).numpy()
    assert _ulp_diff(got, want).max() <= 2


def test_fastmath_atan2_within_2ulp():
    rng = np.random.default_rng(1)
    y = _seeded(seed=2)
    x = rng.permutation(_seeded(seed=3))
    axes = np.array([0.0, 1.0, -1.0, 0.0, 0.0, 2.0, -3.0], np.float32)
    y = np.concatenate([y, axes, np.array([0.0, 0.0, 1.0, -1.0, 5.0, -5.0, 0.0], np.float32)])
    x = np.concatenate([x, np.zeros(7, np.float32), axes])
    want = np.asarray(jfm.atan2(jnp.asarray(y), jnp.asarray(x)))
    got = tfm.atan2(_t(y), _t(x)).numpy()
    assert _ulp_diff(got, want).max() <= 2


def test_modutil_exactly_equal():
    rng = np.random.default_rng(4)
    f = (rng.standard_normal(10_000) * 300).astype(np.float32)
    freq = rng.uniform(0.5, 40.0, 10_000).astype(np.float32)
    i = rng.integers(-5000, 5000, 10_000).astype(np.int32)
    ifreq = rng.integers(1, 300, 10_000).astype(np.int32)
    np.testing.assert_array_equal(tmu.fmod(_t(f), _t(freq)).numpy(),
                                  np.asarray(jmu.fmod(f, freq)))
    np.testing.assert_array_equal(tmu.rust_rem(_t(f), _t(freq)).numpy(),
                                  np.asarray(jmu.rust_rem(f, freq)))
    np.testing.assert_array_equal(tmu.imod(_t(i), _t(ifreq)).numpy(),
                                  np.asarray(jmu.imod(i, ifreq)))
    np.testing.assert_array_equal(tmu.umod(_t(np.abs(i)), _t(ifreq)).numpy(),
                                  np.asarray(jmu.umod(np.abs(i), ifreq)))
    frac_t, idx_t = tmu.fimod(_t(f), _t(freq))
    frac_j, idx_j = jmu.fimod(f, freq)
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_quat_and_camera_rays_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        pyr = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
        pos = rng.uniform(-500, 500, 3).astype(np.float32)
        jq = rt.Quat.from_pyr(rt.v3(*pyr))
        tq = rtt.Quat.from_pyr(rtt.v3(*pyr))
        np.testing.assert_allclose([float(c) for c in tq], [float(c) for c in jq],
                                   rtol=0, atol=1e-6)
        v = rng.standard_normal((3, 16)).astype(np.float32)
        jv = jq.transform(rt.Vec3(*map(jnp.asarray, v)))
        tv = tq.transform(rtt.Vec3(*map(_t, v)))
        np.testing.assert_allclose(np.stack([c.numpy() for c in tv]),
                                   np.stack([np.asarray(c) for c in jv]), rtol=0, atol=1e-6)

        cfg_j = rt.RenderConfig(xres=64, yres=48)
        cfg_t = rtt.RenderConfig(xres=64, yres=48)
        jvi, jeye = jax_camera_rays(rt.v3(*pos), jq, cfg_j)
        tvi, teye = camera_rays(rtt.v3(*pos), tq, cfg_t)
        for a, b in zip(list(tvi) + list(teye), list(jvi) + list(jeye)):
            assert a.shape == (48, 64)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_default_sky_matches_jax():
    rng = np.random.default_rng(6)
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    light = np.array([50.0, 60.0, -50.0], np.float32)
    light /= np.linalg.norm(light)
    d[:, :8] = light[:, None]  # the sun disc and its glare tiers
    d[:, 8:16] = (light[:, None] + 0.02 * rng.standard_normal((3, 8))).astype(np.float32)
    d[:, 16:22] = np.concatenate([np.eye(3), -np.eye(3)], axis=1)  # the axes
    want = jax_default_sky(rt.Vec3(*map(jnp.asarray, light)), rt.Vec3(*map(jnp.asarray, d)))
    got = default_sky(rtt.Vec3(*map(_t, light)), rtt.Vec3(*map(_t, d)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_default_scene_equals_jax_leaves():
    jax_scene, _ = rt.default_scene()
    leaves = rtt.scene_to_numpy(jax_scene)
    from_jax = rtt.scene_from_numpy(leaves, device="cpu")
    port, _ = rtt.default_scene(device="cpu")
    got = rtt.scene_to_numpy(port)
    assert got.keys() == leaves.keys()
    for k, v in rtt.scene_to_numpy(from_jax).items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_scene_constructors_default_to_cuda():
    """The library API renders on the card unless the caller asks for the
    CPU: with no CUDA device the default raises torch's own error."""
    if torch.cuda.is_available():
        assert rtt.default_scene()[0].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            rtt.default_scene()
    scene, _ = rtt.default_scene(device="cpu")
    assert all(t.device.type == "cpu" for t in scene.tensors())
    img = rtt.render_u8(scene, rtt.RenderConfig(xres=16, yres=12, max_reflections=1))
    assert img.shape == (12, 16, 3) and img.std() > 0
