"""The backward kernels' order-free sums (``csrc/fixed_sum.cuh``) and the
atlas's 64-bit texel index, on the CPU.

K2, K4 and K5 turn every cotangent term into a 64-bit fixed-point integer
before any sum across threads, so their blocks come out the same in any
order of adds; their g++ host builds sum the same integers at the same
scale. Here:

- the host twin of that sum (``rt_fixed_sum_host``) gives a bit-equal block
  for seeded permutations of the same terms, where float sums in those
  orders differ (terms over thirty decades among them, which take both of
  its digits); it stays within the rounding bound of an f64 sum (each term
  within half a grid step), runs again at a coarser scale where the terms
  outgrow the first one, returns its overflow code (and the wrappers raise,
  naming it) where a forced scale cannot hold them, and carries non-finite
  terms into the float block the same in any order;
- the host builds of K2, K5 and K4 on the default scene against the JAX
  package's ``jax.vjp``, per scene leaf within the JAX tests' budgets (0.01
  trace, 0.02 march) at their settings (tests/test_pallas_bwd.py: the trace
  at 32x16, 2 reflections, refraction_unroll=1; the march at 16x12), on the
  pixels where the forwards agree (at 16x12 in trace mode the camera's
  rotation.w, a cotangent of norm ~100, reads 3.1e-2 already for plain
  autograd against ``jax.vjp``);
- the texel index of an atlas past 2^31 texels (2 049 textures of 1 024 x
  1 024), from the forward's host build without the atlas, against numpy's
  int64 ``(tid * Hmax + iy) * Wmax + ix``.

The kernels themselves repeat bit for bit only on a card: this file's
``cuda`` test holds two twins of one state through SGD and Adam steps bit
for bit (``python -m pytest --noconftest -m cuda
tests/test_torch_determinism.py``), and
``tests/test_torch_kernel_bwd.py::test_cuda_backward_kernel_repeats_itself``
each backward instance's launches; ``chip_smoke.py`` both at full size.
"""

import ctypes

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.models.vec import Color
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

from .test_torch_kernel_bwd import _host_grads as k2_host
from .test_torch_kernel_bwd import _rel, assert_boundary_only
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)
from .test_torch_march_grad import _VJP_KW, _jax_fwd
from .test_torch_march_grad import _host_grads as k4_host
from .test_torch_retrace import _retrace_host as k5_host

FIXED_OVERFLOW = 1001  # csrc/fixed_sum.cuh
FIXED_FREE = -2**31
ENTRIES = 64


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds of K2, K4, K5 and K1 (its texel index), built at once."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("determinism_host")
    names = ("trace_bwd", "march_bwd", "trace_retrace", "trace")
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(lambda name: _build.build_host_library(d, name), names)))


def _terms(kind, seed, m=40000):
    """``m`` terms (entries, values): magnitudes over a few decades, over
    thirty, or pairs that cancel."""
    rng = np.random.default_rng(seed)
    entry = rng.integers(0, ENTRIES, m).astype(np.int32)
    sign = rng.choice([-1.0, 1.0], m)
    if kind == "uniform":
        x = rng.uniform(-1.0, 1.0, m)
    elif kind == "spread":
        x = sign * 10.0 ** rng.uniform(-20, 10, m)
    else:  # "cancelling": each term and its negative, in a random order
        half = sign[:m // 2] * 10.0 ** rng.uniform(-3, 3, m // 2)
        x, entry = np.concatenate([half, -half]), np.concatenate([entry[:m // 2]] * 2)
    return entry.astype(np.int32), x.astype(np.float32)


def _fixed_sum(lib, entry, x, gmax, forced=FIXED_FREE):
    """The host twin's block, its return code and its scale."""
    out = np.zeros(ENTRIES, np.float32)
    scale = ctypes.c_int(0)
    entry, x = np.ascontiguousarray(entry), np.ascontiguousarray(x)
    rc = lib.rt_fixed_sum_host(x.size, entry.ctypes.data, x.ctypes.data, ENTRIES,
                               float(gmax), forced, out.ctypes.data, ctypes.addressof(scale))
    return out, rc, scale.value


def _f64(entry, x):
    return np.bincount(entry, weights=x.astype(np.float64), minlength=ENTRIES)


def _within_grid(got, entry, x, scale):
    """Each entry within its terms' rounding (half a grid step each), the
    double's and the float's: the bound of an f64 sum of the terms."""
    want = _f64(entry, x)
    count = np.bincount(entry, minlength=ENTRIES)
    bound = count * 2.0 ** (-scale - 1) + np.abs(want) * 2.0**-23 + 2.0 ** -scale
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-2)


@pytest.mark.parametrize("kind", ["uniform", "spread", "cancelling"])
def test_fixed_sum_is_the_same_in_any_order(libs, kind):
    lib = libs["trace_bwd"]
    entry, x = _terms(kind, 1)
    gmax = float(np.abs(x).max())
    first, rc, scale = _fixed_sum(lib, entry, x, gmax)
    assert rc == 0
    floats = set()
    for seed in range(5):
        order = np.random.default_rng(100 + seed).permutation(x.size)
        got, rc, s = _fixed_sum(lib, entry[order], x[order], gmax)
        assert rc == 0 and s == scale
        np.testing.assert_array_equal(got.view(np.uint32), first.view(np.uint32))
        acc = np.zeros(ENTRIES, np.float32)
        np.add.at(acc, entry[order], x[order])  # in float32, in this order
        floats.add(acc.tobytes())
    assert len(floats) > 1, "float sums in these orders agree: the terms show nothing"
    assert _within_grid(first, entry, x, scale) < 1e-4  # the host builds' budget is 1e-3


def test_fixed_sum_retries_at_a_coarser_scale(libs):
    """Terms 2^45 past the cotangent's largest |g| do not fit the first
    scale's int64 (it holds 2^32 |g|); the sum runs again at the scale its
    counts give."""
    lib = libs["trace_bwd"]
    entry, x = _terms("uniform", 2)
    x = (x * 2.0**45).astype(np.float32)
    got, rc, scale = _fixed_sum(lib, entry, x, gmax=1.0)
    _, _, first = _fixed_sum(lib, entry[:1], np.zeros(1, np.float32), gmax=1.0)
    assert rc == 0 and scale < first
    assert _within_grid(got, entry, x, scale) < 1e-4


def test_fixed_sum_overflow_is_raised_never_wrapped(libs):
    lib = libs["trace_bwd"]
    entry, x = _terms("uniform", 3)
    out, rc, _ = _fixed_sum(lib, entry, x, gmax=1.0, forced=70)
    assert rc == FIXED_OVERFLOW and not out.any()
    assert b"overflow" in lib.rt_error_string(rc)
    assert b"overflow" in libs["march_bwd"].rt_error_string(rc)
    assert b"overflow" in libs["trace_retrace"].rt_error_string(rc)
    # the wrappers raise on it, naming it
    cfg = rtt.RenderConfig(xres=4, yres=2)
    g = Color(*(torch.zeros(2, 4) for _ in range(3)))

    def launcher(*args):
        return FIXED_OVERFLOW

    launcher.__name__ = "rt_trace_bwd_host"
    with pytest.raises(RuntimeError, match="overflow"):
        kb.launch_block(lib, launcher, [0] * 4, 1, torch.device("cpu"), cfg, [], g, False)


def test_fixed_sum_carries_nonfinite_terms_in_any_order(libs):
    lib = libs["trace_bwd"]
    entry = np.array([0, 0, 1, 1, 2, 2, 3], np.int32)
    x = np.array([np.inf, 1.0, np.inf, -np.inf, np.nan, 2.0, 3.0], np.float32)
    for seed in range(4):
        order = np.random.default_rng(seed).permutation(x.size)
        got, rc, _ = _fixed_sum(lib, entry[order], x[order], gmax=1.0)
        assert rc == 0
        assert got[0] == np.inf and np.isnan(got[1]) and np.isnan(got[2]) and got[3] == 3.0


# -- the host builds against the JAX package ---------------------------------


def _jax_case(march):
    import jax

    import ray_rust_tpu as rt

    scene, _ = rt.default_scene()
    if march:  # tests/test_pallas_bwd.py:279-283's settings and camera
        import jax.numpy as jnp

        scene = scene._replace(camera=scene.camera._replace(
            position=scene.camera.position._replace(x=jnp.float32(0.37))))
        cfg = rtt.RenderConfig(**_VJP_KW, glow_effect=1.0)
    else:  # tests/test_pallas_bwd.py's trace settings and frame
        cfg = rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1)
    img, vjp = jax.vjp(_jax_fwd(cfg), scene)
    return scene, cfg, np.stack([np.asarray(c) for c in img], -1), vjp


@pytest.fixture(scope="module")
def jax_trace():
    return _jax_case(march=False)


@pytest.fixture(scope="module")
def jax_march():
    return _jax_case(march=True)


_HOST = {"K2": (k2_host, "trace_bwd", 0.01), "K5": (k5_host, None, 0.01),
         "K4": (k4_host, "march_bwd", 0.02)}


@pytest.mark.parametrize("kernel", sorted(_HOST))
def test_host_build_matches_jax_vjp(libs, jax_trace, jax_march, kernel):
    import jax.numpy as jnp

    from ray_rust_tpu.models.vec import Color as JaxColor

    host, lib, budget = _HOST[kernel]
    jax_scene, cfg, jax_img, vjp = jax_march if kernel == "K4" else jax_trace
    scene = rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")
    rng = np.random.default_rng(0)
    planes = [rng.standard_normal((cfg.yres, cfg.xres)).astype(np.float32) for _ in range(3)]
    _, prim = host(libs if lib is None else libs[lib], scene, cfg,
                   [torch.from_numpy(p) for p in planes])
    agree = np.abs(prim - jax_img).max(-1) < 1e-4
    assert agree.mean() > 0.9, f"forwards agree on {agree.mean():.0%}"
    assert_boundary_only(jax_img, agree)
    planes = [p * agree for p in planes]
    tables, _ = host(libs if lib is None else libs[lib], scene, cfg,
                     [torch.from_numpy(p) for p in planes])
    (ct,) = vjp(JaxColor(*map(jnp.asarray, planes)))
    want = rtt.scene_to_numpy(ct)
    for path, a in kb.leaf_grads(scene, tables).items():
        a = a.numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" not in path:
            rel = _rel(a, np.asarray(want[path]))
            assert rel <= budget, f"{kernel} {path}: relative L2 {rel:.2e} > {budget}"


# -- the atlas's 64-bit texel index -------------------------------------------


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_texel_index_past_2_31_texels(libs, filt):
    """2 049 textures of 1 024 x 1 024 (2^31 + 2^20 texels): the host
    build's texel_index against numpy's int64 index, the last texture's
    lookups past 2^31; the meta rows' base texel (int32) is not read."""
    n_tex, side = 2049, 1024
    meta = np.zeros((n_tex, 4), np.int32)
    meta[:, 0] = meta[:, 1] = side
    meta[:, 2] = -1  # past int32 for most rows: the index does not read it
    meta[:, 3] = filt
    rng = np.random.default_rng(11)
    m = 4096
    tid = rng.choice([0, 1, 2047, 2048], m).astype(np.int32)
    u = rng.uniform(-2.0, 2.0, m).astype(np.float32)
    v = rng.uniform(-2.0, 2.0, m).astype(np.float32)
    out = np.zeros(m, np.int64)
    libs["trace"].rt_texel_index_host(m, tid.ctypes.data, u.ctypes.data, v.ctypes.data,
                                      meta.ctypes.data, n_tex, side, side * side,
                                      out.ctypes.data)
    sf = np.float32(side)
    if filt:  # floor, then wrap by the size (trace_body.cuh: fimod)
        ix = np.mod(np.floor(u * sf), sf).astype(np.int64)
        iy = np.mod(np.floor(v * sf), sf).astype(np.int64)
    else:  # truncate toward zero, then wrap
        ix = np.mod(np.trunc(u * sf).astype(np.int64), side)
        iy = np.mod(np.trunc(v * sf).astype(np.int64), side)
    want = (tid.astype(np.int64) * side + iy) * side + ix
    np.testing.assert_array_equal(out, want)
    assert out.max() >= 2**31 and (out[tid == 2048] >= 2048 * side * side).all()


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_training_twins_repeat_bit_for_bit():
    """Two copies of one state take 10 SGD steps on the material colours at
    320x240 (K1 + K2 each) and two take 10 of the inverse-rendering
    example's Adam steps at 160x120: losses and leaves equal bit for bit,
    under ``torch.use_deterministic_algorithms(True)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    import os

    from ray_rust_tpu_torch.examples import inverse_rendering as example
    from ray_rust_tpu_torch.parallel import SceneAdam, TrainState, make_train_step
    from ray_rust_tpu_torch.parallel import sgd_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda")
    scene = rtt.default_scene(device=dev)[0]
    cfg = rtt.RenderConfig(xres=320, yres=240)
    m = scene.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = rtt.render_color(scene._replace(materials=m._replace(
            diffuse=m.diffuse._replace(r=red))), cfg).to_array()
    colours = type(m.diffuse)(*(t.detach().clone().requires_grad_() for t in m.diffuse))
    start = scene._replace(materials=m._replace(diffuse=colours))
    ex_cfg = example.example_config(160)
    _, ex_target, s0 = example.problem(ex_cfg, dev)
    opt = SceneAdam(0.5)
    step = make_train_step(ex_cfg, opt)
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            s, losses = start, []
            for _ in range(10):
                s, loss = sgd_train_step(s, cfg, target, lr=30.0)
                losses.append(float(loss))
            runs.append((losses, list(s.materials.diffuse)))
        state = TrainState(s0, opt.init(s0))
        adam = []
        for twin in (copy.deepcopy(state), copy.deepcopy(state)):
            losses = []
            for _ in range(10):
                twin, loss = step(twin, ex_target)
                losses.append(float(loss))
            adam.append((losses, list(twin.scene.tensors())))
    finally:
        torch.use_deterministic_algorithms(False)
    for (la, ta), (lb, tb) in (runs, adam):
        assert la == lb
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
