"""The backward kernels' fixed-point sums past 2^32 terms
(``csrc/fixed_sum.cuh``), on the CPU.

K2, K4 and K5 sum every cotangent term as an integer in two int64 digits. A
launch first takes a 31-bit lo digit, which holds fewer than 2^32 terms;
where its count does not fit, it runs again with the split its count gives
(``retry_split``: n the bits of the count, a lo digit of min(31, 63 - n)
bits, terms below 2^min(62, 126 - 2n)), which holds any count below 2^62.
A card reaches that split past 2^32 terms (K2 on the box of transparent
planes at 3840x2160 sums 2^34); the host builds reach it at a thousand
terms when built with ``-DRT_FIXED_TERMS_SHIFT=22`` (each term counted as
2^22). Here:

- the split itself (``rt_fixed_split_host``), for every count's bits it
  accepts: each digit's sum stays within int64, and under 2^32 terms it is
  the first run's (31, 62); past 2^62 terms no split holds;
- the host twin of the sum (``rt_fixed_sum_host``) in the shifted build:
  12 000 terms run twice with a 27-bit lo digit, the block bit-equal over
  seeded permutations and within its grid of a float64 sum; 600 terms run
  once at the 31-bit digit, bit-equal to the unshifted build's block;
- the shifted host builds of K2 and K4 at the JAX tests' small settings
  (tests/test_pallas_bwd.py; tests/test_torch_determinism.py's frames):
  against ``jax.vjp`` per scene leaf within the JAX budgets (0.01 trace,
  0.02 march), and within relative L2 1e-4 of the unshifted build's block,
  as ``chip_smoke.py`` holds a card launch past 2^32 terms against the
  float64 sum of its windows.

The forced scale's overflow (no retry) stays in
``tests/test_torch_determinism.py::test_fixed_sum_overflow_is_raised_never_wrapped``.
"""

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

from .test_torch_determinism import _fixed_sum, _jax_case, _terms, _within_grid
from .test_torch_kernel_bwd import _host_grads as k2_host
from .test_torch_kernel_bwd import _rel, assert_boundary_only
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)
from .test_torch_march_grad import _host_grads as k4_host

FIXED_OVERFLOW = 1001  # csrc/fixed_sum.cuh
SHIFT = 22  # each term counted as 2^22: 2^10 terms or more take the second split
STATS = ["first_scale", "scale", "runs", "log2_terms", "term_exp", "g_exp", "lo_bits"]
INT64_MAX = 2**63 - 1


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds of K2 and K4 with the terms shifted, and K2's
    without, built at once."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("fixed_terms_host")
    builds = {"trace_bwd": ("trace_bwd", SHIFT), "march_bwd": ("march_bwd", SHIFT),
              "trace_bwd_plain": ("trace_bwd", 0), "march_bwd_plain": ("march_bwd", 0)}
    with ThreadPoolExecutor(len(builds)) as pool:
        done = pool.map(lambda b: _build.build_host_library(d, b[0], terms_shift=b[1]),
                        builds.values())
        return dict(zip(builds, done))


def _stats(lib):
    out = (ctypes.c_int * len(STATS))()
    lib.rt_fixed_stats(out)
    return dict(zip(STATS, out))


def _split(lib, n):
    out = (ctypes.c_int * 2)()
    rc = lib.rt_fixed_split_host(n, out)
    return rc, out[0], out[1]


@settings(max_examples=80, deadline=None, database=None)
@given(n=st.integers(0, 64))
def test_split_holds_every_count_in_int64(libs, n):
    """For a count of n bits (count < 2^n), the split's lo digits (below
    2^(L-1)) and hi digits (at most 2^(Q-L)) sum within int64, at most
    2^63 in magnitude even for 2^n terms; the largest n it accepts is 62."""
    rc, lo_bits, q_bits = _split(libs["trace_bwd_plain"], n)
    if n > 62:
        assert rc == FIXED_OVERFLOW
        return
    assert rc == 0
    assert 1 <= lo_bits <= 31 and lo_bits <= q_bits <= 62
    assert (2**n - 1) * 2 ** (lo_bits - 1) <= INT64_MAX
    assert (2**n - 1) * 2 ** (q_bits - lo_bits) <= INT64_MAX
    assert 2**n * 2 ** (lo_bits - 1) <= 2**63 and 2**n * 2 ** (q_bits - lo_bits) <= 2**63
    if n <= 32:  # the first run's digits
        assert (lo_bits, q_bits) == (31, 62)
    else:  # the finest q for the count: one bit more breaks a sum's bound
        assert (2**n - 1) * 2 ** (q_bits + 1 - lo_bits) > INT64_MAX or q_bits == 62
    # the shifted build takes the same split for the same bits
    assert _split(libs["trace_bwd"], n) == (rc, lo_bits, q_bits)


@pytest.mark.parametrize("kind", ["uniform", "spread", "cancelling"])
def test_split_sum_is_the_same_in_any_order(libs, kind):
    """12 000 terms counted as 2^36 run twice, with a 27-bit lo digit: the
    block is bit-equal over seeded permutations and within its grid."""
    lib = libs["trace_bwd"]
    entry, x = _terms(kind, 4, m=12000)
    gmax = float(np.abs(x).max())
    first, rc, scale = _fixed_sum(lib, entry, x, gmax)
    stats = _stats(lib)
    assert rc == 0 and stats["runs"] == 2 and stats["lo_bits"] == 27, stats
    assert stats["log2_terms"] == 36 and stats["scale"] == scale
    for seed in range(5):
        order = np.random.default_rng(200 + seed).permutation(x.size)
        got, rc, s = _fixed_sum(lib, entry[order], x[order], gmax)
        assert rc == 0 and s == scale
        np.testing.assert_array_equal(got.view(np.uint32), first.view(np.uint32))
    assert _within_grid(first, entry, x, scale) < 1e-4


def test_first_run_keeps_its_digits(libs):
    """600 terms, counted as 600 * 2^22 (fewer than 2^32), run once at
    the 31-bit digit and the first scale, bit-equal to the unshifted
    build's sum."""
    entry, x = _terms("spread", 5, m=600)
    gmax = float(np.abs(x[:100]).max())
    got, rc, scale = _fixed_sum(libs["trace_bwd"], entry, x, gmax)
    stats = _stats(libs["trace_bwd"])
    want, rc0, scale0 = _fixed_sum(libs["trace_bwd_plain"], entry, x, gmax)
    assert rc == rc0 == 0 and scale == scale0
    assert stats["lo_bits"] == 31 and stats["log2_terms"] == 32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the host builds past 2^32 terms against the JAX package ------------------


@pytest.fixture(scope="module")
def jax_trace():
    return _jax_case(march=False)


@pytest.fixture(scope="module")
def jax_march():
    return _jax_case(march=True)


_HOST = {"K2": (k2_host, "trace_bwd", 0.01), "K4": (k4_host, "march_bwd", 0.02)}


def _cases(libs, jax_case, kernel):
    host, lib, budget = _HOST[kernel]
    jax_scene, cfg, jax_img, vjp = jax_case
    scene = rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")
    rng = np.random.default_rng(0)
    planes = [rng.standard_normal((cfg.yres, cfg.xres)).astype(np.float32) for _ in range(3)]
    _, prim = host(libs[lib], scene, cfg, [torch.from_numpy(p) for p in planes])
    agree = np.abs(prim - jax_img).max(-1) < 1e-4
    assert agree.mean() > 0.9, f"forwards agree on {agree.mean():.0%}"
    assert_boundary_only(jax_img, agree)
    planes = [torch.from_numpy(p * agree) for p in planes]
    return host, lib, budget, scene, cfg, planes, vjp


@pytest.mark.parametrize("kernel", sorted(_HOST))
def test_host_build_past_2_32_terms_matches_jax_vjp(libs, jax_trace, jax_march, kernel):
    import jax.numpy as jnp

    from ray_rust_tpu.models.vec import Color as JaxColor

    host, lib, budget, scene, cfg, planes, vjp = _cases(
        libs, jax_march if kernel == "K4" else jax_trace, kernel)
    tables, _ = host(libs[lib], scene, cfg, planes)
    stats = _stats(libs[lib])
    assert stats["runs"] == 2 and stats["lo_bits"] < 31 and stats["log2_terms"] > 32, stats
    (ct,) = vjp(JaxColor(*(jnp.asarray(p.numpy()) for p in planes)))
    want = rtt.scene_to_numpy(ct)
    for path, a in kb.leaf_grads(scene, tables).items():
        a = a.numpy()
        assert np.isfinite(a).all(), path
        if "pattern_scale" not in path:
            rel = _rel(a, np.asarray(want[path]))
            assert rel <= budget, f"{kernel} {path}: relative L2 {rel:.2e} > {budget}"


@pytest.mark.parametrize("kernel", sorted(_HOST))
def test_host_build_past_2_32_terms_matches_its_first_run(libs, jax_trace, jax_march, kernel):
    """The second split's block against the one-run block of the unshifted
    build on the same terms: relative L2 at most 1e-4 per scene leaf (norm
    floor 1e-2), the card's budget against a frame's banded float64 sum."""
    host, lib, _, scene, cfg, planes, _ = _cases(
        libs, jax_march if kernel == "K4" else jax_trace, kernel)
    split, _ = host(libs[lib], scene, cfg, planes)
    assert _stats(libs[lib])["runs"] == 2
    one, _ = host(libs[lib + "_plain"], scene, cfg, planes)
    assert _stats(libs[lib + "_plain"])["runs"] == 1
    got, want = kb.leaf_grads(scene, split), kb.leaf_grads(scene, one)
    for path in want:
        a, b = got[path].numpy().astype(np.float64), want[path].numpy().astype(np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2)
        assert rel <= 1e-4, f"{kernel} {path}: relative L2 {rel:.2e} > 1e-4"
