"""Timing, traces, metrics and ray accounting in the PyTorch port
(``utils/profiling.py``, ``ops/accounting.py``).

Twins of tests/test_profiling.py on ``device="cpu"``, and
``count_traced_rays`` against the JAX package's on the same scene and
config (eager JAX), exactly: the counts are integers. On the card,
``device_trace`` in a session that is not the process's first.
"""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

import jax

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu.ops.accounting import count_traced_rays as jax_count_traced_rays
from ray_rust_tpu_torch.ops.accounting import count_traced_rays
from ray_rust_tpu_torch.utils import profiling
from ray_rust_tpu_torch.utils.profiling import Metrics, RenderTimer, device_trace

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


def test_count_traced_rays_matches_oracle(monkeypatch):
    """Twin of tests/test_profiling.py:10: the raycast calls the reference's
    recursion makes, counted by wrapping the scalar oracle's raycast (1350 at
    32x24), within the JAX test's 2% (the port's count is that exactly)."""
    import tests.oracle as oracle

    ours = int(count_traced_rays(rtt.default_scene(device="cpu")[0],
                                 rtt.RenderConfig(xres=32, yres=24)))
    calls = {"n": 0}
    real_raycast = oracle.raycast

    def counting_raycast(*a, **kw):
        calls["n"] += 1
        return real_raycast(*a, **kw)

    monkeypatch.setattr(oracle, "raycast", counting_raycast)
    oracle.render_oracle(oracle.default_env(32, 24))
    assert abs(ours - calls["n"]) <= 0.02 * calls["n"], (ours, calls["n"])
    assert ours > 32 * 24  # shadow rays exist


@pytest.mark.parametrize("kw", [dict(), dict(max_refractions=1),
                                dict(refraction_unroll=None, max_reflections=5)],
                         ids=["default", "refractions1", "full_depth_reflections5"])
def test_count_traced_rays_matches_jax(kw):
    cfg = dict(xres=24, yres=16, **kw)
    with jax.disable_jit():
        want = float(jax_count_traced_rays(rt.default_scene()[0], rt.RenderConfig(**cfg)))
    got = count_traced_rays(rtt.default_scene(device="cpu")[0], rtt.RenderConfig(**cfg))
    assert got.dtype.is_floating_point is False and int(got) == want


def test_count_traced_rays_refuses_march_mode():
    with pytest.raises(ValueError, match="trace mode"):
        count_traced_rays(rtt.default_scene(device="cpu")[0],
                          rtt.RenderConfig(xres=8, yres=8, use_raymarching=True))


def test_render_timer_mrays():
    import time

    with RenderTimer(1000, 1000, what="t", emit=False) as t:
        time.sleep(0.01)
    assert t.seconds >= 0.01
    assert 0 < t.mrays_per_s <= 100.0  # 1e6 rays / >=0.01 s


def test_metrics_jsonl():
    buf = io.StringIO()
    m = Metrics(stream=buf)
    m.log(event="step", loss=0.5, step=3)
    m.log(event="render", mrays_per_s=117.0)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines[0]["event"] == "step" and lines[0]["loss"] == 0.5
    assert lines[1]["mrays_per_s"] == 117.0
    assert all("ts" in line for line in lines)


def test_render_timer_emits_metric(monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(profiling, "metrics", Metrics(stream=buf))
    with RenderTimer(10, 10, what="fwd"):
        pass
    rec = json.loads(buf.getvalue())
    assert rec["event"] == "fwd" and rec["xres"] == 10


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the render's CPU operators; on the card
    (chip_smoke.py) its kernels too."""
    scene = rtt.default_scene(device="cpu")[0]
    with device_trace(str(tmp_path)) as prof:
        img = rtt.render_u8(scene, rtt.RenderConfig(xres=8, yres=6, max_refractions=1))
    assert img.shape == (6, 8, 3)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::where" in names
    assert any(e.key == "aten::where" for e in prof.key_averages())
    assert os.listdir(tmp_path) == ["trace.json"]
    np.testing.assert_array_equal(img, rtt.render_u8(scene, rtt.RenderConfig(
        xres=8, yres=6, max_refractions=1)))


@pytest.mark.cuda
def test_cuda_device_trace_holds_k1_in_a_later_session(tmp_path):
    """A profiler session ten seconds after an earlier one: ``device_trace``
    still holds K1 and the pack kernel (a session that stops at once loses
    the card's records there, PERF.md §7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = rtt.default_scene(device="cuda")[0]
    cfg = rtt.RenderConfig(xres=320, yres=240)
    rtt.render_color(scene, cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        rtt.render_color(scene, cfg)
        torch.cuda.synchronize()
    time.sleep(10)
    with device_trace(str(tmp_path)):
        rtt.render_color(scene, cfg)
    trace = json.loads((tmp_path / "trace.json").read_text())
    kernels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    assert any("trace_fwd_kernel" in k for k in kernels), kernels
    assert any("pack_scene_kernel" in k for k in kernels), kernels
