"""Timing, device traces and structured metrics.

PyTorch-port counterpart of ``ray_rust_tpu/utils/profiling.py``: the
reference's only instrumentation is a wall-clock print (src/main.rs:316,
343-348), which the CLI keeps; this adds :class:`RenderTimer` (primary
rays per second around a render), :func:`device_trace` (a ``torch.profiler``
trace of the CPU and the card, exported for Perfetto or
``chrome://tracing``) and :class:`Metrics` (JSON lines).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch

__all__ = ["RenderTimer", "device_trace", "Metrics", "metrics"]


class RenderTimer:
    """Context manager timing a render by the host's clock and deriving
    primary rays per second. On leaving it waits for the card where CUDA
    has been initialised, so the time covers the finished work, as the JAX
    caller's ``block_until_ready`` does.

    >>> with RenderTimer(1920, 1080, what="fwd") as t:
    ...     render_color(scene, cfg)
    >>> t.mrays_per_s
    """

    def __init__(self, xres: int, yres: int, what: str = "render", emit: bool = True):
        self.xres, self.yres, self.what, self.emit = xres, yres, what, emit
        self.seconds: Optional[float] = None

    def __enter__(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # work enqueued before the block is not its own
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        if self.emit and exc[0] is None:
            metrics.log(event=self.what, seconds=round(self.seconds, 6), xres=self.xres,
                        yres=self.yres, mrays_per_s=round(self.mrays_per_s, 3))

    @property
    def mrays_per_s(self) -> float:
        """Primary rays per second (W·H / seconds / 1e6)."""
        if not self.seconds:
            return 0.0
        return self.xres * self.yres / self.seconds / 1e6


_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# seconds the session waits before the block (CUPTI records the card only
# some time after a later session starts) and after it (so that CUPTI hands
# over the card's records before the session stops)
SETTLE_S = 2.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, CPU and CUDA activities
    (CUDA where the card is there), exported as a Chrome trace to
    ``log_dir/trace.json``; yields the profiler, whose ``key_averages()``
    sum the time by kernel.

    With CUDA the session waits ``SETTLE_S`` seconds before the block and
    again after it (after one fill kernel of the trace's own and a wait for
    the card): on torch 2.11 with CUDA 12.8 a session that is not the
    process's first loses the card's records of its first moments, and
    without the wait at its end some or all of the rest (PERF.md §7).
    Raises ``RuntimeError`` when the trace still holds no activity of the
    card, rather than return a trace without it."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        yield prof
        if cuda:
            torch.empty(1, device="cuda").fill_(0)  # the trace's own kernel
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if not any(e.get("cat") in _DEVICE_CATEGORIES for e in events):
            raise RuntimeError(f"device_trace: {path} holds no activity of the card")


class Metrics:
    """Structured JSON-lines metrics (rays/s, step time, loss, ...), one line
    an event: ``{"ts": ..., "event": ..., **fields}``. Writes to stderr
    unless given a stream or a file."""

    def __init__(self, stream=None):
        self._stream = stream

    def to_file(self, path: str) -> "Metrics":
        self._stream = open(path, "a", buffering=1)
        return self

    def log(self, event: str = "metric", **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event}
        rec.update(fields)
        print(json.dumps(rec), file=self._stream or sys.stderr, flush=True)


metrics = Metrics()
