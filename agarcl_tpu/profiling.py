"""Tracing / profiling utilities (SURVEY §5: the reference has no internal
tracing — its harness is google-benchmark + ad-hoc SPS prints; the JAX
equivalents are jax.profiler traces and per-step device-time metrics).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import time
from typing import Callable, Optional

import jax


def gpu_name_and_power_limit() -> Optional[str]:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card), or None where there is no nvidia-smi. A card
    set below its maximum power runs slower under load, so every device
    number is reported with this line."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


_DEFAULT_TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".traces")


@contextlib.contextmanager
def trace(log_dir: str = _DEFAULT_TRACE_DIR):
    """Capture a jax.profiler trace of the enclosed block (view with
    TensorBoard or Perfetto); by default into <repo>/.traces."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Steps/sec + device-time bookkeeping for env loops (the reference's SPS
    accounting, go_bigger_example.py:113-116, done properly: block on device
    results, exclude compile)."""

    def __init__(self):
        self.steps = 0
        self.envs = 0
        self._t0 = None
        self.history = []

    def start(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.envs = 0

    def tick(self, num_envs: int, result=None):
        if result is not None:
            jax.block_until_ready(result)
        self.steps += 1
        self.envs += num_envs

    def stop(self) -> dict:
        dt = time.perf_counter() - self._t0
        out = dict(seconds=dt, calls=self.steps, env_steps=self.envs,
                   env_steps_per_sec=self.envs / dt if dt > 0 else 0.0)
        self.history.append(out)
        return out


def device_time_of(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                   **kw) -> float:
    """Median wall time per call of a jitted fn with device sync."""
    times = []
    out = None
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
