"""Tracing / profiling / observability.

The reference's only instrumentation is an fps readout and a per-iteration
MSE printf (main.cpp:807, 819). Here (SURVEY.md section 5):

- ``PhaseTimer``: wall-clock phase timing with device sync, so numbers mean
  what they say under async dispatch
- ``ThroughputCounter``: pixels/s, Gaussians/s, (splat,pixel)-pairs/s -- the
  BASELINE.json metrics
- ``JsonlLogger``: append-only metrics log (one JSON object per line)
- ``device_trace``: context manager around jax.profiler for XProf traces
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import jax


def sync(tree=None):
    """Wait until the device has computed every array of ``tree``."""
    if tree is not None:
        jax.block_until_ready(tree)


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        sync(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self, log=print):
        for name, s in sorted(self.summary().items()):
            log(f"{name:24s} {s['mean_ms']:9.3f} ms/call  x{s['count']}")


class ThroughputCounter:
    """Derives the BASELINE.json throughput metrics from workload constants."""

    def __init__(self, height: int, width: int, n_splats: int):
        self.pixels = height * width
        self.n_splats = n_splats

    def rates(self, seconds_per_iter: float, sweeps: int = 2) -> dict:
        """sweeps=2 counts forward+backward, matching the reference's two
        full rasterization passes per iteration."""
        return {
            "iters_per_s": 1.0 / seconds_per_iter,
            "pixels_per_s": sweeps * self.pixels / seconds_per_iter,
            "gaussians_per_s": sweeps * self.n_splats / seconds_per_iter,
            "splat_pixel_pairs_per_s":
                sweeps * self.pixels * self.n_splats / seconds_per_iter,
        }


class JsonlLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, **record):
        record.setdefault("t", time.time())
        if self._f:
            self._f.write(json.dumps(record) + "\n")

    def close(self):
        if self._f:
            self._f.close()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture an XProf trace of the enclosed block (view with tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
