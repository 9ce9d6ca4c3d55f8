"""Per-stage timing + ray-throughput telemetry.

The reference's only observability is FPS + samples every 5 s
(GLRenderer.cpp:183-187) and frame-0 queue counts (OptixBackend.cpp:
1690-1695).  This module adds what SURVEY.md §5 prescribes: wall-clock stage
timing that waits for the device, and rays/sec accounting derived from the
wavefront's per-bounce live counts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import jax
import numpy as np


class StageTimer:
    """Accumulating wall-clock timer.  Dispatch is asynchronous, so a stage
    given `block_on` waits for those arrays (jax.block_until_ready) before
    its clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1000:9.2f} ms total "
                         f"({total/n*1000:8.2f} ms x {n})")
        return "\n".join(lines)


class RayThroughput:
    """Rays/sec accounting from WavefrontStats (+1 shadow ray per surviving
    surface lane per light — a conservative lower bound; see bench.py)."""

    def __init__(self, n_lights: int = 1):
        self.n_lights = n_lights
        self.total_rays = 0
        self.t0 = time.perf_counter()
        self._frames: List[int] = []

    def add_frame(self, stats) -> None:
        rays = np.asarray(stats.rays_per_bounce, np.int64)
        n = int(rays.sum())
        if self.n_lights and rays.size > 1:
            n += int(rays[1:].sum()) * self.n_lights
        self.total_rays += n
        self._frames.append(n)

    @property
    def mrays_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.total_rays / max(dt, 1e-9) / 1e6

    def report(self) -> str:
        return (f"{self.total_rays/1e6:.2f} Mrays over {len(self._frames)} "
                f"frames -> {self.mrays_per_sec:.1f} Mrays/s")
