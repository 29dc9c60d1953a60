"""Timing harness.

The reference planned one (include/utils/timer.h) but left it a 0-byte
placeholder and ships no timing code at all (SURVEY §5/§6); this fills the
gap with device-synchronized wall-clock measurement for jitted functions.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import jax
import numpy as np


class Timer:
    """Accumulating named wall-clock timer with block_until_ready fencing."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            jax.block_until_ready(fence)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            lines.append(f"{k}: {self.totals[k] * 1e3:.2f} ms "
                         f"({self.counts[k]} calls)")
        return "\n".join(lines)


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median steady-state seconds/call of a jitted function; each call is
    fenced with jax.block_until_ready."""
    return float(np.median(time_calls(fn, *args, iters=iters,
                                      warmup=warmup)))


def time_calls(fn: Callable, *args, iters: int = 5, warmup: int = 1
               ) -> List[float]:
    """Wall-clock seconds of `iters` calls after `warmup` calls, each call
    fenced with jax.block_until_ready (dispatch is asynchronous)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times
