"""jax.profiler convenience wrappers (Perfetto/XPlane traces).

Fills the reference's missing tracing subsystem (SURVEY §5: `timer.h` empty,
no profiling anywhere).
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace around a block:

        with profiler.trace("traces/roundtrip"):
            ctx.roundtrip(...)
    View with xprof / tensorboard or ui.perfetto.dev.
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation
