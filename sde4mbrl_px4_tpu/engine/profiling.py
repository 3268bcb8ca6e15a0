"""Profiling helpers (L5 aux).

The reference's only instrumentation is manual wall-clock timing exported
through OptMPCState (SURVEY.md §5 "Tracing/profiling"). This module keeps
that telemetry as the stable schema and adds device tooling on top:

- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace of whatever runs inside;
- :class:`SolveTimer` — rolling per-solve latency statistics (p50/p99,
  jitter) matching what the driver's bench reports.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

__all__ = ["trace", "SolveTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Device-level profiler trace: ``with trace("/tmp/t"): solve(...)``.

    View with TensorBoard's profile plugin or xprof, or read the
    ``.xplane.pb`` with ``jax.profiler.ProfileData``. A profiler that
    cannot start raises: a timing window that silently traced nothing
    would read as an empty (idle) device.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class SolveTimer:
    """Rolling solve-latency tracker (the ``solve_time`` telemetry field,
    reference ``msg/OptMPCState.msg:23-24``, with percentile stats)."""

    def __init__(self, window: int = 256):
        self.samples: Deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        return False

    @property
    def last(self) -> float:
        return self.samples[-1] if self.samples else 0.0

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {"n": 0}
        a = np.asarray(self.samples)
        return {
            "n": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }
