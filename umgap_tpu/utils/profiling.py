"""Per-stage timing and device tracing.

``StageTimer`` accumulates host wall-time per named stage — the
structured replacement for the reference's absent profiling story.
Dispatch is asynchronous, so a stage that must include device time ends
in ``jax.block_until_ready``.
``device_trace`` wraps ``jax.profiler.trace`` so a pipeline run can be
inspected in xprof/TensorBoard when a trace dir is given (or via the
UMGAP_TRACE_DIR env var).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Iterator, Optional


class StageTimer:
    """Accumulating wall timers keyed by stage name.

    >>> t = StageTimer()
    >>> with t.stage("probe"):
    ...     pass
    >>> _ = t.report()
    """

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(
                f"{name:24s} {total * 1e3:10.2f} ms total"
                f"  ({n} calls, {total / n * 1e3:.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """JAX profiler trace context; no-op when no directory is
    configured (arg or UMGAP_TRACE_DIR)."""
    trace_dir = trace_dir or os.environ.get("UMGAP_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
