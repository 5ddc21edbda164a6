"""Shared utilities: logging, stage timing, and device tracing.

The reference has no in-process observability beyond stderr logging
gated on VERBOSE/DEBUG in its shell scripts
(/root/reference/scripts/umgap-analyse.sh:64-73). This package gives
the JAX pipeline the pieces the reference lacks: structured stderr
logging with the same env-var gating, per-stage wall timers, a JAX
profiler trace context for xprof, and the placement of the persistent
compilation cache.
"""

from .compile_cache import compile_cache_dir, enable_compile_cache
from .logging import debug, log, verbose
from .profiling import StageTimer, device_trace

__all__ = [
    "compile_cache_dir",
    "enable_compile_cache",
    "debug",
    "log",
    "verbose",
    "StageTimer",
    "device_trace",
]
