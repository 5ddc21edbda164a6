"""Placement of JAX's persistent compilation cache.

A fresh ``analyse`` process otherwise recompiles every program before
its first sample.  The cache lives where ``JAX_COMPILATION_CACHE_DIR``
says; else, run from a checkout, at one fixed path inside it (the path
is part of the cache's identity, so a directory that moves never hits);
else, installed as a package, in the user's cache directory.  A cache
directory that the caller has already configured is left as it is.
"""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_dir() -> str:
    if os.path.exists(os.path.join(REPO, "pyproject.toml")):
        return os.path.join(REPO, ".jax_cache")
    base = (os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "umgap_tpu", "jax")


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir()


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` unless a
    directory is already configured (call before the first compile), and
    return the directory in use."""
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
