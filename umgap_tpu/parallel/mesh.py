"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (reads and table
    shards both ride this axis). Every device reaches every other at
    the same rate over NVLink, so the mesh follows the algorithm alone."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))
