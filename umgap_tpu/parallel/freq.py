"""Distributed taxa2freq: full-rank-space frequency tables on the mesh.

The reference's taxa2freq (src/commands/taxa2freq.rs:154-169) snaps each
input taxon to its ancestor at the target rank (root when none) and
counts per input file, emitting a CSV sorted by descending total. Here
the counting runs sharded: each device snaps + bincounts its slice of
the taxa over the FULL taxon id space (not a demo-sized clip) and the
per-device vectors merge with one ``psum`` over the mesh axis — the
device analogue of merging per-process count HashMaps.

The final CSV is produced by :func:`umgap_tpu.cli.format_freq_csv`, the
same function the host command uses, so sharded and host outputs are
byte-identical (tested in tests/test_sharded_freq.py).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..taxonomy import NONE, Taxonomy


def _pad_to(x: np.ndarray, n: int, fill: int) -> np.ndarray:
    return np.pad(x, (0, n - len(x)), constant_values=fill) if len(x) < n else x


def sharded_rank_counts(
    tax: Taxonomy, rank: int, files_taxa: Sequence[np.ndarray],
    mesh: Mesh, axis: str = "x",
) -> np.ndarray:
    """Count rank-snapped taxa per input file across the mesh.

    Args:
      files_taxa: one int array of taxon ids per input file (the parsed
        numeric lines; non-numeric lines are dropped by the caller,
        matching the reference's silent skip, taxa2freq.rs:160).

    Returns:
      (n_files, tax.size) int64 counts; column 0 holds taxa that snap to
      nothing (the reference's `.unwrap_or(0)`).
    """
    n = mesh.devices.size
    snapping = tax.rank_snapping(rank)  # host (size,) int, NONE for none
    snap_dev = jax.device_put(
        np.where(snapping == NONE, 0, snapping).astype(np.int32),
        NamedSharding(mesh, P()))
    size = tax.size

    from jax import shard_map

    def local_count(taxa, valid, snap):
        snapped = jnp.where(valid, snap[jnp.clip(taxa, 0, size - 1)], 0)
        ones = jnp.where(valid, 1, 0).astype(jnp.int32)
        counts = jax.ops.segment_sum(ones, snapped, num_segments=size)
        return jax.lax.psum(counts, axis)

    fn = jax.jit(shard_map(
        local_count, mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    ))

    out = np.zeros((len(files_taxa), size), dtype=np.int64)
    for i, taxa in enumerate(files_taxa):
        taxa = np.asarray(taxa, dtype=np.int64)
        in_range = (taxa >= 0) & (taxa < size)
        padded_len = max(((len(taxa) + n - 1) // n) * n, n)
        t = _pad_to(np.clip(taxa, 0, size - 1).astype(np.int32), padded_len, 0)
        v = _pad_to(in_range, padded_len, False)
        sharding = NamedSharding(mesh, P(axis))
        counts = fn(jax.device_put(t, sharding), jax.device_put(v, sharding),
                    snap_dev)
        out[i] = np.asarray(counts)
        # taxa beyond the table count toward the unknown column 0
        # (host: snapping lookup fails -> 0); negatives are skipped
        # entirely (host: `if t < 0: continue`)
        out[i, 0] += int((taxa >= size).sum())
    return out


def sharded_taxa2freq_csv(
    tax: Taxonomy, rank: int, files_taxa: Sequence[np.ndarray],
    col_names: List[str], mesh: Mesh, axis: str = "x",
    min_frequency: int = 1,
) -> str:
    """Full sharded taxa2freq: device counting + the host CSV formatter
    (byte-identical to the CLI command)."""
    from ..cli import format_freq_csv

    mat = sharded_rank_counts(tax, rank, files_taxa, mesh, axis)
    counts = {}
    nz = np.flatnonzero(mat.sum(axis=0))
    for tid in nz:
        counts[int(tid)] = [int(mat[f, tid]) for f in range(len(files_taxa))]
    return format_freq_csv(tax, counts, col_names, min_frequency)
