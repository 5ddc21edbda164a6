"""Multi-host execution: hosts × devices mesh, per-host ingest.

The reference scales across machines by running one whole-index process
per host (each loading the full ~100 GB FST,
/root/reference/src/commands/prot2kmer2lca.rs:109-114) and splitting the
SAMPLES between them. Here ONE global (host, chip) device mesh forms
via ``jax.distributed`` instead:

* the index is sharded over the flattened host×chip axis — each device
  holds 1/(H*C) of the table in device memory, with no host RAM
  requirement for the index at all;
* reads are data-parallel: each host ingests only its slice of the
  FASTQ inputs (``per_host_groups``) and feeds process-local shards of
  the global batch (``jax.make_array_from_process_local_data``);
* k-mer queries route to owner shards with ``all_to_all`` (within a
  host and across hosts), results route back, aggregation
  stays local to each read's home device, and taxa2freq merges with one
  ``psum`` (parallel/freq.py).

Emulation: every piece here is backend-agnostic — the multi-process
pytest (tests/test_multihost.py) runs 2 CPU processes × 4 virtual
devices each with a real ``jax.distributed`` rendezvous and checks the
global result equals the single-process run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the cross-host runtime (idempotent). The arguments
    may be omitted only where JAX can read the cluster from the
    environment (e.g. a SLURM job); elsewhere pass all three."""
    import jax

    if num_processes is not None and int(num_processes) <= 1:
        return
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError:
        pass  # already initialized


def pod_mesh(host_axis: str = "host", chip_axis: str = "chip"):
    """The global (hosts, devices-per-host) mesh, host-major so each row
    of the device grid is one process's local devices (all_to_all along
    a row crosses hosts, along a column stays on one host)."""
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    per_host = len(devs) // n_proc
    grid = np.array(devs).reshape(n_proc, per_host)
    return Mesh(grid, (host_axis, chip_axis))


def flat_mesh(axis: str = "x"):
    """All global devices on one flat axis (host-major), for components
    that shard over a single axis (the table shards, read batches)."""
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def per_host_groups(groups: Sequence, process_id: int,
                    num_processes: int) -> List:
    """Contiguous per-host slice of the read groups (each host opens and
    parses only its share of the input — the ingest analogue of the
    reference running one sample per machine)."""
    n = len(groups)
    per = (n + num_processes - 1) // num_processes
    return list(groups[process_id * per : (process_id + 1) * per])


def global_batch(local_dna: np.ndarray, local_lengths: np.ndarray,
                 mesh, axis: str = "x"):
    """Assemble process-local read slices into global sharded arrays."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(axis))
    dna = jax.make_array_from_process_local_data(sh, local_dna)
    lengths = jax.make_array_from_process_local_data(sh, local_lengths)
    return dna, lengths


def make_multihost_pipeline(tax, packed: np.ndarray, values: np.ndarray,
                            k: int, config, axis: str = "x"):
    """Build the full multi-host analysis step: global flat mesh, table
    sharded over it, fused pipeline under shard_map.

    Returns (mesh, step) where step(dna, lengths) accepts global arrays
    (see :func:`global_batch`)."""
    from ..agg import device as devagg
    from .sharded import ShardedTable, build_sharded_tables, make_sharded_pipeline

    mesh = flat_mesh(axis)
    n = mesh.devices.size
    dtax = devagg.DeviceTaxonomy.from_host(tax)
    shards = build_sharded_tables(packed, values, k=k, n_shards=n)
    stable = ShardedTable.from_shards(shards, mesh, axis=axis)
    step = make_sharded_pipeline(dtax, stable, config, mesh, axis=axis)
    return mesh, step


def make_multihost_tryptic_pipeline(tax, peptides, values: np.ndarray,
                                    config, axis: str = "x"):
    """The tryptic analogue: peptide fingerprints hash-range sharded
    over the global mesh, digest local, probes routed all-to-all
    (prot2tryp2lca semantics across all hosts)."""
    from ..agg import device as devagg
    from .sharded import (
        ShardedTable,
        build_sharded_peptide_tables,
        make_sharded_tryptic_pipeline,
    )

    mesh = flat_mesh(axis)
    n = mesh.devices.size
    dtax = devagg.DeviceTaxonomy.from_host(tax)
    shards = build_sharded_peptide_tables(peptides, values, n_shards=n)
    stable = ShardedTable.from_shards(shards, mesh, axis=axis)
    step = make_sharded_tryptic_pipeline(dtax, stable, config, mesh,
                                         axis=axis)
    return mesh, step
