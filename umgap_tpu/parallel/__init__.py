"""Multi-device distribution.

The reference's parallelism is OS processes, rayon threads, and one Unix
socket (SURVEY.md §2.5); here the multi-device equivalents are JAX
collectives over a device mesh: reads are data-parallel across the mesh,
the k-mer table is sharded across it (the ~100 GB 9-mer index cannot
live on one device), probes are routed to owner shards with ``all_to_all``
and returned the same way, and sample-level frequency tables merge with
``psum``.
"""

from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedAnalyser,
    ShardedTable,
    build_sharded_peptide_tables,
    build_sharded_tables,
    make_sharded_pipeline,
    make_sharded_stream_analyser,
    make_sharded_tryptic_pipeline,
)
from .multihost import (  # noqa: F401
    flat_mesh,
    global_batch,
    init_distributed,
    make_multihost_pipeline,
    per_host_groups,
    pod_mesh,
)
from .freq import sharded_rank_counts, sharded_taxa2freq_csv  # noqa: F401
