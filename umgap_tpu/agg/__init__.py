"""Per-read consensus aggregation.

Five aggregator strategies matching the reference's method×strategy matrix
(reference /root/reference/src/commands/taxa2agg.rs:111-140):

- ``tree_lca``  — LCA* (tree collapse), ``src/tree/lca.rs``
- ``tree_mix``  — hybrid LCA*/MRTL, ``src/tree/mix.rs``
- ``rmq_lca``   — RMQ-based LCA walk with join levels, ``src/rmq/lca.rs``
- ``rmq_rtl``   — maximal root-to-leaf path, ``src/rmq/rtl.rs``
- ``rmq_mix``   — hybrid LCA/MRTL over the LCA closure, ``src/rmq/mix.rs``

``host`` holds exact (numpy) oracles used for parity and as golden
references; ``device`` holds the batched JAX formulations used by the
fused pipelines (masked matmuls over per-read lineage matrices — the
batched redesign of the reference's pointer-tree walks).
"""

from .host import (  # noqa: F401
    AggError,
    EmptyInputError,
    UnknownTaxonError,
    HostAggregator,
    TreeLCA,
    TreeMix,
    RmqLCA,
    RmqRTL,
    RmqMix,
    count,
    filter_counts,
    make_aggregator,
)
