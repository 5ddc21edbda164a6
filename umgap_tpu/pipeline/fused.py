"""The fused 9-mer analysis pipeline as a single jitted device program.

Reproduces the composition of the preset 9-mer pipelines
(/root/reference/scripts/umgap-analyse.sh:276-311):

    translate -a | prot2kmer2lca -m -o | seedextend -gG -sS
                 | uniq -d / | taxa2agg -lL [-m rmq -a mrtl | -a ...]

as one XLA computation over a padded batch of read pairs. The reference
runs its precision presets through the external FragGeneScan++ gene
predictor instead of ``translate -a``; FGSpp is out of scope on device
(as in the reference, it is an optional external binary), so all presets
here use the self-contained 6-frame translation front end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..agg import device as devagg
from ..ops import encoding, kmers, lookup, seedextend, translate


class PipelineConfig(NamedTuple):
    """One preset's parameters (umgap-analyse.sh:276-311)."""

    name: str
    k: int = 9
    min_seed_size: int = 2
    max_gap_size: int = 1
    lower_bound: float = 1.0
    method: str = "rmq"
    strategy: str = "mrtl"
    factor: float = 0.25
    table_number: int = 1
    # Per-read unique-taxa capacity for aggregation. Aggregation cost
    # scales O(k_max^2) (ancestor-incidence / branch-sum tensors), so
    # this is deliberately sized for the common case; reads with more
    # distinct hit taxa are detected (``with_overflow``) and re-routed
    # through a wide program by the runner — never silently truncated.
    k_max: int = 64
    # scored seedextend (`-r`, src/commands/seedextend.rs:151-164): keep
    # only the best-scoring extended seed per frame. No preset uses it;
    # available for custom pipelines.
    ranked: bool = False
    penalty: int = 5


PRESETS = {
    "max-sensitivity": PipelineConfig(
        "max-sensitivity", min_seed_size=2, max_gap_size=1, lower_bound=1.0,
        method="rmq", strategy="mrtl"),
    "high-sensitivity": PipelineConfig(
        "high-sensitivity", min_seed_size=3, max_gap_size=1, lower_bound=1.0,
        method="tree", strategy="hybrid", factor=0.25),
    "high-precision": PipelineConfig(
        "high-precision", min_seed_size=3, max_gap_size=1, lower_bound=2.0,
        method="tree", strategy="lca*"),
    "max-precision": PipelineConfig(
        "max-precision", min_seed_size=4, max_gap_size=1, lower_bound=5.0,
        method="tree", strategy="lca*"),
}


def pipeline_step(dna, lengths, dtax: devagg.DeviceTaxonomy,
                  dtable: lookup.DeviceTable, config: PipelineConfig,
                  euler=None, with_overflow: bool = False):
    """One fused batch step.

    Args:
      dna: (B, E, L) uint8 DNA codes (E = reads per group, e.g. 2 ends).
      lengths: (B, E) int32.
      with_overflow: also return a (B,) bool marking reads whose
        distinct surviving taxa exceed ``config.k_max`` (whose result
        may therefore be truncated; the runner re-routes these through
        a wide program).

    Returns:
      taxon: (B,) int32 consensus taxon per read group (1 when no hits
      survive, matching taxa2agg's empty -> "1").
    """
    B, E, L = dna.shape
    table = encoding.get_table(config.table_number)

    # translate all ends x 6 frames
    aa, plens = translate.translate6_batch(
        dna.reshape(B * E, L), lengths.reshape(B * E), table
    )  # (B*E, 6, P), (B*E, 6)

    # k-mer windows + index probe ('-o': misses are 0 within windows)
    hi, lo, wvalid = kmers.pack_windows_batch(aa, plens, config.k)
    taxa, found = lookup.probe(dtable, hi, lo, valid=wvalid, default=0)
    taxa = jnp.where(wvalid, taxa, 0)  # (B*E, 6, W)

    # per-frame seed-extend
    W = taxa.shape[-1]
    nkmers = jnp.maximum(plens - (config.k - 1), 0)  # (B*E, 6)
    if config.ranked:
        keep = seedextend.seedextend_scored_mask_batch(
            taxa, nkmers, dtax.seed_scores, config.penalty,
            config.min_seed_size, config.max_gap_size)
    else:
        keep = seedextend.seedextend_mask_batch(
            taxa, nkmers, config.min_seed_size, config.max_gap_size)
    hits = jnp.where(keep, taxa, 0)

    # uniq -d /: all ends and frames of a read group under one header
    hits = hits.reshape(B, E * 6 * W)

    # taxa2agg: count, filter, aggregate, snap
    utaxa, ucounts, uvalid, nuniq = devagg.dedup_counts(
        hits, jnp.ones_like(hits, jnp.float32), config.k_max,
        return_nuniq=True)
    uvalid = devagg.filter_lower_bound(ucounts, uvalid, config.lower_bound)
    agg = devagg.aggregate_batch(
        dtax, utaxa, ucounts, uvalid, config.method, config.strategy,
        config.factor, euler=euler)
    snapped = devagg.snap_batch(dtax.snap_valid, agg, default=0)
    nonempty = uvalid.any(axis=-1)
    taxon = jnp.where(nonempty, snapped, 1).astype(jnp.int32)
    if with_overflow:
        return taxon, nuniq > config.k_max
    return taxon


def make_pipeline(dtax: devagg.DeviceTaxonomy, dtable: lookup.DeviceTable,
                  config: PipelineConfig, euler=None, wire: str = "codes",
                  with_overflow: bool = False):
    """Jitted (dna, lengths) -> per-read taxon function.

    The table/taxonomy pytrees are jit *arguments* (device-resident),
    not closure constants — closed-over arrays would be embedded in the
    compiled program.

    ``wire='packed4'`` accepts 4-bit packed DNA (two bases per byte,
    :func:`umgap_tpu.ops.encoding.pack_dna4`) plus the unpacked length —
    halving the host->device transfer.

    With ``with_overflow`` the returned function yields
    ``(taxon, overflow)`` (see :func:`pipeline_step`)."""

    if wire == "packed4":

        @functools.partial(jax.jit, static_argnames=("length",))
        def step_p(dna4, lengths, dtable, dtax, euler, length):
            dna = encoding.unpack_dna4_device(dna4, length)
            return pipeline_step(dna, lengths, dtax, dtable, config, euler,
                                 with_overflow=with_overflow)

        return lambda dna4, lengths, length: step_p(
            dna4, lengths, dtable, dtax, euler, length)

    @jax.jit
    def step(dna, lengths, dtable, dtax, euler):
        return pipeline_step(dna, lengths, dtax, dtable, config, euler,
                             with_overflow=with_overflow)

    return lambda dna, lengths: step(dna, lengths, dtable, dtax, euler)
