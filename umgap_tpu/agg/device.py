"""Batched device aggregators (JAX, jittable).

The batched reformulation of the reference's per-read pointer-tree
walks: every read in a batch carries a fixed-width list of (taxon,
count) hits; tree relations are answered by gathers from a device-
resident ancestor-at-depth table; subtree sums and ancestor counts are
masked multiply-reduce contractions over a (B, K, K) ancestor-incidence
tensor; and the hybrid descent is a depth-bounded ``fori_loop``.

Covers the strategies used by all six preset pipelines
(/root/reference/scripts/umgap-analyse.sh:276-311): MRTL (rmq::rtl),
LCA* (tree::lca), and tree hybrid (tree::mix). Argmax ties use the
deterministic break of :mod:`umgap_tpu.agg.host` (greater depth, then
smaller id) so host and device agree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..taxonomy import NONE, Taxonomy

I32_MAX = np.int32(np.iinfo(np.int32).max)


@jax.tree_util.register_pytree_node_class
class DeviceTaxonomy:
    """Device-resident taxonomy arrays (a registered pytree: pass as a
    jit argument, not a closure constant)."""

    def __init__(self, depth, anc, geom, snap_valid, snap_ranked, root: int,
                 seed_scores=None):
        self.depth = depth            # (size,) int32, -1 for unreachable
        self.anc = anc                # (size, D) int32 ancestor-at-depth
        # geom packs [depth, anc row] per taxon so hit_geometry needs ONE
        # row gather per hit instead of a second flat gather for depth
        # (tuned on an earlier accelerator, not yet measured on this card).
        self.geom = geom              # (size, 1 + D) int32
        self.snap_valid = snap_valid  # (size,) int32 snapping (valid)
        self.snap_ranked = snap_ranked  # (size,) int32 (valid+ranked)
        self.root = root
        # (size,) int32 per-taxon seed score, 0 = unscored (None);
        # used only by scored seedextend (src/commands/seedextend.rs:151-164)
        self.seed_scores = (jnp.zeros_like(snap_valid)
                            if seed_scores is None else seed_scores)

    def tree_flatten(self):
        return (self.depth, self.anc, self.geom, self.snap_valid,
                self.snap_ranked, self.seed_scores), (self.root,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:5], aux[0], seed_scores=children[5])

    @classmethod
    def from_host(cls, tax: Taxonomy, device=None) -> "DeviceTaxonomy":
        put = (lambda x: jax.device_put(x, device)) if device else jnp.asarray
        anc = tax.anc_table.astype(np.int32)
        depth = tax.depth.astype(np.int32)
        return cls(
            depth=put(depth),
            anc=put(anc),
            geom=put(np.concatenate([depth[:, None], anc], axis=1)),
            snap_valid=put(tax.snapping(False).astype(np.int32)),
            snap_ranked=put(tax.snapping(True).astype(np.int32)),
            root=int(tax.root),
            seed_scores=put(tax.seed_scores()),
        )


# ---------------------------------------------------------------------- #
# Per-read hit-list preparation
# ---------------------------------------------------------------------- #

def dedup_counts(taxa: jax.Array, weights: jax.Array, k_max: int,
                 return_nuniq: bool = False):
    """Per-row frequency table (reference agg::count + the tid != 0 drop
    of taxa2agg, src/commands/taxa2agg.rs:169).

    Args:
      taxa: (B, N) int32; entries <= 0 are dropped.
      weights: (B, N) float32 per-hit weights.
      k_max: output width. Callers that pick ``k_max`` below the worst
        case should request ``return_nuniq`` and reroute overflowing
        rows through a wider program (see pipeline.runner's fallback) —
        truncation keeps the ``k_max`` smallest ids.
      return_nuniq: also return the per-row count of distinct taxa
        (pre-truncation), for overflow detection.

    Returns:
      utaxa: (B, k_max) int32 unique taxa (I32_MAX padding),
      ucounts: (B, k_max) float32 summed weights,
      uvalid: (B, k_max) bool,
      [nuniq: (B,) int32 when ``return_nuniq``].
    """
    B, N = taxa.shape
    t = jnp.where(taxa > 0, taxa, I32_MAX)
    w = jnp.where(taxa > 0, weights, 0.0)
    # Sort each row by taxon id, run-length count with neighbor compares
    # + a segmented first-value broadcast, then compact the run heads
    # left with a second (small) key-value sort. Everything is sort
    # passes and elementwise scans over (B, N) — no (B, N, K) one-hot
    # materializations (the previous einsum formulation dominated
    # aggregation time at production batch sizes). Output is in
    # ascending-id order (order-independent downstream; the rmq-lca
    # walk's documented pin is ascending ids anyway). When unique > k_max
    # the k_max SMALLEST ids are kept.
    ts, ws = jax.lax.sort((t, w), dimension=-1, num_keys=1)
    prev = jnp.concatenate([jnp.full((B, 1), -1, ts.dtype), ts[:, :-1]],
                           axis=-1)
    valid = ts != I32_MAX
    first = (ts != prev) & valid
    cw = jnp.cumsum(ws, axis=-1)        # inclusive prefix of weights
    ecw = cw - ws                       # exclusive
    wtot = cw[:, -1:]                   # invalid entries carry weight 0
    K = min(k_max, N)
    runidx = jnp.cumsum(first.astype(jnp.int32), axis=-1) - 1  # (B, N)
    # Compact run heads to the left: runidx is unique among `first`
    # positions and ascends with ts, so sorting on it packs
    # (taxon, exclusive-prefix-at-run-start) pairs in ascending-id
    # order. Run r's total is then the DIFFERENCE of consecutive
    # compacted prefixes (next run's start prefix, or the row total for
    # the last run) — no segmented scan needed.
    slotkey = jnp.where(first, runidx, I32_MAX)
    sk, key, basec = jax.lax.sort((slotkey, ts, ecw), dimension=-1,
                                  num_keys=1)
    if N < K + 1:  # room for the one-past-the-end neighbor column
        sk = jnp.pad(sk, ((0, 0), (0, K + 1 - N)), constant_values=I32_MAX)
        key = jnp.pad(key, ((0, 0), (0, K + 1 - N)))
        basec = jnp.pad(basec, ((0, 0), (0, K + 1 - N)))
    nxt_filled = jax.lax.slice_in_dim(sk, 1, K + 1, axis=-1) != I32_MAX
    nxt_base = jax.lax.slice_in_dim(basec, 1, K + 1, axis=-1)
    sk = jax.lax.slice_in_dim(sk, 0, K, axis=-1)
    key = jax.lax.slice_in_dim(key, 0, K, axis=-1)
    base = jax.lax.slice_in_dim(basec, 0, K, axis=-1)
    cntk = jnp.where(nxt_filled, nxt_base, wtot) - base
    filled = sk != I32_MAX
    key = jnp.where(filled, key, I32_MAX)
    if k_max > N:
        pad = ((0, 0), (0, k_max - N))
        key = jnp.pad(key, pad, constant_values=I32_MAX)
        cntk = jnp.pad(cntk, pad)
        filled = jnp.pad(filled, pad)
    out = (key, jnp.where(filled, cntk, 0.0), filled)
    if return_nuniq:
        return out + (jnp.sum(first, axis=-1, dtype=jnp.int32),)
    return out


def filter_lower_bound(ucounts, uvalid, lower_bound: float):
    """agg::filter (src/agg/mod.rs:39-44): keep counts >= bound."""
    return uvalid & (ucounts >= lower_bound)


# ---------------------------------------------------------------------- #
# Shared geometry
# ---------------------------------------------------------------------- #

class HitGeometry(NamedTuple):
    lin: jax.Array      # (B, K, D) ancestor rows
    depth: jax.Array    # (B, K) depths (0 where invalid)
    is_anc: jax.Array   # (B, K, K): [b,i,j] = taxon i anc-or-self of j
    valid: jax.Array    # (B, K)


def hit_geometry(dtax: DeviceTaxonomy, utaxa, uvalid) -> HitGeometry:
    size = dtax.depth.shape[0]
    safe = jnp.where(uvalid, jnp.clip(utaxa, 0, size - 1), 0)
    rows = dtax.geom[safe]                    # (B, K, 1 + D), one gather
    lin = rows[..., 1:]                       # (B, K, D)
    dep = jnp.where(uvalid, rows[..., 0], 0)
    dep = jnp.maximum(dep, 0)
    B, K, D = lin.shape
    # anc_of_j_at_depth_of_i[b, i, j] = lin[b, j, dep[b, i]], computed as a
    # one-hot-depth contraction so it runs as a matrix product instead of
    # a materialized (B, K, K, D) gather. Taxon ids (< 2^24) are exact in
    # f32.
    onehot = (jnp.arange(D, dtype=jnp.int32)[None, None, :] == dep[:, :, None]
              ).astype(jnp.float32)  # (B, K_i, D)
    lin_f = lin.astype(jnp.float32)  # NONE = -1 stays representable
    # Precision.HIGHEST: the values flowing through the product are
    # taxon ids (up to ~2^24) and must stay EXACT. At default precision
    # an H100 may run an f32 matmul in TF32, whose 10-bit mantissa
    # corrupts ids above 2^11 and breaks the ancestor-equality compare
    # (CPU XLA computes true f32, so only accelerator runs diverge).
    a = jnp.einsum("bid,bjd->bij", onehot, lin_f,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    is_anc = (
        (a == utaxa.astype(jnp.float32)[:, :, None])
        & uvalid[:, :, None]
        & uvalid[:, None, :]
    )
    return HitGeometry(lin, dep, is_anc, uvalid)


def _argmax_tiebreak(utaxa, depth, valid, scores):
    """Max score, then max depth, then min taxon id (matches host)."""
    neg = jnp.float32(-jnp.inf)
    s = jnp.where(valid, scores, neg)
    smax = jnp.max(s, axis=-1, keepdims=True)
    cand = valid & (s == smax)
    d = jnp.where(cand, depth, -1)
    dmax = jnp.max(d, axis=-1, keepdims=True)
    cand = cand & (d == dmax)
    ids = jnp.where(cand, utaxa, I32_MAX)
    return jnp.min(ids, axis=-1)


# ---------------------------------------------------------------------- #
# Aggregators
# ---------------------------------------------------------------------- #

def tree_lca_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa):
    """LCA* (reference src/tree/lca.rs): deepest input if all inputs lie
    on one chain, else the LCA of all inputs."""
    B, K, D = geom.lin.shape
    valid = geom.valid
    # dominated j: every valid input is an ancestor-or-self of j
    dom = jnp.all(geom.is_anc | ~valid[:, :, None], axis=1) & valid
    any_dom = dom.any(axis=-1)
    dom_depth = jnp.where(dom, geom.depth, -1)
    jstar = jnp.argmax(dom_depth, axis=-1)
    chain_result = jnp.take_along_axis(utaxa, jstar[:, None], axis=1)[:, 0]

    # LCA of all: deepest depth where all valid lineages agree (!= NONE)
    first_valid = jnp.argmax(valid, axis=-1)  # first True (0 if none)
    ref = jnp.take_along_axis(geom.lin, first_valid[:, None, None], axis=1)[:, 0, :]
    eq = (geom.lin == ref[:, None, :]) | ~valid[:, :, None]
    all_eq = jnp.all(eq, axis=1) & (ref != NONE)
    dstar = jnp.argmax(
        jnp.where(all_eq, jnp.arange(D, dtype=jnp.int32)[None, :], -1), axis=-1
    )
    lca_result = jnp.take_along_axis(ref, dstar[:, None], axis=1)[:, 0]
    return jnp.where(any_dom, chain_result, lca_result)


def rtl_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts):
    """MRTL (reference src/rmq/rtl.rs:39-57): score of input j = summed
    counts of inputs that are ancestors-or-self of j; argmax."""
    c = jnp.where(geom.valid, ucounts, 0.0)
    scores = jnp.sum(
        jnp.where(geom.is_anc, c[:, :, None], 0.0), axis=1
    )  # (B, K) over i
    return _argmax_tiebreak(utaxa, geom.depth, geom.valid, scores)


def tree_mix_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts,
                   factor: float):
    """Tree hybrid (reference src/tree/mix.rs:42-64) as a depth-bounded
    descent: collapse chains freely; at branching nodes descend into the
    heaviest branch while its share of the current chain value is
    >= factor (ties -> smallest branch id, our deterministic break)."""
    B, K, D = geom.lin.shape
    c = jnp.where(geom.valid, ucounts, 0.0)
    total = jnp.sum(c, axis=-1)

    # Hoist the (B, K, K) branch-sum reduces out of the sequential
    # descent: bsumG[b, d, j] = sum of counts of inputs sharing j's
    # ancestor at depth d+1. Equal depth-(d+1) ancestors imply equal
    # depth-d ancestors (unique parents), and lin != NONE encodes
    # "deeper than d", so this equals the in-loop masked branch sum for
    # every j below the current node — one big parallel compare-reduce
    # instead of D-1 serialized ones.
    bt = jnp.moveaxis(geom.lin[:, :, 1:], -1, 1)  # (B, D-1, K)
    bsumG = jnp.sum(
        jnp.where(bt[:, :, :, None] == bt[:, :, None, :],
                  c[:, None, None, :], 0.0),
        axis=-1,
    )  # (B, D-1, K)

    def body(d, state):
        x, a_base, done = state
        lin_d = jax.lax.dynamic_index_in_dim(geom.lin, d, axis=2, keepdims=False)
        branch = jax.lax.dynamic_index_in_dim(geom.lin, d + 1, axis=2,
                                              keepdims=False)  # (B, K)
        below = geom.valid & (branch != NONE) & (lin_d == x[:, None])  # (B, K)
        any_below = below.any(axis=-1)
        bsum = jax.lax.dynamic_index_in_dim(bsumG, d, axis=1, keepdims=False)
        bsum = jnp.where(below, bsum, -jnp.inf)
        maxsum = jnp.max(bsum, axis=-1)
        cand = below & (bsum == maxsum[:, None])
        best_branch = jnp.min(jnp.where(cand, branch, I32_MAX), axis=-1)
        # multiple distinct branches?
        bmin = jnp.min(jnp.where(below, branch, I32_MAX), axis=-1)
        bmax = jnp.max(jnp.where(below, branch, -1), axis=-1)
        multi = any_below & (bmin != bmax)
        # single-branch chain: always descend (no factor test)
        # branching: descend iff NOT (maxsum / a_base < factor)
        ratio_breaks = (maxsum / a_base) < jnp.float32(factor)
        descend = ~done & any_below & (~multi | ~ratio_breaks)
        stop = ~done & (~any_below | (multi & ratio_breaks))
        nx = jnp.where(descend, jnp.where(multi, best_branch, bmin), x)
        na = jnp.where(descend & multi, maxsum, a_base)
        return nx, na, done | stop

    x0 = jnp.full((B,), dtax.root, jnp.int32)
    init = (x0, total, jnp.zeros((B,), bool))
    x, _, _ = jax.lax.fori_loop(0, D - 1, body, init)
    return x


def snap_batch(snapping: jax.Array, taxa: jax.Array, default: int = 0):
    """Gather nearest-snapped ancestors; out-of-range/unsnappable ->
    ``default``."""
    size = snapping.shape[0]
    safe = jnp.clip(taxa, 0, size - 1)
    s = snapping[safe]
    ok = (taxa >= 0) & (taxa < size) & (s != NONE)
    return jnp.where(ok, s, default)


def aggregate_batch(dtax: DeviceTaxonomy, utaxa, ucounts, uvalid,
                    method: str, strategy: str, factor: float = 0.25,
                    euler=None):
    """Dispatch mirroring taxa2agg's full matrix
    (/root/reference/src/commands/taxa2agg.rs:111-140). ``rmq``/``lca*``
    needs a :class:`~umgap_tpu.agg.device_rmq.DeviceEuler`."""
    key = (method, strategy)
    if key == ("rmq", "lca*"):
        from .device_rmq import rmq_lca_batch

        if euler is None:
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        return rmq_lca_batch(euler, utaxa, uvalid)
    if key == ("rmq", "hybrid"):
        from .device_rmq import rmq_mix_batch

        return rmq_mix_batch(dtax, utaxa, ucounts, uvalid, factor)
    geom = hit_geometry(dtax, utaxa, uvalid)
    if key == ("tree", "lca*"):
        return tree_lca_batch(dtax, geom, utaxa)
    if key == ("tree", "hybrid"):
        return tree_mix_batch(dtax, geom, utaxa, ucounts, factor)
    if key == ("rmq", "mrtl"):
        return rtl_batch(dtax, geom, utaxa, ucounts)
    raise ValueError(f"device aggregation does not support {method}/{strategy}")
