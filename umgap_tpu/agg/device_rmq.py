"""Device versions of the RMQ-based aggregators.

``rmq_lca_batch`` reproduces the reference's Euler-tour RMQ walk with
join levels (/root/reference/src/rmq/lca.rs:60-90) *position-exactly*:
the device carries the same tour/block-min/sparse tables as the host
:class:`umgap_tpu.agg.rmq.RMQ` (block size 64, identical tie rules), and
a ``lax.scan`` advances every read's walk in lockstep. Hit lists are
visited in ascending-taxon order (the reference order is HashMap-random;
see agg.host.RmqLCA).

``rmq_mix_batch`` computes the LCA-closure hybrid
(src/rmq/mix.rs:55-95) in taxon space: pairwise LCAs via lineage
agreement counts (tree-prefix property makes agreement a plain
depth-sum), closure weights via one-hot einsum contractions.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..taxonomy import NONE, Taxonomy
from .device import DeviceTaxonomy, I32_MAX, _argmax_tiebreak
from .rmq import BLOCK, RMQ, _LOG2_BLOCK


@jax.tree_util.register_pytree_node_class
class DeviceEuler:
    """Euler tour + RMQ tables on device (registered pytree)."""

    def __init__(self, tour, depths, first, block_min, sparse,
                 nlevels: int, tour_len: int):
        self.tour = tour            # (T,) int32 taxon ids
        self.depths = depths        # (T,) int32
        self.first = first          # (size,) int32 first occurrence (-1)
        self.block_min = block_min  # (nb,) int32 argmin per block
        self.sparse = sparse        # (L, nb) int32 sparse argmin table
        self.nlevels = nlevels
        self.tour_len = tour_len

    def tree_flatten(self):
        return (self.tour, self.depths, self.first, self.block_min,
                self.sparse), (self.nlevels, self.tour_len)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, tax: Taxonomy) -> "DeviceEuler":
        tour, depths, first = tax.euler_tour()
        rmq = RMQ(depths)
        nb = len(rmq.block_min)
        levels = rmq.sparse
        L = max(len(levels), 1)
        sparse = np.zeros((L, nb), dtype=np.int32)
        for j, lv in enumerate(levels):
            sparse[j, : len(lv)] = lv
        return cls(
            jnp.asarray(tour, jnp.int32),
            jnp.asarray(depths, jnp.int32),
            jnp.asarray(first, jnp.int32),
            jnp.asarray(rmq.block_min, jnp.int32),
            jnp.asarray(sparse),
            len(levels),
            len(tour),
        )


def _min_in_block(euler: DeviceEuler, left, right):
    """Leftmost argmin of depths[left..=right] within one 64-block.
    left/right: (B,) indices."""
    base = (left >> _LOG2_BLOCK) << _LOG2_BLOCK
    offs = jnp.arange(BLOCK, dtype=jnp.int32)[None, :]
    idx = jnp.clip(base[:, None] + offs, 0, euler.tour_len - 1)
    d = jnp.take(euler.depths, idx, axis=0)
    inside = (base[:, None] + offs >= left[:, None]) & (
        base[:, None] + offs <= right[:, None])
    d = jnp.where(inside, d, jnp.int32(np.iinfo(np.int32).max))
    return base + jnp.argmin(d, axis=-1).astype(jnp.int32)


def rmq_query_batch(euler: DeviceEuler, start, end):
    """Reference RMQ::query position semantics, batched
    (src/rmq/mod.rs:121-156 / agg.rmq.RMQ.query)."""
    left = jnp.minimum(start, end)
    right = jnp.maximum(start, end)
    dep = euler.depths
    lblock = left >> _LOG2_BLOCK
    rblock = right >> _LOG2_BLOCK
    bdiff = rblock - lblock

    l = _min_in_block(euler, left, (lblock << _LOG2_BLOCK) + (BLOCK - 1))
    r = _min_in_block(euler, rblock << _LOG2_BLOCK, right)

    # middle candidate for bdiff >= 2
    m2 = jnp.take(euler.block_min, jnp.clip(lblock + 1, 0,
                                            euler.block_min.shape[0] - 1))
    # exact intlog2 via count-leading-zeros
    v = jnp.maximum(bdiff - 1, 1)
    ilog = (31 - jnp.clip(
        jax.lax.clz(v.astype(jnp.uint32)).astype(jnp.int32), 0, 31))
    kk = jnp.clip(ilog - 1, 0, max(euler.nlevels - 1, 0))
    nb = euler.block_min.shape[0]
    t1 = euler.sparse[kk, jnp.clip(lblock + 1, 0, nb - 1)]
    t2 = euler.sparse[kk, jnp.clip(rblock - (1 << (kk + 1)), 0, nb - 1)]
    tmid = jnp.where(dep[t1] <= dep[t2], t1, t2)
    m = jnp.where(bdiff == 2, m2, tmid)

    ex = jnp.where(dep[l] <= dep[m], l, m)
    multi = jnp.where(dep[ex] <= dep[r], ex, r)
    two = jnp.where(dep[l] <= dep[r], l, r)
    one = _min_in_block(euler, left, right)
    out = jnp.where(bdiff == 0, one, jnp.where(bdiff == 1, two, multi))
    return jnp.where(start == end, start, out)


def rmq_lca_batch(euler: DeviceEuler, utaxa, uvalid):
    """The join-level LCA walk over per-read hit lists (ascending taxon
    order, which is how dedup_counts emits them)."""
    B, K = utaxa.shape
    size = euler.first.shape[0]
    safe = jnp.where(uvalid, jnp.clip(utaxa, 0, size - 1), 0)
    occ = jnp.take(euler.first, safe, axis=0)  # (B, K)
    occ = jnp.maximum(occ, 0)  # absent taxa: clamp (result is masked)
    # initial consensus: the first VALID slot — slot 0 may have been
    # filtered (e.g. lower_bound), and taxon id 0 can be a REAL taxon,
    # so seeding blindly from occ[:, 0] would walk a filtered hit.
    # (The seed slot re-appears in the scan; joining a node with itself
    # is a no-op, so no double-count.)
    first_valid = jnp.argmax(uvalid, axis=-1)
    consensus = jnp.take_along_axis(occ, first_valid[:, None], axis=1)[:, 0]
    join_level = jnp.full((B,), -1, jnp.int32)  # -1 = None

    def step(carry, inputs):
        consensus, join_level = carry
        nxt, valid = inputs
        rmq = rmq_query_batch(euler, consensus, nxt)
        dep = euler.depths
        neither = (rmq != consensus) & (rmq != nxt)
        lca = jnp.where(neither, rmq, jnp.where(rmq == consensus, nxt, consensus))
        level = jnp.where(neither, dep[rmq], join_level)
        # join below the join level cannot lower it
        demote = (join_level >= 0) & (dep[lca] > join_level)
        lca = jnp.where(demote, rmq, lca)
        skip = ~valid | (consensus == nxt)
        new_consensus = jnp.where(skip, consensus, lca)
        new_level = jnp.where(skip, join_level, level)
        return (new_consensus, new_level), None

    xs = (occ[:, 1:].T, uvalid[:, 1:].T)
    (consensus, _), _ = jax.lax.scan(step, (consensus, join_level), xs)
    return jnp.take(euler.tour, consensus, axis=0)


def rmq_mix_batch(dtax: DeviceTaxonomy, utaxa, ucounts, uvalid, factor: float):
    """LCA-closure hybrid in taxon space (exact: weights depend only on
    ancestor relations)."""
    B, K = utaxa.shape
    size = dtax.depth.shape[0]
    safe = jnp.where(uvalid, jnp.clip(utaxa, 0, size - 1), 0)
    lin = dtax.anc[safe]  # (B, K, D)
    D = lin.shape[-1]
    c = jnp.where(uvalid, ucounts, 0.0)

    # pairwise lineage agreement counts (prefix-closed on a tree)
    def agree_body(d, acc):
        col = jax.lax.dynamic_index_in_dim(lin, d, axis=2, keepdims=False)
        ok = (col[:, :, None] == col[:, None, :]) & (col != NONE)[:, :, None]
        return acc + ok.astype(jnp.int32)

    agree = jax.lax.fori_loop(
        0, D, agree_body, jnp.zeros((B, K, K), jnp.int32))

    # lca[b,i,j] = lin[b, i, agree-1]
    def lca_body(d, acc):
        col = jax.lax.dynamic_index_in_dim(lin, d, axis=2, keepdims=False)
        return jnp.where(agree - 1 == d, col[:, :, None], acc)

    pair_lca = jax.lax.fori_loop(
        0, D, lca_body, jnp.zeros((B, K, K), jnp.int32))
    pairvalid = uvalid[:, :, None] & uvalid[:, None, :]

    # candidates = inputs + all pairwise LCAs, deduped to 2K slots
    cands = jnp.concatenate(
        [jnp.where(uvalid, utaxa, I32_MAX).reshape(B, K),
         jnp.where(pairvalid, pair_lca, I32_MAX).reshape(B, K * K)],
        axis=1)
    cs = jnp.sort(cands, axis=-1)
    prev = jnp.concatenate([jnp.full((B, 1), -1, cs.dtype), cs[:, :-1]], axis=-1)
    first = (cs != prev) & (cs != I32_MAX)
    key = jnp.where(first, cs, I32_MAX)
    key = jnp.sort(key, axis=-1)[:, : 2 * K]  # closure size <= 2K - 1
    cvalid = key != I32_MAX

    csafe = jnp.where(cvalid, jnp.clip(key, 0, size - 1), 0)
    clin = dtax.anc[csafe]           # (B, C, D)
    cdep = jnp.maximum(jnp.where(cvalid, dtax.depth[csafe], 0), 0)
    idep = jnp.maximum(jnp.where(uvalid, dtax.depth[safe], 0), 0)

    # cand i ancestor-or-self of input j: lin_input[j, depth_c[i]] == cand[i]
    onehot_c = (jnp.arange(D, dtype=jnp.int32)[None, None, :]
                == cdep[:, :, None]).astype(jnp.float32)
    # Precision.HIGHEST: taxon ids through the product must stay exact
    # (default f32 matmuls may run in TF32 — see agg/device.py)
    a = jnp.einsum("bid,bjd->bij", onehot_c, lin.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    c_anc_i = (a == key.astype(jnp.float32)[:, :, None]) \
        & cvalid[:, :, None] & uvalid[:, None, :]
    # input j ancestor-or-self of cand i: lin_c[i, depth_in[j]] == input[j]
    onehot_i = (jnp.arange(D, dtype=jnp.int32)[None, None, :]
                == idep[:, :, None]).astype(jnp.float32)
    a2 = jnp.einsum("bjd,bid->bji", onehot_i, clin.astype(jnp.float32),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    i_anc_c = (a2 == jnp.where(uvalid, utaxa, -2).astype(jnp.float32)[:, :, None]) \
        & uvalid[:, :, None] & cvalid[:, None, :]

    lca_w = jnp.sum(jnp.where(c_anc_i, c[:, None, :], 0.0), axis=-1)  # (B, C)
    rtl_w = jnp.sum(jnp.where(i_anc_c, c[:, :, None], 0.0), axis=1)   # (B, C)
    f = jnp.float32(factor)
    scores = lca_w * f + rtl_w * (jnp.float32(1.0) - f)
    return _argmax_tiebreak(key, cdep, cvalid, scores)
