"""Seed-and-extend filtering of per-frame taxon ID sequences.

Reimplements the reference's run-length state machine
(/root/reference/src/commands/seedextend.rs:96-178) exactly on the host,
and as a vectorized batch formulation on device.

Semantics (with ``s`` = min seed size, ``g`` = max gap size):

- the taxon sequence is runs of equal ids; runs of id 0 are "gaps";
- an *extended seed* is a maximal stretch of non-zero runs joined by
  gaps of length <= g (a longer gap, or the sequence edge, ends it;
  leading gaps never start one, and a trailing gap is trimmed);
- the extended seed is kept iff its longest non-zero run is >= s;
- kept stretches' taxa (including interior gap zeros) are emitted in
  order. In scored mode (a taxonomy is given), only the stretch with the
  highest summed rank score is kept (ties: the reference's max_by_key
  keeps the *last* maximum), where each taxon scores via
  TaxonList::score (src/taxon.rs:181-191) and unscored taxa cost the
  gap penalty.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


from ..taxonomy import Taxonomy


def seedextend_host(
    taxa: Sequence[int],
    min_seed_size: int = 2,
    max_gap_size: int = 0,
) -> List[Tuple[int, int]]:
    """Exact transliteration of the reference state machine. Returns
    (start, end) half-open index ranges into ``taxa``."""
    taxons = list(taxa) + [0]  # sentinel (src/commands/seedextend.rs:99)
    seeds: List[Tuple[int, int]] = []
    start, end = 0, 1
    last_tid = taxons[start]
    same_tid = 1
    same_max = 1
    while end < len(taxons):
        if last_tid == taxons[end]:
            same_tid += 1
            end += 1
            continue
        if last_tid == 0 and same_tid > max_gap_size:
            if same_max >= min_seed_size:
                seeds.append((start, end - same_tid))
            start = end
            last_tid = taxons[end]
            same_tid = 1
            same_max = 1
            end += 1
            continue
        if last_tid == 0 and (end - start) == same_tid:
            end += 1
            start = end
            continue
        if last_tid != 0:
            same_max = max(same_max, same_tid)
        last_tid = taxons[end]
        same_tid = 1
        end += 1
    if same_max >= min_seed_size:
        if last_tid == 0:
            end -= same_tid
        seeds.append((start, end))
    return seeds


def select_best_seed(
    taxa: Sequence[int],
    seeds: List[Tuple[int, int]],
    tax: Taxonomy,
    penalty: int = 5,
) -> List[Tuple[int, int]]:
    """Scored mode (src/commands/seedextend.rs:151-164): keep only the
    best-scoring extended seed. Ties keep the last (Rust max_by_key)."""
    if not seeds:
        return []
    taxons = list(taxa) + [0]
    best = None
    best_score = None
    for (s, e) in seeds:
        score = 0
        for t in taxons[s:e]:
            sc = tax.score(t) if 0 <= t < tax.size else None
            score += sc if sc is not None else penalty
        if best_score is None or score >= best_score:
            best, best_score = (s, e), score
    return [best]


def apply_seedextend(
    taxa: Sequence[int],
    min_seed_size: int = 2,
    max_gap_size: int = 0,
    tax: Optional[Taxonomy] = None,
    penalty: int = 5,
) -> List[int]:
    """Full command behavior: concatenated taxa of all kept seeds."""
    seeds = seedextend_host(taxa, min_seed_size, max_gap_size)
    if tax is not None:
        seeds = select_best_seed(taxa, seeds, tax, penalty)
    out: List[int] = []
    taxons = list(taxa) + [0]
    for (s, e) in seeds:
        out.extend(taxons[s:e])
    return out


# ---------------------------------------------------------------------- #
# Batched device formulation
# ---------------------------------------------------------------------- #

def seedextend_mask_batch(taxa, lengths, min_seed_size: int = 2,
                          max_gap_size: int = 0):
    """Vectorized seed-extend over a padded batch: returns a keep-mask.

    Args:
      taxa: (..., N) int32 taxon ids, 0 = miss/gap; padding beyond
        ``lengths`` is ignored (treated as 0).
      lengths: (...) int32 valid lengths.

    Returns:
      keep: (..., N) bool — positions inside kept extended seeds.

    Formulation: the reference's sequential state machine is inherently
    order-dependent (including its realized leading-gap quirks,
    src/commands/seedextend.rs:122-127), so we run it as a ``lax.scan``
    over positions with every (read, frame) lane advancing in lockstep —
    ~N scan steps of cheap VPU selects, batch-parallel. Seed pushes are
    recorded as +1/-1 boundary deltas; a final cumulative sum turns them
    into the keep-mask. Appending the sentinel 0 and zero-padding lanes
    to a common length provably leaves push positions unchanged (all
    trailing zeros fold into the trailing-gap trim).
    """
    import jax.numpy as jnp
    from jax import lax

    t = jnp.asarray(taxa, dtype=jnp.int32)
    N = t.shape[-1]
    lanes = t.shape[:-1]
    pos = jnp.arange(N, dtype=jnp.int32)
    inside = pos < lengths[..., None]
    t = jnp.where(inside, t, 0)
    # taxons with sentinel (position N is 0)
    tx = jnp.concatenate([t, jnp.zeros(lanes + (1,), jnp.int32)], axis=-1)

    s = jnp.int32(min_seed_size)
    g = jnp.int32(max_gap_size)
    (pushes, pstarts, pstops), (f_push, f_start, f_stop) = _scan_seeds(
        tx, N, lanes, s, g)

    # boundary deltas -> mask (one-hot matmul)
    def deltas(push, pstart, pstop):
        # (..., N) increments at pstart, decrements at pstop (clipped)
        inc = (pos == pstart[..., None]) & push[..., None]
        dec = (pos == pstop[..., None]) & push[..., None]
        return inc.astype(jnp.int32) - dec.astype(jnp.int32)

    d = deltas(f_push, f_start, f_stop)
    # per-step pushes from the scan (leading axis = step)
    inc = ((pstarts[..., None] == pos) & pushes[..., None]).astype(jnp.int32)
    dec = ((pstops[..., None] == pos) & pushes[..., None]).astype(jnp.int32)
    d = d + (inc - dec).sum(axis=0)
    keep = jnp.cumsum(d, axis=-1) > 0
    return keep & inside


def _scan_seeds(tx, N, lanes, s, g):
    """The reference state machine as a lax.scan over positions; returns
    per-step seed pushes and the final flush."""
    import jax.numpy as jnp
    from jax import lax

    def step(state, end_and_cur):
        end, cur = end_and_cur
        start, last, same_tid, same_max = state
        same = last == cur
        # branch 1: gap became too big
        b1 = (~same) & (last == 0) & (same_tid > g)
        # branch 2: leading gap
        b2 = (~same) & ~b1 & (last == 0) & ((end - start) == same_tid)
        # branch 3: regular taxon change
        b3 = (~same) & ~b1 & ~b2

        push = b1 & (same_max >= s)
        push_start = start
        push_stop = end - same_tid

        n_start = jnp.where(b1, end, jnp.where(b2, end + 1, start))
        n_last = jnp.where(same | b2, last, cur)
        n_same_tid = jnp.where(same, same_tid + 1, jnp.where(b2, same_tid, 1))
        n_same_max = jnp.where(
            b1, 1,
            jnp.where(b3 & (last != 0), jnp.maximum(same_max, same_tid), same_max),
        )
        return (n_start, n_last, n_same_tid, n_same_max), (push, push_start, push_stop)

    init = (
        jnp.zeros(lanes, jnp.int32),          # start
        tx[..., 0],                            # last_tid = taxons[0]
        jnp.ones(lanes, jnp.int32),            # same_tid
        jnp.ones(lanes, jnp.int32),            # same_max
    )
    ends = jnp.arange(1, N + 1, dtype=jnp.int32)
    curs = jnp.moveaxis(tx[..., 1:], -1, 0)  # (N, ...)
    (f_start, f_last, f_same_tid, f_same_max), (pushes, pstarts, pstops) = lax.scan(
        step, init, (ends, curs)
    )
    # final push (after loop): trailing gap trimmed
    f_end = jnp.full(lanes, N + 1, jnp.int32)
    f_push = f_same_max >= s
    f_stop = jnp.where(f_last == 0, f_end - f_same_tid, f_end)
    return (pushes, pstarts, pstops), (f_push, f_start, f_stop)


def seedextend_scored_mask_batch(taxa, lengths, seed_scores, penalty: int = 5,
                                 min_seed_size: int = 2, max_gap_size: int = 0):
    """Scored seed-extend (`-r`, src/commands/seedextend.rs:151-164) on
    device: keep only the highest-scoring extended seed per lane.

    Args:
      taxa: (..., N) int32 taxon ids (0 = miss).
      lengths: (...) int32 valid lengths.
      seed_scores: (size,) int32 per-taxon seed score with 0 meaning
        "no score" (TaxonList::score returning None, src/taxon.rs:181-191)
        — build with :func:`umgap_tpu.taxonomy.Taxonomy.seed_scores`.
      penalty: substitute score for unscored taxa (including gaps).

    Ties keep the LAST maximal seed, matching Rust's max_by_key.
    """
    import jax.numpy as jnp

    t = jnp.asarray(taxa, dtype=jnp.int32)
    N = t.shape[-1]
    lanes = t.shape[:-1]
    pos = jnp.arange(N, dtype=jnp.int32)
    inside = pos < lengths[..., None]
    t = jnp.where(inside, t, 0)
    tx = jnp.concatenate([t, jnp.zeros(lanes + (1,), jnp.int32)], axis=-1)

    (pushes, pstarts, pstops), (f_push, f_start, f_stop) = _scan_seeds(
        tx, N, lanes, jnp.int32(min_seed_size), jnp.int32(max_gap_size))

    # per-position scores over tx (sentinel included: it scores penalty)
    size = seed_scores.shape[0]
    sc = seed_scores[jnp.clip(tx, 0, size - 1)]
    sc = jnp.where((tx >= 0) & (tx < size) & (sc > 0), sc, jnp.int32(penalty))
    prefix = jnp.cumsum(sc, axis=-1)  # prefix[i] = sum sc[0..i]
    zeros = jnp.zeros(lanes + (1,), prefix.dtype)
    prefix = jnp.concatenate([zeros, prefix], axis=-1)  # prefix[i]=sum(<i)

    # candidates: scan pushes (in order) then the final flush (last)
    starts = jnp.concatenate([pstarts, f_start[None]], axis=0)  # (N+1, ...)
    stops = jnp.concatenate([pstops, f_stop[None]], axis=0)
    valids = jnp.concatenate([pushes, f_push[None]], axis=0)
    stops_c = jnp.clip(stops, 0, N + 1)
    a = jnp.take_along_axis(
        jnp.broadcast_to(prefix, starts.shape[:1] + prefix.shape),
        stops_c[..., None], axis=-1)[..., 0]
    b = jnp.take_along_axis(
        jnp.broadcast_to(prefix, starts.shape[:1] + prefix.shape),
        jnp.clip(starts, 0, N + 1)[..., None], axis=-1)[..., 0]
    scores = jnp.where(valids, a - b, jnp.int32(-2 ** 30))

    # last maximum along the candidate axis (axis 0)
    M = scores.shape[0]
    smax = scores.max(axis=0)
    is_max = scores == smax[None]
    cand_idx = jnp.arange(M, dtype=jnp.int32).reshape((M,) + (1,) * len(lanes))
    best = jnp.max(jnp.where(is_max, cand_idx, -1), axis=0)  # (...,)
    any_seed = valids.any(axis=0)

    bstart = jnp.take_along_axis(
        jnp.moveaxis(starts, 0, -1), best[..., None], axis=-1)[..., 0]
    bstop = jnp.take_along_axis(
        jnp.moveaxis(stops, 0, -1), best[..., None], axis=-1)[..., 0]
    keep = (pos >= bstart[..., None]) & (pos < bstop[..., None])
    return keep & any_seed[..., None] & inside
