"""Six-frame translation.

Host path mirrors the reference command exactly
(/root/reference/src/commands/translate.rs); the device path is the
batched form: a whole batch of padded DNA code tensors is translated in
all six frames with a 125-entry codon table applied arithmetically —
no per-read control flow, fully fused under jit.

Frame naming follows the reference: "1","2","3" forward (1-indexed
offset), "1R","2R","3R" on the reverse-complement strand
(src/commands/translate.rs:143-183).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import encoding
from .encoding import TranslationTable

FRAME_NAMES = ("1", "2", "3", "1R", "2R", "3R")


def _bitplane_constants(tab: np.ndarray, out_bits: int):
    """Pack a small host lookup table (len <= 128) into per-output-bit
    uint32 word constants for gather-free device lookups."""
    n = len(tab)
    n_words = (n + 31) // 32
    planes = []
    for b in range(out_bits):
        bits = (tab.astype(np.uint64) >> b) & 1
        words = []
        for w in range(n_words):
            v = 0
            for i in range(min(32, n - 32 * w)):
                v |= int(bits[32 * w + i]) << i
            words.append(np.uint32(v))
        planes.append(words)
    return planes


def _bitplane_lookup(idx: jax.Array, planes, out_bits: int) -> jax.Array:
    """tab[idx] via bit-plane constants + variable shifts: ~10
    elementwise ops per output bit, no gather and no memory traffic
    (tuned on an earlier accelerator, not yet measured on this card)."""
    w = (idx >> 5).astype(jnp.uint32)
    bitpos = (idx & 31).astype(jnp.uint32)
    out = jnp.zeros(idx.shape, dtype=jnp.uint32)
    for b in range(out_bits):
        c = planes[b]
        word = jnp.full(idx.shape, c[0], dtype=jnp.uint32)
        for wi in range(1, len(c)):
            word = jnp.where(w == np.uint32(wi), c[wi], word)
        bit = (word >> bitpos) & np.uint32(1)
        out = out | (bit << np.uint32(b))
    return out


# ---------------------------------------------------------------------- #
# Host (parity oracle / CLI path)
# ---------------------------------------------------------------------- #

def translate_sequence(
    seq: str, frames: Sequence[str], table: TranslationTable, methionine: bool = False
) -> List[str]:
    """Translate one DNA string in the given frames, returning AA strings
    ('-' for unknown codons), in frame order."""
    codes = encoding.encode_dna(seq)
    rev = encoding.DNA_COMPLEMENT[codes[::-1]]
    out = []
    for frame in frames:
        reversed_ = frame.endswith("R")
        offset = int(frame[0]) - 1
        strand = rev if reversed_ else codes
        sub = strand[offset:] if len(strand) > offset else strand[:0]
        out.append(encoding.decode_aa(table.translate_frame(sub, methionine)))
    return out


# ---------------------------------------------------------------------- #
# Device (batched, jittable)
# ---------------------------------------------------------------------- #

def translate6_batch(dna: jax.Array, lengths: jax.Array, table: TranslationTable,
                     methionine: bool = False):
    """Translate a padded batch in all six frames.

    Args:
      dna: (B, L) uint8 DNA codes (padding value irrelevant; masked out).
      lengths: (B,) int32 actual read lengths.
      table: genetic code.

    Returns:
      aa: (B, 6, P) uint8 AA codes with P = L // 3; positions beyond the
        frame's peptide length are AA_PAD.
      pep_lengths: (B, 6) int32 number of codons per frame.

    Every lookup here is recast as elementwise arithmetic — the
    complement is arithmetic, per-frame codon extraction is a strided
    ``lax.slice`` (a relayout, not a gather), and the 125-entry codon
    table is applied bit-plane arithmetically (:func:`_bitplane_lookup`).
    The only remaining gather is the per-read reversal of long reads.
    These choices were tuned on an earlier accelerator and are not yet
    measured on this card.
    """
    B, L = dna.shape
    P = L // 3
    lengths = lengths.astype(jnp.int32)

    aa_planes = _bitplane_constants(table.aa, 5)
    start_planes = _bitplane_constants(table.start.astype(np.uint8), 1)

    d = dna.astype(jnp.int32)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]  # (1, L)

    # Reverse-complement with per-read length: rc[i] = comp(dna[len-1-i]).
    # A static flip gives e[j] = d[L-1-j]; the per-read part is then a
    # left-shift by s = L - len.
    fwd = jnp.where(d <= 4, d, jnp.int32(encoding.DNA_N))  # sanitize padding
    e = jnp.flip(fwd, axis=1)
    if L <= 160:
        # Short reads (the metagenomic case): the shift as a fused
        # one-hot contraction (compare + multiply-reduce). Exact: each
        # output has one nonzero term and DNA codes <= 4 are exact in
        # bf16. No gathers; quadratic in L, hence the cap. Tuned on an
        # earlier accelerator, not yet measured on this card.
        eb = jnp.where(e < 4, 3 - e, 4).astype(jnp.bfloat16)  # complement
        shift = (jnp.int32(L) - lengths).reshape(B, 1, 1)
        i_idx = jnp.arange(L, dtype=jnp.int32).reshape(1, L, 1)
        j_idx = jnp.arange(L, dtype=jnp.int32).reshape(1, 1, L)
        sel = (j_idx == i_idx + shift).astype(jnp.bfloat16)  # (B, L, L)
        rc = jnp.einsum("bij,bj->bi", sel, eb).astype(jnp.int32)
    else:
        # Long reads: O(B*L) take_along_axis gather instead of the
        # O(B*L^2) selector.
        ec = jnp.where(e < 4, 3 - e, 4)
        shift = (jnp.int32(L) - lengths).astype(jnp.int32)
        idx = jnp.clip(pos + shift[:, None], 0, L - 1)
        rc = jnp.take_along_axis(ec, idx, axis=1)
    rc = jnp.where(pos < lengths[:, None], rc, jnp.int32(encoding.DNA_N))

    # pad so strided codon slices stay in range for every frame offset
    padn = ((0, 0), (0, 3))
    fwd_p = jnp.pad(fwd, padn, constant_values=encoding.DNA_N)
    rc_p = jnp.pad(rc, padn, constant_values=encoding.DNA_N)

    def frame_translate(strand_p, offset):
        def base(j):  # strided slice: codon base j of every codon
            start = offset + j
            return jax.lax.slice(strand_p, (0, start),
                                 (B, start + 3 * (P - 1) + 1), (1, 3))

        codon = base(0) * 25 + base(1) * 5 + base(2)  # (B, P), < 125
        aa = _bitplane_lookup(codon, aa_planes, 5).astype(jnp.uint8)
        if methionine:
            is_start = _bitplane_lookup(codon, start_planes, 1) > 0
            aa = jnp.where(is_start,
                           jnp.uint8(encoding.AA_FROM_BYTE[ord("M")]), aa)
        ncod = jnp.maximum(lengths - offset, 0) // 3  # (B,)
        valid = jnp.arange(P, dtype=jnp.int32)[None, :] < ncod[:, None]
        aa = jnp.where(valid, aa, jnp.uint8(encoding.AA_PAD))
        return aa, ncod

    frames = []
    plens = []
    for strand_p in (fwd_p, rc_p):
        for offset in range(3):
            aa, n = frame_translate(strand_p, offset)
            frames.append(aa)
            plens.append(n)
    return jnp.stack(frames, axis=1), jnp.stack(plens, axis=1)
