"""K-mer packing and tryptic digestion.

A peptide k-mer over the 5-bit AA alphabet packs into 5*k bits; we split
the packed value at bit 25 into two int32 lanes (``hi``, ``lo``) so all
device arithmetic stays in 32 bits (no 64-bit integer ops).
Supports k <= 10 (the reference default is 9,
/root/reference/src/commands/prot2kmer.rs:38).

The tryptic digest reproduces the reference's double regex pass
(/root/reference/src/commands/prot2tryp.rs:57-64): the cleavage pattern
is applied twice because a residue can match both as context of one
split and as subject of the next, then '*' splits and empty fragments
are dropped.
"""

from __future__ import annotations

import re
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from . import encoding

MASK25 = (1 << 25) - 1
DEFAULT_K = 9
TRYPTIC_PATTERN = r"([KR])([^P])"


def pack_kmers_host(codes: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    """All overlapping k-mers of a peptide as packed uint64 (5 bits per
    AA, first residue most significant). Empty if len < k."""
    if k > 10:
        raise ValueError("k must be <= 10 for 2x int32 packing")
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        out |= c[j : j + n] << np.uint64(5 * (k - 1 - j))
    return out


def pack_peptide_host(codes: np.ndarray) -> int:
    """Pack one short peptide (len <= 10) into uint64."""
    v = np.uint64(0)
    for c in codes:
        v = (v << np.uint64(5)) | np.uint64(c)
    return int(v)


def split_packed(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 packed -> (hi, lo) int32 lanes split at bit 25."""
    hi = (packed >> np.uint64(25)).astype(np.int32)
    lo = (packed & np.uint64(MASK25)).astype(np.int32)
    return hi, lo


def join_packed(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)


def unpack_kmer(packed: int, k: int) -> str:
    """Packed uint64 -> AA string (debugging / printindex)."""
    codes = [(int(packed) >> (5 * (k - 1 - j))) & 31 for j in range(k)]
    return encoding.decode_aa(np.array(codes))


# ---------------------------------------------------------------------- #
# Device windows
# ---------------------------------------------------------------------- #

def pack_windows_batch(aa: jax.Array, pep_lengths: jax.Array, k: int = DEFAULT_K):
    """Pack every k-window of a padded peptide batch.

    Args:
      aa: (..., P) uint8 AA codes.
      pep_lengths: (...) int32 valid lengths.

    Returns:
      hi, lo: (..., W) int32 packed lanes, W = max(P - k + 1, 1).
      valid: (..., W) bool — window fully inside the peptide.
    """
    if k > 10:
        raise ValueError("k must be <= 10")
    P = aa.shape[-1]
    if P < k:
        # pad so the strided slices stay in range; every window is
        # invalid anyway (peptides shorter than k yield no k-mers)
        pad = [(0, 0)] * (aa.ndim - 1) + [(0, k - P)]
        aa = jnp.pad(aa, pad)
        P = k
    W = max(P - k + 1, 1)
    n_lo = min(k, 5)
    n_hi = k - n_lo
    a = aa.astype(jnp.int32)

    def shifted(j):
        return jax.lax.slice_in_dim(a, j, j + W, axis=-1)

    hi = jnp.zeros(aa.shape[:-1] + (W,), dtype=jnp.int32)
    for j in range(n_hi):
        hi = (hi << 5) | shifted(j)
    lo = jnp.zeros_like(hi)
    for j in range(n_hi, k):
        lo = (lo << 5) | shifted(j)
    w = jnp.arange(W, dtype=jnp.int32)
    valid = w < (pep_lengths[..., None] - (k - 1))
    return hi, lo, valid


# ---------------------------------------------------------------------- #
# Tryptic digestion (host)
# ---------------------------------------------------------------------- #

_TRYPTIC_RE = re.compile(TRYPTIC_PATTERN)


def tryptic_digest(seq: str, pattern: str = TRYPTIC_PATTERN) -> List[str]:
    """In-silico trypsin digest, reference realized semantics."""
    rx = _TRYPTIC_RE if pattern == TRYPTIC_PATTERN else re.compile(pattern)
    first = rx.sub(r"\1\n\2", seq)
    second = rx.sub(r"\1\n\2", first)
    return [p for p in second.replace("*", "\n").split("\n") if p]
