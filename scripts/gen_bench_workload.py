"""Generate the shared benchmark workload (device bench + CPU baseline).

Produces a deterministic, realistic workload consumed byte-identically by
``bench.py`` (the device pipeline) and ``native/baseline_cpu.cpp`` (the
measured CPU denominator), so both run exactly the same work:

* 20k-node synthetic taxonomy (8% invalid; valid-ancestor snapping).
* 32768 random 100bp read pairs; each read end gets one deterministic
  "coding frame" whose translated 9-mers are planted in the index with
  probability 0.6 (70% to the pair's species, 20% parent, 10%
  grandparent) — so seed/extend and aggregation see realistic hit runs —
  plus 4% noise from non-coding frames, padded with random keys to 2M.

Everything is written as flat little-endian binary under .bench_data/
(regenerated on demand; not committed):
  reads.bin        u8  [P, 2, 100]  DNA codes A=0 C=1 G=2 T=3
  index_keys.bin   u64 [K]          packed 9-mers (5 bits/AA, sorted)
  index_vals.bin   i32 [K]
  parent.bin       i32 [T+1]
  snap.bin         i32 [T+1]       nearest valid ancestor (self if valid)
  depth.bin        i32 [T+1]
  manifest.json
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, ".bench_data")

SEED = 1234
N_PAIRS = 32768
READ_LEN = 100
N_TAX = 20_000
N_KEYS = 2_000_000

# NCBI table 1 in TCAG codon order (published constant).
TABLE1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
# DNA code (A=0,C=1,G=2,T=3) -> position in the TCAG codon ordering
TCAG_OF_CODE = np.array([2, 1, 3, 0], dtype=np.int64)
AA_CODE = {c: (26 if c == "*" else ord(c) - ord("A")) for c in set(TABLE1)}
AA_OF_CODON = np.array([AA_CODE[c] for c in TABLE1], dtype=np.uint8)


def translate_frame(codes: np.ndarray) -> np.ndarray:
    """DNA codes -> AA codes (table 1), complete codons only."""
    n = len(codes) // 3
    c = codes[: 3 * n].reshape(n, 3)
    idx = (TCAG_OF_CODE[c[:, 0]] * 16 + TCAG_OF_CODE[c[:, 1]] * 4
           + TCAG_OF_CODE[c[:, 2]])
    return AA_OF_CODON[idx]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def pack9(aa: np.ndarray) -> np.ndarray:
    """All 9-mers of an AA-code sequence as packed u64 (first residue
    most significant, 5 bits each) — umgap_tpu's key format."""
    n = len(aa) - 8
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    a = aa.astype(np.uint64)
    for j in range(9):
        out |= a[j : j + n] << np.uint64(5 * (8 - j))
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(SEED)

    # --- taxonomy ----------------------------------------------------- #
    parent = np.zeros(N_TAX + 1, dtype=np.int32)
    parent[1] = 1
    for i in range(2, N_TAX + 1):
        parent[i] = int(rng.integers(1, i))
    valid = rng.random(N_TAX + 1) > 0.08
    valid[1] = True
    depth = np.zeros(N_TAX + 1, dtype=np.int32)
    snap = np.zeros(N_TAX + 1, dtype=np.int32)
    snap[1] = 1
    for i in range(2, N_TAX + 1):
        depth[i] = depth[parent[i]] + 1
        snap[i] = i if valid[i] else snap[parent[i]]

    # --- reads -------------------------------------------------------- #
    reads = rng.integers(0, 4, size=(N_PAIRS, 2, READ_LEN), dtype=np.uint8)
    species = rng.integers(2, N_TAX + 1, size=N_PAIRS).astype(np.int32)
    coding = rng.integers(0, 6, size=(N_PAIRS, 2), dtype=np.int8)

    # --- plant index keys --------------------------------------------- #
    index: dict[int, int] = {}
    stop_free = lambda k: True  # noqa: E731 (filter applied below)

    def kmers_of(codes: np.ndarray, frame: int) -> np.ndarray:
        strand = revcomp(codes) if frame >= 3 else codes
        aa = translate_frame(strand[frame % 3 :])
        km = pack9(aa)
        # drop k-mers containing a stop ('*' = code 26)
        if len(km):
            has_stop = np.zeros(len(km), dtype=bool)
            stops = np.where(aa == 26)[0]
            for s in stops:
                lo = max(0, s - 8)
                has_stop[lo : s + 1] = True
            km = km[~has_stop[: len(km)]]
        return km

    for p in range(N_PAIRS):
        sp = int(species[p])
        par = int(parent[sp])
        gpar = int(parent[par])
        for e in range(2):
            codes = reads[p, e]
            cf = int(coding[p, e])
            for f in range(6):
                km = kmers_of(codes, f)
                if len(km) == 0:
                    continue
                if f == cf:
                    sel = rng.random(len(km)) < 0.60
                    choice = rng.random(len(km))
                    for k, s, u in zip(km[sel], np.ones(int(sel.sum())),
                                       choice[sel]):
                        tid = sp if u < 0.70 else (par if u < 0.90 else gpar)
                        index.setdefault(int(k), tid)
                else:
                    sel = np.where(rng.random(len(km)) < 0.04)[0]
                    for i in sel:
                        index.setdefault(int(km[i]),
                                         int(rng.integers(2, N_TAX + 1)))

    # pad with random keys to N_KEYS
    need = N_KEYS - len(index)
    extra = rng.integers(0, 2 ** 45, size=int(1.3 * need), dtype=np.uint64)
    vals = rng.integers(2, N_TAX + 1, size=len(extra)).astype(np.int32)
    for k, v in zip(extra, vals):
        if len(index) >= N_KEYS:
            break
        index.setdefault(int(k), int(v))

    keys = np.fromiter(index.keys(), dtype=np.uint64, count=len(index))
    values = np.fromiter(index.values(), dtype=np.int32, count=len(index))
    order = np.argsort(keys)
    keys, values = keys[order], values[order]

    # --- write -------------------------------------------------------- #
    reads.tofile(os.path.join(OUT, "reads.bin"))
    keys.tofile(os.path.join(OUT, "index_keys.bin"))
    values.tofile(os.path.join(OUT, "index_vals.bin"))
    parent.tofile(os.path.join(OUT, "parent.bin"))
    snap.tofile(os.path.join(OUT, "snap.bin"))
    depth.tofile(os.path.join(OUT, "depth.bin"))
    manifest = {
        "seed": SEED, "n_pairs": N_PAIRS, "read_len": READ_LEN,
        "n_tax": N_TAX, "n_keys": int(len(keys)),
        "planted": int((values > 0).sum()),
    }
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    print(json.dumps(manifest))


if __name__ == "__main__":
    main()
