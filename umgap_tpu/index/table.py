"""Open-addressing hash tables for peptide -> taxon lookups.

The reference stores its index as an FST (string-keyed, prefix
compressed, pointer-chasing lookups — /root/reference/src/commands/
buildindex.rs:38-46, pept2lca.rs:74-79). Pointer chasing is hostile to
batched accelerators; instead we store fixed-width integer arrays in
device memory and probe them with vectorized row gathers:

- ``KmerTable``: fixed-length k-mers (k <= 10, 45-bit packed keys),
  stored *quotiented*: an invertible Feistel mix whitens the key, the
  low bits of the mixed key select an 8-slot bucket row, and only the
  remaining <= 31 bits plus the value are stored — 8 bytes per slot, so
  one probe is a single 64-byte row gather. Exact (the full key is
  recoverable), no collisions possible.
- ``PeptideTable``: variable-length peptides fingerprinted with two
  independent 32-bit FNV-1a hashes (64-bit fingerprint, stored in full:
  12 bytes per slot). With n distinct keys the collision probability is
  ~n^2/2^65 (< 1e-4 at 100M keys).

Both use power-of-two bucket counts and bucket-level linear probing; the
build *enforces* a maximum probe distance of 1 for k-mer tables (growing
the table if needed) so the device probe is a statically unrolled 1-2
rounds. Misses return ``default`` (0 for the reference's `-o` mode,
src/commands/pept2lca.rs:47-50).

Serialization is a plain ``.npz``.
"""

from __future__ import annotations

import numpy as np

from ..ops import encoding, kmers

EMPTY = np.int32(-1)
BUCKET = 8  # slots per bucket row

MASK20 = np.uint32((1 << 20) - 1)
MASK25 = np.uint32((1 << 25) - 1)

# 32-bit mixing constants (xxhash/murmur-style)
_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)
_C3 = np.uint32(0xC2B2AE3D)

# independent constants for the cuckoo table's second hash
_D1 = np.uint32(0x27D4EB2F)
_D2 = np.uint32(0x165667B1)
_D3 = np.uint32(0x9E3779F9)

_FNV_OFFSET = np.uint32(0x811C9DC5)
_FNV_PRIME = np.uint32(0x01000193)
_FNV_OFFSET2 = np.uint32(0xCBF29CE4)

# Remainders are 45 - nb_bits <= 30 bits (bits 0..29); bit 30 stores the
# probe distance (0 or 1) so equal remainders at different home buckets
# can never alias across rounds; bit 31 stays 0, keeping EMPTY = -1
# unambiguous.
MIN_NB_BITS = 15
# bucket8s (narrow rows) for cache-sized tables; beyond this key count
# single tables route to bucket64s (see build_kmer_table). Tuned on an
# earlier accelerator, not yet measured on this card.
BUCKET8S_MAX_KEYS = 30_000_000
MAX_NB_BITS = 25
DIST_BIT = np.int32(1 << 30)


def _mx(x):
    """32-bit finalizer (works on numpy and jax arrays)."""
    x = x ^ (x >> 16)
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * np.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def mix_key(hi, lo):
    """Invertible 45-bit whitening of a (20-bit, 25-bit) packed k-mer via
    a 3-round Feistel network (numpy or jax arrays)."""
    h = hi.astype(np.uint32)
    l = lo.astype(np.uint32)
    l = l ^ (_mx(h + _C1) & MASK25)
    h = h ^ (_mx(l + _C2) & MASK20)
    l = l ^ (_mx(h + _C3) & MASK25)
    return h, l


def unmix_key(mhi, mlo):
    """Inverse of :func:`mix_key` (host side, for printindex)."""
    h = mhi.astype(np.uint32)
    l = mlo.astype(np.uint32)
    l = l ^ (_mx(h + _C3) & MASK25)
    h = h ^ (_mx(l + _C2) & MASK20)
    l = l ^ (_mx(h + _C1) & MASK25)
    return h, l


def mix_key2(hi, lo):
    """Second independent invertible whitening (cuckoo hash 2)."""
    h = hi.astype(np.uint32)
    l = lo.astype(np.uint32)
    l = l ^ (_mx(h + _D1) & MASK25)
    h = h ^ (_mx(l + _D2) & MASK20)
    l = l ^ (_mx(h + _D3) & MASK25)
    return h, l


def unmix_key2(mhi, mlo):
    """Inverse of :func:`mix_key2`."""
    h = mhi.astype(np.uint32)
    l = mlo.astype(np.uint32)
    l = l ^ (_mx(h + _D3) & MASK25)
    h = h ^ (_mx(l + _D2) & MASK20)
    l = l ^ (_mx(h + _D1) & MASK25)
    return h, l


def hash32(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """32-bit mix of two key lanes (bucket hash for peptide tables and
    the shard-ownership hash; identical on host and device)."""
    h = (hi.astype(np.uint32) * _C1) ^ (lo.astype(np.uint32) * _C2)
    h ^= h >> np.uint32(16)
    h *= _C3
    h ^= h >> np.uint32(13)
    return h


def fingerprint_host(codes: np.ndarray) -> tuple[np.uint32, np.uint32]:
    """Two independent FNV-1a style hashes over AA codes (one peptide).
    h1 avoids the all-ones pattern so EMPTY stays unambiguous."""
    h1 = _FNV_OFFSET
    h2 = _FNV_OFFSET2
    with np.errstate(over="ignore"):
        for c in codes.astype(np.uint32):
            h1 = (h1 ^ c) * _FNV_PRIME
            h2 = (h2 ^ (c + np.uint32(0x9E37))) * _FNV_PRIME
    if h1 == np.uint32(0xFFFFFFFF):
        h1 = np.uint32(0)
    return h1, h2


def fingerprints_matrix(codes: np.ndarray, lengths: np.ndarray):
    """Vectorized :func:`fingerprint_host` over padded AA-code rows —
    O(max_len) numpy passes instead of a per-character Python loop."""
    n, L = codes.shape
    h1 = np.full(n, _FNV_OFFSET, dtype=np.uint32)
    h2 = np.full(n, _FNV_OFFSET2, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(L):
            live = j < lengths
            c = codes[:, j].astype(np.uint32)
            h1 = np.where(live, (h1 ^ c) * _FNV_PRIME, h1)
            h2 = np.where(live, (h2 ^ (c + np.uint32(0x9E37))) * _FNV_PRIME,
                          h2)
    h1 = np.where(h1 == np.uint32(0xFFFFFFFF), np.uint32(0), h1)
    return h1.astype(np.int32), h2.astype(np.int32)


def _fingerprints(peptides, chunk: int = 2_000_000):
    """Fingerprint many peptides (strings or code arrays), vectorized:
    one blob encode + a padded-matrix FNV, chunked to bound the padded
    allocation (real tryptic indexes hold tens of millions of keys)."""
    n = len(peptides)
    hi = np.zeros(n, dtype=np.int32)
    lo = np.zeros(n, dtype=np.int32)
    for s in range(0, n, chunk):
        part = peptides[s : s + chunk]
        if part and isinstance(part[0], (str, bytes)):
            blob = "".join(p if isinstance(p, str) else p.decode()
                           for p in part)
            codes = encoding.encode_aa(blob)
            lens = np.fromiter((len(p) for p in part), np.int64,
                               count=len(part))
        else:
            arrs = [np.asarray(p, dtype=np.uint8) for p in part]
            codes = (np.concatenate(arrs) if arrs
                     else np.zeros(0, np.uint8))
            lens = np.fromiter((len(a) for a in arrs), np.int64,
                               count=len(arrs))
        L = int(lens.max()) if len(lens) and lens.max() > 0 else 1
        mat = np.zeros((len(part), L), dtype=np.uint8)
        if len(codes):
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            rows = np.repeat(np.arange(len(part)), lens)
            cols = np.arange(len(codes)) - np.repeat(starts, lens)
            mat[rows, cols] = codes
        h1, h2 = fingerprints_matrix(mat, lens)
        hi[s : s + len(part)] = h1
        lo[s : s + len(part)] = h2
    return hi, lo


# ---------------------------------------------------------------------- #
# Bucketized insertion (shared)
# ---------------------------------------------------------------------- #

def _insert_bucketized(bucket0: np.ndarray, payloads, cap: int,
                       tag_distance: bool = False, bucket: int = BUCKET,
                       max_round: int | None = None,
                       use_native: bool = True):
    """Place keys into BUCKET-wide rows with bucket-level linear probing.

    ``payloads``: list of (n,) int32 arrays; each gets a (cap,) output
    (EMPTY-filled for the first, 0-filled for the rest). With
    ``tag_distance``, the first payload is OR-ed with ``r << 30`` at
    placement round r (quotient disambiguation). With ``max_round``,
    keys still unplaced after that round are returned instead of probed
    further. Returns (outputs, max_probes, leftover_indices).

    With ``use_native`` (default) and the C++ runtime available, the
    placement runs in native/umgap_native.cpp — SLOT-IDENTICAL to the
    numpy path below (equality-tested), which remains the portable
    fallback and the oracle."""
    if use_native and len(payloads) <= 3 and len(bucket0) >= 4096:
        try:
            from ..io.native import insert_bucketized_native

            return insert_bucketized_native(bucket0, payloads, cap,
                                            tag_distance, bucket, max_round)
        except (RuntimeError, OSError):
            pass  # toolchain unavailable: numpy path below
    n = len(bucket0)
    n_buckets = max(cap // bucket, 1)
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(payloads))]
    occupancy = np.zeros(n_buckets, dtype=np.int64)
    pending = np.arange(n)
    r = 0
    max_probes = 0
    while len(pending):
        if max_round is not None and r > max_round:
            break
        if r > n_buckets:
            raise RuntimeError("table capacity exhausted")
        b = (bucket0[pending] + r) % n_buckets
        order = np.argsort(b, kind="stable")
        bs = b[order]
        starts = np.concatenate([[0], np.nonzero(np.diff(bs))[0] + 1])
        group_start = np.repeat(
            starts, np.diff(np.concatenate([starts, [len(bs)]])))
        rank = np.arange(len(bs)) - group_start
        free = bucket - occupancy[bs]
        place = rank < free
        slot = bs[place] * bucket + occupancy[bs[place]] + rank[place]
        idx = pending[order][place]
        for i, (out, payload) in enumerate(zip(outs, payloads)):
            if i == 0 and tag_distance:
                out[slot] = payload[idx] | np.int32(min(r, 1) << 30)
            else:
                out[slot] = payload[idx]
        placed_buckets, placed_counts = np.unique(bs[place], return_counts=True)
        occupancy[placed_buckets] += placed_counts
        if place.any():
            max_probes = max(max_probes, r)
        pending = pending[order][~place]
        r += 1
    return outs, max_probes, pending


def _insert_conveyor(bucket0: np.ndarray, payloads, cap: int,
                     bucket: int = 16, use_native: bool = True):
    """Distance-<=1 placement that maximizes occupancy.

    The round-based insertion (:func:`_insert_bucketized`) fills every
    home bucket FIRST and only then pushes leftovers one bucket right —
    so a key carried from bucket b-1 competes with b's own arrivals
    after they already took the slots, and the 256-slot stash overflows
    near load 0.45-0.49 at 10^8-key shards.  Here carried keys take
    priority in their overflow bucket (home arrivals displaced become
    the next bucket's carry), which is the optimal left-to-right flow
    for the at-most-one-bucket displacement scheme: a key reaches the
    stash only when its home bucket's carry-in alone fills the bucket —
    P ~ Poisson tail beyond 2x bucket size, i.e. effectively never below
    ~0.9 load.  Probe semantics are IDENTICAL (same distance tags 0/1,
    same early-exit invariant: a bucket with an empty slot never has
    displaced or stashed keys), so tables stay exact and serve through
    the unchanged 2-round probe.

    Returns (outputs, max_probes, stash_indices) like
    :func:`_insert_bucketized` with ``tag_distance=True``."""
    if use_native and len(payloads) <= 3 and len(bucket0) >= 4096:
        try:
            from ..io.native import insert_conveyor_native

            return insert_conveyor_native(bucket0, payloads, cap, bucket)
        except (RuntimeError, OSError):
            pass
    n = len(bucket0)
    nb = max(cap // bucket, 1)
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(payloads))]
    cnt = np.bincount(bucket0, minlength=nb).astype(np.int64)
    # water-filling carry: c(b) = max(c(b-1) + cnt(b) - bucket, 0)
    s = np.cumsum(cnt - bucket)
    runmin = np.minimum.accumulate(s)
    carry = s - np.minimum(runmin, 0)
    carry = np.maximum(carry, 0)
    if n and carry.max() > bucket:
        # a single bucket's carry exceeds a whole bucket (possible only
        # far beyond any sized load): exact sequential sweep
        return _insert_conveyor_slow(bucket0, payloads, cap, bucket, outs)
    c_in = np.concatenate([[0], carry[:-1]])
    placed_home = cnt - carry
    # stable order within buckets
    order = np.argsort(bucket0, kind="stable")
    b_sorted = bucket0[order]
    starts = np.searchsorted(b_sorted, np.arange(nb))
    rank = np.arange(n, dtype=np.int64) - starts[b_sorted]
    home = rank < placed_home[b_sorted]
    slot = np.empty(n, dtype=np.int64)
    slot[home] = (b_sorted[home] * bucket + c_in[b_sorted[home]]
                  + rank[home])
    pushed_pos = np.nonzero(~home)[0]  # sorted positions of pushed keys
    pr = rank[pushed_pos] - placed_home[b_sorted[pushed_pos]]
    tgt = (b_sorted[pushed_pos] + 1) % nb
    pslot = tgt * bucket + pr
    keep = np.ones(n, dtype=bool)
    # wrap lap: carry of the last bucket takes bucket 0's leftover room
    # (bucket 0's occupancy is its placed home arrivals; c_in[0] == 0)
    wrap = tgt == 0
    if wrap.any():
        base0 = min(int(cnt[0]), bucket)
        room0 = bucket - base0
        stash_w = pr[wrap] >= room0
        pslot[wrap] = np.where(stash_w, 0, base0 + pr[wrap])
        keep[pushed_pos[wrap]] = ~stash_w
    slot[pushed_pos] = pslot
    idx = order[keep]
    slots_kept = slot[keep]
    tags = np.zeros(n, dtype=np.int32)
    tags[pushed_pos] = 1
    tags_kept = tags[keep]
    for i, (out, payload) in enumerate(zip(outs, payloads)):
        if i == 0:
            out[slots_kept] = payload[idx] | (tags_kept << 30)
        else:
            out[slots_kept] = payload[idx]
    max_probes = 1 if len(pushed_pos) else 0
    stash_idx = np.sort(order[~keep])
    return outs, max_probes, stash_idx


def _insert_conveyor_slow(bucket0, payloads, cap, bucket, outs):
    """Exact sequential conveyor sweep (clamped carry; numpy oracle for
    the native path and the backstop for pathological loads)."""
    n = len(bucket0)
    nb = max(cap // bucket, 1)
    order = np.argsort(bucket0, kind="stable")
    b_sorted = bucket0[order]
    starts = np.searchsorted(b_sorted, np.arange(nb + 1))
    occ = np.zeros(nb, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    tag = np.zeros(n, dtype=np.int32)
    stash: list = []
    carry: list = []
    max_probes = 0
    for lap in range(2):
        for b in range(nb):
            room = bucket - occ[b]
            take = min(len(carry), room)
            for j in range(take):
                k = carry[j]
                slot[k] = b * bucket + occ[b] + j
                tag[k] = 1
                max_probes = 1
            occ[b] += take
            stash.extend(carry[take:])
            carry = []
            if lap == 0:
                ks = order[starts[b]: starts[b + 1]]
                room = bucket - occ[b]
                placed = ks[: room] if room > 0 else ks[:0]
                for j, k in enumerate(placed):
                    slot[k] = b * bucket + occ[b] + j
                occ[b] += len(placed)
                carry = list(ks[len(placed):])
        if lap == 0 and not carry:
            break
        if lap == 1:
            stash.extend(carry)
            carry = []
    placed_mask = np.ones(n, dtype=bool)
    placed_mask[np.array(stash, dtype=np.int64)
                if stash else np.zeros(0, np.int64)] = False
    for i, (out, payload) in enumerate(zip(outs, payloads)):
        if i == 0:
            out[slot[placed_mask]] = (payload[placed_mask]
                                      | (tag[placed_mask] << 30))
        else:
            out[slot[placed_mask]] = payload[placed_mask]
    return outs, max_probes, np.array(sorted(stash), dtype=np.int64)


class TableGeometryError(ValueError):
    """A table layout cannot represent the requested capacity (e.g. the
    25-bit bucket-index cap) — distinct from generic ValueErrors so
    layout fallbacks never mask unrelated bugs."""


def _pow2_capacity(n: int, load_factor: float, min_cap: int) -> int:
    cap = min_cap
    while cap * load_factor < max(n, 1):
        cap *= 2
    return cap


# ---------------------------------------------------------------------- #
# KmerTable (quotiented, exact)
# ---------------------------------------------------------------------- #

class KmerTable:
    """Fixed-k packed-kmer table, quotient-stored: 8 bytes per slot.

    An optional *stash* holds the handful of keys whose home bucket
    overflowed the probe-distance limit: lookups compare every query
    against all stash keys with a broadcast (gather-free, ~0.3 ms per
    million queries at 128 stash slots), which lets the single-gather
    ``bucket16`` layout keep a dense load factor without growing."""

    kind = "kmer"

    def __init__(self, rem, values, max_probes: int, n: int, meta=None,
                 stash_hi=None, stash_lo=None, stash_val=None,
                 rows_packed=None):
        # ``rows_packed`` is the (n_buckets, 2*bucket) device wire layout
        # ([remainder row | value row] per bucket — see ops.lookup
        # .pack_rows).  Artifacts saved with ``packed=True`` store ONLY
        # this array, so an mmap'd serving load transfers straight to
        # HBM with no host-side repack; ``rem``/``values`` then
        # materialize lazily (host probing / printindex only).
        self._rem = rem
        self._values = values
        self.rows_packed = rows_packed
        if rem is None and rows_packed is None:
            raise ValueError("KmerTable needs rem/values or rows_packed")
        self.max_probes = int(max_probes)
        self.n = int(n)
        self.meta = dict(meta or {})
        z = np.zeros(0, dtype=np.int32)
        self.stash_hi = z if stash_hi is None else stash_hi
        self.stash_lo = z if stash_lo is None else stash_lo
        self.stash_val = z if stash_val is None else stash_val

    @property
    def rem(self):
        if self._rem is None:
            bk = self.bucket
            self._rem = np.ascontiguousarray(
                self.rows_packed[:, :bk]).reshape(-1)
        return self._rem

    @property
    def values(self):
        if self._values is None:
            bk = self.bucket
            self._values = np.ascontiguousarray(
                self.rows_packed[:, bk:2 * bk]).reshape(-1)
        return self._values

    @property
    def capacity(self) -> int:
        if self._values is None:
            return self.rows_packed.shape[0] * self.bucket
        return len(self._values)

    @property
    def bucket(self) -> int:
        return int(self.meta.get("bucket", BUCKET))

    @property
    def n_buckets(self) -> int:
        return max(self.capacity // self.bucket, 1)

    @property
    def nb_bits(self) -> int:
        return int(self.meta["nb_bits"])

    @property
    def k(self) -> int:
        return self.meta.get("k", kmers.DEFAULT_K)

    # -- construction --------------------------------------------------- #

    @classmethod
    def build(cls, packed: np.ndarray, values: np.ndarray, k: int,
              load_factor: float = 0.45, capacity: int | None = None,
              max_probe_limit: int = 1, bucket: int = BUCKET,
              stash_cap: int = 128) -> "KmerTable":
        """``bucket`` trades memory for probe speed: 4-slot buckets
        halve the bytes per probe round but need a sparser table to keep
        the probe-distance limit (roughly 2x capacity vs 8-slot).
        Overflow beyond the limit lands in the stash (up to
        ``stash_cap`` keys); the table only grows when the stash would
        overflow too.

        ``packed`` keys MUST be unique (joinkmers output is; the CLI
        buildindex path validates): a duplicate key would match two
        slots of one bucket and corrupt the device probe's select."""
        if k > 9:
            # the quotient math is exact for 45-bit (<= 9 x 5-bit) keys;
            # a 10-mer's 50 bits would silently truncate and alias —
            # longer keys belong in the fingerprint PeptideTable
            raise TableGeometryError(
                "exact quotient k-mer tables support k <= 9")
        packed = packed.astype(np.uint64)
        values = np.asarray(values, dtype=np.int32)
        hi, lo = kmers.split_packed(packed)
        mhi, mlo = mix_key(hi, lo)
        cap = capacity or _pow2_capacity(
            len(values), load_factor, bucket << MIN_NB_BITS)
        # The 30-bit-remainder + distance-tag invariant needs
        # nb_bits >= MIN_NB_BITS; a caller-pinned capacity below the
        # floor would let remainder bit 30 alias the tag (corrupting
        # items() reconstruction and risking probe false positives).
        cap = max(cap, bucket << MIN_NB_BITS)
        while True:
            nb_bits = int(np.log2(max(cap // bucket, 1)))
            if nb_bits > MAX_NB_BITS:
                raise TableGeometryError(
                    "table too large for 25-bit bucket index")
            bucket0 = (mlo & np.uint32((1 << nb_bits) - 1)).astype(np.int64)
            rem = ((mlo >> np.uint32(nb_bits))
                   | (mhi << np.uint32(25 - nb_bits))).astype(np.int32)
            if max_probe_limit == 1:
                # dense 2-round geometry: conveyor placement holds the
                # stash near zero up to ~0.9 load (vs ~0.45 round-based)
                (rem_arr, val_arr), max_probes, leftover = \
                    _insert_conveyor(bucket0, [rem, values], cap,
                                     bucket=bucket)
            else:
                (rem_arr, val_arr), max_probes, leftover = \
                    _insert_bucketized(
                        bucket0, [rem, values], cap, tag_distance=True,
                        bucket=bucket, max_round=max_probe_limit)
            if len(leftover) <= stash_cap:
                return cls(rem_arr, val_arr, max_probes, len(values),
                           {"k": k, "nb_bits": nb_bits, "bucket": bucket},
                           stash_hi=hi[leftover].astype(np.int32),
                           stash_lo=lo[leftover].astype(np.int32),
                           stash_val=values[leftover])
            if capacity is not None:
                raise RuntimeError(
                    f"{len(leftover)} keys exceed the probe-distance limit "
                    "at the requested capacity; use a larger capacity")
            cap *= 2

    # -- probing -------------------------------------------------------- #

    def probe_host(self, hi: np.ndarray, lo: np.ndarray,
                   default: int = 0) -> tuple[np.ndarray, np.ndarray]:
        hi = np.asarray(hi, dtype=np.int32)
        lo = np.asarray(lo, dtype=np.int32)
        nb = self.n_buckets
        nb_bits = self.nb_bits
        mhi, mlo = mix_key(hi, lo)
        bucket = (mlo & np.uint32(nb - 1)).astype(np.int64)
        rem = ((mlo >> np.uint32(nb_bits))
               | (mhi << np.uint32(25 - nb_bits))).astype(np.int32)
        kr = self.rem.reshape(nb, self.bucket)
        kv = self.values.reshape(nb, self.bucket)
        out = np.full(hi.shape, default, dtype=np.int32)
        found = np.zeros(hi.shape, dtype=bool)
        live = np.ones(hi.shape, dtype=bool)
        for r in range(self.max_probes + 1):
            if not live.any():
                break
            rr = kr[bucket]  # (..., BUCKET)
            rv = kv[bucket]
            tag = rem | np.int32(min(r, 1) << 30)
            hit8 = rr == tag[..., None]
            anyhit = hit8.any(axis=-1)
            val = np.take_along_axis(
                rv, np.argmax(hit8, axis=-1)[..., None], axis=-1)[..., 0]
            newly = live & anyhit
            out[newly] = val[newly]
            found |= newly
            has_empty = (rr == EMPTY).any(axis=-1)
            live = live & ~anyhit & ~has_empty
            bucket = (bucket + 1) % nb
        if len(self.stash_hi):
            eq = (hi[..., None] == self.stash_hi) & (lo[..., None] == self.stash_lo)
            shit = eq.any(axis=-1)
            sval = np.take(self.stash_val, np.argmax(eq, axis=-1))
            out = np.where(shit, sval, out)
            found |= shit
        return out, found

    def lookup_host(self, peptides_codes, default: int = 0):
        """Per-peptide k-mer lookups (host oracle)."""
        results = []
        for codes in peptides_codes:
            packed = kmers.pack_kmers_host(codes, self.k)
            hi, lo = kmers.split_packed(packed)
            vals, found = self.probe_host(hi, lo, default)
            results.append((vals, found))
        return results

    def items(self, bucket_range: tuple[int, int] | None = None):
        """(packed_key, value) pairs in slot order, stash last (for
        printindex). The stored distance tag makes reconstruction exact:
        home bucket = slot bucket - distance.

        ``bucket_range=(b0, b1)`` reconstructs only buckets [b0, b1) —
        stash omitted — without materializing the full slot arrays (a
        4.3 GB mmap'd shard yields spot-check keys from a few MB of
        pages). Note keys displaced INTO the range from bucket b0-1
        appear, keys displaced out of it don't; for exact-probe spot
        checks that distinction is irrelevant."""
        if bucket_range is not None:
            b0, b1 = bucket_range
            bk = self.bucket
            if self.rows_packed is not None:
                sl = np.asarray(self.rows_packed[b0:b1])
                rem_s = np.ascontiguousarray(sl[:, :bk]).reshape(-1)
                val_s = np.ascontiguousarray(sl[:, bk:2 * bk]).reshape(-1)
            else:
                rem_s = self.rem[b0 * bk : b1 * bk]
                val_s = self.values[b0 * bk : b1 * bk]
            occ = np.nonzero(rem_s != EMPTY)[0]
            return self._items_from(occ + b0 * bk, rem_s[occ], val_s[occ])
        occ = np.nonzero(self.rem != EMPTY)[0]
        return self._items_from(occ, self.rem[occ], self.values[occ],
                                with_stash=True)

    def _items_from(self, occ, rem_occ, val_occ, with_stash: bool = False):
        tag = rem_occ.astype(np.uint32)
        dist = (tag >> np.uint32(30)).astype(np.int64)
        rem = tag & np.uint32((1 << 30) - 1)
        nb_bits = self.nb_bits
        nb = self.n_buckets
        home = ((occ // self.bucket) - dist) % nb
        mlo = (home.astype(np.uint32)
               | ((rem & np.uint32((1 << (25 - nb_bits)) - 1))
                  << np.uint32(nb_bits))) & MASK25
        mhi = (rem >> np.uint32(25 - nb_bits)) & MASK20
        hi, lo = unmix_key(mhi, mlo)
        packed = kmers.join_packed(hi.astype(np.int32), lo.astype(np.int32))
        values = val_occ
        if with_stash and len(self.stash_hi):
            packed = np.concatenate(
                [packed, kmers.join_packed(self.stash_hi, self.stash_lo)])
            values = np.concatenate([values, self.stash_val])
        return packed, values

    # -- serialization -------------------------------------------------- #

    def save(self, path, compress: bool = True, packed: bool = False):
        """``compress=False`` trades ~3.5x disk for ~10x faster save AND
        load (zlib dominates both at shard scale) — what the distributed
        build uses for serving artifacts.

        ``packed=True`` stores the device wire layout (``rows``) instead
        of the flat ``rem``/``values`` arrays: same bytes, but an mmap'd
        load then feeds ``jax.device_put`` with ZERO host-side repacking
        — cold start becomes pure transfer (the reference's mmap
        load-and-go, src/commands/pept2lca.rs:74-79). Implies the
        uncompressed container (mmap needs stored members)."""
        if packed:
            if self.rows_packed is not None:
                rows = self.rows_packed
            else:
                from ..ops.lookup import pack_rows  # local: avoids cycle

                rows = pack_rows(self)
            np.savez(
                path,
                kind=np.bytes_(self.kind),
                rows=rows,
                max_probes=np.int64(self.max_probes),
                n=np.int64(self.n),
                stash_hi=self.stash_hi,
                stash_lo=self.stash_lo,
                stash_val=self.stash_val,
                **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
            )
            return
        saver = np.savez_compressed if compress else np.savez
        saver(
            path,
            kind=np.bytes_(self.kind),
            rem=self.rem,
            values=self.values,
            max_probes=np.int64(self.max_probes),
            n=np.int64(self.n),
            stash_hi=self.stash_hi,
            stash_lo=self.stash_lo,
            stash_val=self.stash_val,
            **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
        )

    @staticmethod
    def load(path):
        return load_table(path)


# ---------------------------------------------------------------------- #
# CuckooKmerTable (quotiented two-half cuckoo, exact, minimal gather)
# ---------------------------------------------------------------------- #

class CuckooKmerTable:
    """Fixed-k packed-kmer cuckoo table: the probe-optimal layout.

    It minimizes *gathered elements per query*: the bucketized quotient
    table reads 2 rounds x (8 remainders + 8 values) = 32 int32 per
    query; this layout reads 2 slots x (remainder, value) = 4 — two
    independent invertible Feistel whitenings (``mix_key`` / ``mix_key2``) each own
    one half of the table, a key is stored in exactly one slot of one
    half, and the half disambiguates which mix to invert, so the full
    key is always recoverable (exact, like the reference's FST —
    /root/reference/src/commands/buildindex.rs:38-46; no false
    positives possible).
    """

    kind = "cuckoo"

    MAX_KICKS = 500

    def __init__(self, rem, values, n: int, meta=None):
        self.rem = rem          # (cap,) int32, EMPTY = -1
        self.values = values    # (cap,) int32
        self.max_probes = 1     # interface parity: always 2 probes
        self.n = int(n)
        self.meta = dict(meta or {})

    @property
    def capacity(self) -> int:
        return len(self.values)

    @property
    def half(self) -> int:
        return self.capacity // 2

    @property
    def s_bits(self) -> int:
        return int(self.meta["s_bits"])

    @property
    def k(self) -> int:
        return self.meta.get("k", kmers.DEFAULT_K)

    # -- hashing --------------------------------------------------------- #

    @staticmethod
    def _slot_rem(hi, lo, s_bits: int, which: int):
        """(slot-in-half, remainder) under hash ``which`` (0 or 1)."""
        mhi, mlo = (mix_key if which == 0 else mix_key2)(hi, lo)
        slot = (mlo & np.uint32((1 << s_bits) - 1)).astype(np.int64)
        rem = ((mlo >> np.uint32(s_bits))
               | (mhi << np.uint32(25 - s_bits))).astype(np.int32)
        return slot, rem

    # -- construction ----------------------------------------------------- #

    @classmethod
    def build(cls, packed: np.ndarray, values: np.ndarray, k: int,
              load_factor: float = 0.4,
              capacity: int | None = None) -> "CuckooKmerTable":
        if k > 9:
            raise TableGeometryError(
                "exact quotient k-mer tables support k <= 9")
        packed = packed.astype(np.uint64)
        values = np.asarray(values, dtype=np.int32)
        cap = capacity or _pow2_capacity(len(values), load_factor,
                                         2 << MIN_NB_BITS)
        while True:
            try:
                return cls._build_at(packed, values, k, cap)
            except RuntimeError:
                if capacity is not None:
                    raise
                cap *= 2

    @classmethod
    def _build_at(cls, packed, values, k: int, cap: int) -> "CuckooKmerTable":
        half = cap // 2
        s_bits = int(np.log2(max(half, 1)))
        if s_bits > MAX_NB_BITS:
            raise ValueError("table too large for 25-bit slot index")
        n = len(values)
        hi, lo = kmers.split_packed(packed)
        s0, _ = cls._slot_rem(hi, lo, s_bits, 0)
        s1, _ = cls._slot_rem(hi, lo, s_bits, 1)
        s1 = s1 + half

        occ_key = np.full(cap, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        occ_val = np.zeros(cap, dtype=np.int32)
        FREE = np.uint64(0xFFFFFFFFFFFFFFFF)

        # vectorized greedy: first hash, then second (first key per free
        # slot wins; the rest go to the sequential eviction tail)
        pending = np.arange(n)
        for slots_all in (s0, s1):
            if not len(pending):
                break
            slots = slots_all[pending]
            uniq, first_idx = np.unique(slots, return_index=True)
            free = occ_key[uniq] == FREE
            winners = pending[first_idx[free]]
            occ_key[slots_all[winners]] = packed[winners]
            occ_val[slots_all[winners]] = values[winners]
            placed = np.zeros(len(pending), dtype=bool)
            placed[first_idx[free]] = True
            pending = pending[~placed]

        # sequential cuckoo eviction for the tail
        for i in pending:
            key = packed[i]
            val = int(values[i])
            slot = int(s0[i])
            for _kick in range(cls.MAX_KICKS):
                if occ_key[slot] == FREE:
                    occ_key[slot] = key
                    occ_val[slot] = val
                    break
                # displace the occupant and move it to its alternate slot
                key, occ_key[slot] = occ_key[slot], key
                val, occ_val[slot] = int(occ_val[slot]), val
                khi, klo = kmers.split_packed(np.array([key], np.uint64))
                a0, _ = cls._slot_rem(khi, klo, s_bits, 0)
                a1, _ = cls._slot_rem(khi, klo, s_bits, 1)
                slot = int(a1[0]) + half if int(a0[0]) == slot else int(a0[0])
            else:
                raise RuntimeError("cuckoo insertion failed; grow the table")

        # quotient-compress occupied slots
        occ = occ_key != FREE
        rem_arr = np.full(cap, EMPTY, dtype=np.int32)
        val_arr = np.zeros(cap, dtype=np.int32)
        idx = np.nonzero(occ)[0]
        khi, klo = kmers.split_packed(occ_key[idx])
        in_half1 = idx >= half
        for which, sel in ((0, ~in_half1), (1, in_half1)):
            if not sel.any():
                continue
            slot, rem = cls._slot_rem(khi[sel], klo[sel], s_bits, which)
            expect = slot + (half if which else 0)
            if not np.array_equal(expect, idx[sel]):
                raise AssertionError("cuckoo slot bookkeeping corrupted")
            rem_arr[idx[sel]] = rem
        val_arr[idx] = occ_val[idx]
        return cls(rem_arr, val_arr, n, {"k": k, "s_bits": s_bits})

    # -- probing ----------------------------------------------------------- #

    def probe_host(self, hi: np.ndarray, lo: np.ndarray,
                   default: int = 0) -> tuple[np.ndarray, np.ndarray]:
        hi = np.asarray(hi, dtype=np.int32)
        lo = np.asarray(lo, dtype=np.int32)
        half = self.half
        s_bits = self.s_bits
        s0, r0 = self._slot_rem(hi, lo, s_bits, 0)
        s1, r1 = self._slot_rem(hi, lo, s_bits, 1)
        s1 = s1 + half
        hit0 = self.rem[s0] == r0
        hit1 = self.rem[s1] == r1
        out = np.where(hit0, self.values[s0],
                       np.where(hit1, self.values[s1], default)).astype(np.int32)
        return out, hit0 | hit1

    def lookup_host(self, peptides_codes, default: int = 0):
        """Per-peptide k-mer lookups (host oracle)."""
        results = []
        for codes in peptides_codes:
            packed = kmers.pack_kmers_host(codes, self.k)
            hi, lo = kmers.split_packed(packed)
            vals, found = self.probe_host(hi, lo, default)
            results.append((vals, found))
        return results

    def items(self):
        """(packed_key, value) pairs in slot order (for printindex)."""
        half = self.half
        s_bits = self.s_bits
        occ = np.nonzero(self.rem != EMPTY)[0]
        rem = self.rem[occ].astype(np.uint32)
        slot = np.where(occ < half, occ, occ - half).astype(np.uint32)
        mlo = (slot | ((rem & np.uint32((1 << (25 - s_bits)) - 1))
                       << np.uint32(s_bits))) & MASK25
        mhi = (rem >> np.uint32(25 - s_bits)) & MASK20
        h0, l0 = unmix_key(mhi, mlo)
        h1, l1 = unmix_key2(mhi, mlo)
        hi = np.where(occ < half, h0, h1)
        lo = np.where(occ < half, l0, l1)
        packed = kmers.join_packed(hi.astype(np.int32), lo.astype(np.int32))
        return packed, self.values[occ]

    # -- serialization ------------------------------------------------------ #

    def save(self, path):
        np.savez_compressed(
            path,
            kind=np.bytes_(self.kind),
            rem=self.rem,
            values=self.values,
            n=np.int64(self.n),
            **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
        )

    @staticmethod
    def load(path):
        return load_table(path)


def build_kmer_table(packed: np.ndarray, values: np.ndarray, k: int,
                     layout: str = "bucket8s", **kw):
    """Build a k-mer table in the requested layout.

    Single-gather layouts resolve every query with exactly ONE row
    gather (one probe round + a broadcast-compared overflow stash). The
    default and the size cut-over below were tuned on an earlier
    accelerator, whose gather rate rose as rows narrowed; they are not
    yet measured on this card:

    - ``bucket8s`` (default): 8-slot buckets, 64 B rows. At the default
      0.45 load factor a bucket holds ~1.9 keys on average, leaving
      ~1e-4 of keys in the stash (~200 per 2M) — same memory as
      ``bucket16``, fewer bytes per probe.
    - ``bucket16``: 16-slot buckets, 128 B rows, near-empty stash at
      denser loads — the memory-lean choice for at-scale indexes.
    - ``bucket4s``: 4-slot, 32 B rows, fastest probe but needs ~4x the
      memory to keep the stash small (pass a lower ``load_factor``).
    - ``cuckoo``: two gathers of 8 B — fewest bytes, but two dependent
      row gathers.
    - ``bucket8``/``bucket4``: linear-probing variants (up to 2 rounds,
      2 full gathers); superseded by the ``*s`` single-gather layouts.
    """
    if layout == "bucket8s":
        # Large single tables route to bucket64s (one wide-row gather)
        # instead of narrow cache-sized rows.  The 25-bit bucket-index
        # cap additionally limits bucket-8 tables to 2^25 buckets; only
        # the geometry overflow triggers that fallback — any other
        # error is a real bug and propagates.
        if len(values) <= BUCKET8S_MAX_KEYS:
            kw8 = dict(kw)
            kw8.setdefault("stash_cap", 256)
            try:
                return KmerTable.build(packed, values, k, bucket=8,
                                       max_probe_limit=0, **kw8)
            except TableGeometryError:
                pass
        return build_kmer_table(packed, values, k, layout="bucket64s",
                                **kw)
    if layout == "bucket64s":
        # The at-scale serving layout: one 64-slot (512 B) row gather
        # resolves every query.  It was chosen on an earlier
        # accelerator, whose gather was fastest at full 512 B rows; an
        # H100 reads device memory in 32 B sectors, so it is not yet
        # measured on this card.
        # Same 8 B/slot; sized at load <= 0.5 so the single round's
        # overflow stays within the stash (Poisson(32) beyond 64 slots:
        # ~1e-7 of keys).  Small cache-resident tables keep bucket8s.
        kw.setdefault("stash_cap", 256)
        kw.setdefault("load_factor", 0.5)
        return KmerTable.build(packed, values, k, bucket=64,
                               max_probe_limit=0, **kw)
    if layout == "bucket4s":
        kw.setdefault("stash_cap", 256)
        return KmerTable.build(packed, values, k, bucket=4,
                               max_probe_limit=0, **kw)
    if layout == "bucket16":
        return KmerTable.build(packed, values, k, bucket=16,
                               max_probe_limit=0, **kw)
    if layout == "cuckoo":
        return CuckooKmerTable.build(packed, values, k, **kw)
    if layout in ("bucket8", "bucket"):
        return KmerTable.build(packed, values, k, **kw)
    if layout == "bucket4":
        return KmerTable.build(packed, values, k, bucket=4, **kw)
    raise ValueError(f"unknown k-mer table layout: {layout}")


# ---------------------------------------------------------------------- #
# PeptideTable (fingerprinted, variable-length keys)
# ---------------------------------------------------------------------- #

class FingerprintCollision(ValueError):
    """Two DISTINCT indexed peptides share a 64-bit fingerprint.

    The reference's FST is exact by construction; the fingerprint table
    is exact *for indexed keys* because every build runs this check
    (expected never at realistic sizes: ~n^2/2^65, < 1e-4 at 100M keys
    — but a guarantee beats a bound).  Queried NON-indexed peptides
    retain the probabilistic ~n/2^64 per-query false-positive bound,
    documented in PARITY.md."""


def _check_fingerprint_collisions(peptides, hi: np.ndarray,
                                  lo: np.ndarray) -> None:
    """Exact-confirm pass: any two distinct key strings sharing a
    fingerprint abort the build (identical duplicates are the caller's
    semantics and pass through unchanged)."""
    if len(peptides) < 2:
        return
    key = ((hi.view(np.uint32).astype(np.uint64) << np.uint64(32))
           | lo.view(np.uint32).astype(np.uint64))
    order = np.argsort(key, kind="stable")
    dup = np.flatnonzero(key[order][1:] == key[order][:-1])
    if not len(dup):
        return

    def as_str(p):
        if isinstance(p, str):
            return p
        if isinstance(p, bytes):
            return p.decode()
        return encoding.decode_aa(np.asarray(p, dtype=np.uint8))

    bad = []
    for i in dup:
        a, b = order[i], order[i + 1]
        pa, pb = as_str(peptides[a]), as_str(peptides[b])
        if pa != pb:
            bad.append((pa, pb))
    if bad:
        raise FingerprintCollision(
            f"{len(bad)} fingerprint collision(s) between distinct "
            f"peptides, first: {bad[0][0]!r} vs {bad[0][1]!r}; the "
            "index would return wrong taxa for these keys")


class PeptideTable:
    """Variable-length peptide table keyed by 64-bit fingerprints.

    When ``store_keys`` (default), the original key strings are kept in
    the artifact so ``printindex`` can stream them back (the FST does
    this intrinsically; we store a newline-joined blob).

    Every build runs an exact-confirm pass over the fingerprints
    (:func:`_check_fingerprint_collisions`), so lookups of INDEXED keys
    are exact like the reference's FST — a collision aborts the build
    instead of silently merging two peptides' taxa."""

    kind = "peptide"

    def __init__(self, key_hi, key_lo, values, max_probes: int, n: int, meta=None):
        self.key_hi = key_hi
        self.key_lo = key_lo
        self.values = values
        self.max_probes = int(max_probes)
        self.n = int(n)
        self.meta = dict(meta or {})
        self.raw_keys = None
        self.raw_values = None

    @property
    def capacity(self) -> int:
        return len(self.values)

    @property
    def n_buckets(self) -> int:
        return max(self.capacity // BUCKET, 1)

    @classmethod
    def build(cls, peptides, values: np.ndarray,
              load_factor: float = 0.45, store_keys: bool = True,
              capacity: int | None = None) -> "PeptideTable":
        """``capacity`` pins the table size (power of two) — used by the
        sharded build so every shard's rows stay rectangular."""
        peptides = list(peptides)
        hi, lo = _fingerprints(peptides)
        _check_fingerprint_collisions(peptides, hi, lo)
        cap = capacity or _pow2_capacity(len(values), load_factor, 64)
        n_buckets = max(cap // BUCKET, 1)
        bucket0 = (hash32(hi, lo) & np.uint32(n_buckets - 1)).astype(np.int64)
        (kh, kl, kv), max_probes, _ = _insert_bucketized(
            bucket0, [hi, lo, values.astype(np.int32)], cap)
        t = cls(kh, kl, kv, max_probes, len(values))
        if store_keys:
            t.raw_keys = [
                p if isinstance(p, str) else encoding.decode_aa(p) for p in peptides
            ]
            t.raw_values = np.asarray(values, dtype=np.int32)
        return t

    def probe_host(self, hi: np.ndarray, lo: np.ndarray,
                   default: int = 0) -> tuple[np.ndarray, np.ndarray]:
        hi = np.asarray(hi, dtype=np.int32)
        lo = np.asarray(lo, dtype=np.int32)
        nb = self.n_buckets
        kh = self.key_hi.reshape(nb, BUCKET)
        kl = self.key_lo.reshape(nb, BUCKET)
        kv = self.values.reshape(nb, BUCKET)
        bucket = (hash32(hi, lo) & np.uint32(nb - 1)).astype(np.int64)
        out = np.full(hi.shape, default, dtype=np.int32)
        found = np.zeros(hi.shape, dtype=bool)
        live = np.ones(hi.shape, dtype=bool)
        for _ in range(self.max_probes + 1):
            if not live.any():
                break
            rh = kh[bucket]
            rl = kl[bucket]
            rv = kv[bucket]
            hit8 = (rh == hi[..., None]) & (rl == lo[..., None])
            anyhit = hit8.any(axis=-1)
            val = np.take_along_axis(
                rv, np.argmax(hit8, axis=-1)[..., None], axis=-1)[..., 0]
            newly = live & anyhit
            out[newly] = val[newly]
            found |= newly
            has_empty = (rh == EMPTY).any(axis=-1)
            live = live & ~anyhit & ~has_empty
            bucket = (bucket + 1) % nb
        return out, found

    def lookup_peptides_host(self, peptides, default: int = 0):
        hi, lo = _fingerprints(list(peptides))
        return self.probe_host(hi, lo, default)

    def save(self, path):
        extra = {}
        if self.raw_keys is not None:
            extra["raw_keys"] = np.frombuffer(
                "\n".join(self.raw_keys).encode(), dtype=np.uint8
            )
            extra["raw_values"] = self.raw_values
        np.savez_compressed(
            path,
            kind=np.bytes_(self.kind),
            key_hi=self.key_hi,
            key_lo=self.key_lo,
            values=self.values,
            max_probes=np.int64(self.max_probes),
            n=np.int64(self.n),
            **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
            **extra,
        )

    @staticmethod
    def load(path):
        return load_table(path)


def mmap_npz(path):
    """Memory-map the arrays of an UNCOMPRESSED .npz in place.

    ``np.load(mmap_mode=...)`` ignores mmap for .npz members, so serving
    cold-starts would otherwise materialize multi-GB artifacts through a
    full read.  Uncompressed npz members are raw .npy blobs at fixed
    offsets inside the zip; this maps each one directly — the analogue
    of the reference's default mmap'd FST load
    (/root/reference/src/commands/pept2lca.rs:74-79: `-m` opts INTO a
    RAM load; mmap is the default).  Raises ValueError on compressed
    members (callers fall back to a full load)."""
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{info.filename} is deflated; mmap needs an "
                    "uncompressed npz (np.savez, not savez_compressed)")
            # local file header: 30 fixed bytes + name + extra
            f.seek(info.header_offset)
            hdr = f.read(30)
            nlen = int.from_bytes(hdr[26:28], "little")
            elen = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + 30 + nlen + elen)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            if dtype.hasobject:
                raise ValueError("object arrays cannot be mmapped")
            name = info.filename
            if name.endswith(".npy"):
                name = name[: -len(".npy")]
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


class _MmapNpz(dict):
    """dict of memmaps quacking enough like an NpzFile for load_table."""

    @property
    def files(self):
        return list(self.keys())


def load_table(path, mmap: bool = False):
    """Load either table kind from an .npz artifact.

    ``mmap=True`` memory-maps the slot arrays instead of reading them
    (uncompressed artifacts only — the distributed build's serving
    shards are; compressed artifacts silently fall back to a full
    load).  Cold-start is then bounded by the device transfer, which
    faults pages straight from the file."""
    if mmap:
        try:
            z = _MmapNpz(mmap_npz(path))
        except ValueError:
            z = np.load(path, allow_pickle=False)
    else:
        z = np.load(path, allow_pickle=False)
    kind = bytes(z["kind"]).decode()
    meta = {k[len("meta_"):]: int(z[k]) for k in z.files if k.startswith("meta_")}
    if kind == "kmer":
        if "rows" in z.files:  # packed wire-layout artifact
            return KmerTable(None, None, int(z["max_probes"]),
                             int(z["n"]), meta,
                             stash_hi=z.get("stash_hi"),
                             stash_lo=z.get("stash_lo"),
                             stash_val=z.get("stash_val"),
                             rows_packed=z["rows"])
        return KmerTable(z["rem"], z["values"], int(z["max_probes"]),
                         int(z["n"]), meta,
                         stash_hi=z.get("stash_hi"),
                         stash_lo=z.get("stash_lo"),
                         stash_val=z.get("stash_val"))
    if kind == "cuckoo":
        return CuckooKmerTable(z["rem"], z["values"], int(z["n"]), meta)
    t = PeptideTable(z["key_hi"], z["key_lo"], z["values"],
                     int(z["max_probes"]), int(z["n"]), meta)
    if "raw_keys" in z.files:
        blob = z["raw_keys"].tobytes().decode()
        t.raw_keys = blob.split("\n") if blob else []
        t.raw_values = z["raw_values"]
    return t
