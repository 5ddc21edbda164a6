"""Device-side table probing.

The probe is the throughput core of the whole framework — the analogue
of the reference's ``fst.get`` per k-mer hot loop
(/root/reference/src/commands/prot2kmer2lca.rs:174-179).

K-mer tables are quotient-stored (see :mod:`umgap_tpu.index.table`):
8-slot buckets of (30-bit remainder + 2-bit probe distance, value), so
one probe round is a single contiguous 64-byte row gather from HBM
followed by an 8-wide vector compare, and the build guarantees at most
two rounds — statically unrolled, no ``while_loop`` syncs. Peptide
tables store full 64-bit fingerprints (96-byte rows).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..index.table import (
    BUCKET,
    mix_key,
    mix_key2,
)


@jax.tree_util.register_pytree_node_class
class DeviceTable:
    """Device-resident view of an index table (packed bucket rows).

    A registered pytree whose only array leaf is ``rows`` — pass tables
    as *arguments* to jitted functions (a closed-over table would be
    embedded in the program as a constant, bloating compiles).
    """

    def __init__(self, rows, max_probes: int, kind: str, nb_bits: int,
                 bucket: int = BUCKET, stash=None, group: int = 1):
        self.rows = rows  # (group * n_buckets, 2*bucket or 3*bucket) int32
        self.max_probes = max_probes
        self.kind = kind
        self.nb_bits = nb_bits
        self.bucket = bucket
        # ``group`` > 1 stacks several same-capacity sub-shard tables
        # along the bucket axis (e.g. one device of a mesh holding
        # multiple hash-range shards of a distributed build); probes
        # then take a per-query ``sub`` index selecting the sub-table.
        self.group = group
        # (S, 3) int32 [key_hi, key_lo, value] overflow stash (may be
        # empty); compared against every query by broadcast, not gather.
        # Grouped tables concatenate their sub-shards' stashes — the
        # compare is on full keys, and a key belongs to exactly one
        # shard, so the flat compare stays exact.
        self.stash = jnp.zeros((0, 3), jnp.int32) if stash is None else stash

    def tree_flatten(self):
        return (self.rows, self.stash), (self.max_probes, self.kind,
                                         self.nb_bits, self.bucket,
                                         self.group)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux[:4], stash=children[1], group=aux[4])

    @property
    def n_buckets(self) -> int:
        """Per-sub-table bucket count."""
        return self.rows.shape[0] // self.group

    @classmethod
    def from_host(cls, table, device=None) -> "DeviceTable":
        rows = pack_rows(table)
        put = (lambda x: jax.device_put(x, device)) if device else jnp.asarray
        if table.kind == "kmer":
            nb_bits = table.nb_bits
        elif table.kind == "cuckoo":
            nb_bits = table.s_bits
        else:
            nb_bits = 0
        bucket = getattr(table, "bucket", BUCKET)
        sh = getattr(table, "stash_hi", None)
        if sh is not None and len(sh):
            stash = put(np.stack(
                [sh, table.stash_lo, table.stash_val], axis=1
            ).astype(np.int32))
        else:
            stash = put(np.zeros((0, 3), np.int32))
        return cls(put(rows), int(table.max_probes), table.kind, nb_bits,
                   bucket, stash=stash)


def pack_rows(table) -> np.ndarray:
    """Concatenate a host table's slot arrays into per-bucket rows.

    Packed artifacts (``KmerTable.save(packed=True)``) already store
    this exact layout — return it untouched (possibly an mmap, so a
    serving cold start is pure disk->HBM transfer, no host repack)."""
    rp = getattr(table, "rows_packed", None)
    if rp is not None:
        return rp
    if table.kind == "cuckoo":
        cap = table.capacity
        return np.stack(
            [table.rem.astype(np.int32), table.values.astype(np.int32)],
            axis=1,
        )  # (cap, 2)
    nb = table.n_buckets
    bk = getattr(table, "bucket", BUCKET)
    if table.kind == "kmer":
        return np.concatenate(
            [table.rem.reshape(nb, bk), table.values.reshape(nb, bk)],
            axis=1,
        ).astype(np.int32)
    return np.concatenate(
        [
            table.key_hi.reshape(nb, bk),
            table.key_lo.reshape(nb, bk),
            table.values.reshape(nb, bk),
        ],
        axis=1,
    ).astype(np.int32)


# index.table.hash32 is dtype-generic (numpy scalar constants broadcast
# over jax arrays) — one definition serves host and device, so the
# build-time and probe-time bucket hashes can never drift apart.
from ..index.table import hash32 as hash32_device  # noqa: E402 isort:skip


# Gathered-row working set allowed per probe chunk. The gather
# materializes a (Q, row_width) int32 buffer; at production batch sizes
# against a bucket64s table that is GBs (16k pairs -> ~8.85M queries x
# 512 B ~= 4.5 GB). Chunking the flat query axis through lax.map bounds
# the buffer, so peak activation memory drops ~Q/chunk-fold. The chunk
# size was tuned on an earlier accelerator and is not yet measured on
# this card.
PROBE_CHUNK_BYTES = 256 << 20


def probe(table: DeviceTable, hi: jax.Array, lo: jax.Array,
          valid: jax.Array | None = None, default: int = 0,
          sub: jax.Array | None = None,
          chunk_bytes: int = PROBE_CHUNK_BYTES):
    """Look up packed keys. Returns (values, found).

    Args:
      table: device table (packed bucket rows).
      hi, lo: int32 key lanes (packed k-mer halves for kmer tables,
        fingerprint halves for peptide tables), any shape.
      valid: optional bool mask; invalid lanes return ``default``/False.
      default: value for misses (0 reproduces the reference's `-o`).
      sub: per-query sub-table index (int32, same shape as ``hi``) for
        grouped tables (``table.group`` > 1): the query's bucket is
        taken inside sub-table ``sub`` — linear probing wraps within
        the sub-table, never crossing into a neighbour shard.
      chunk_bytes: cap on the gathered-row buffer; query batches whose
        rows exceed 2x this are probed in sequential chunks (identical
        results, bounded memory).
    """
    live = jnp.ones(hi.shape, dtype=bool) if valid is None else valid
    if table.group > 1 and sub is None:
        raise ValueError("grouped table probe requires a sub index")

    row_bytes = 4 * int(table.rows.shape[-1])
    q_total = 1
    for d in hi.shape:
        q_total *= int(d)
    if (table.kind != "cuckoo" and chunk_bytes
            and q_total * row_bytes > 2 * chunk_bytes):
        shape = hi.shape
        qc = max(chunk_bytes // row_bytes, 1)
        n_chunks = -(-q_total // qc)
        pad = n_chunks * qc - q_total

        def flat(x, fill):
            x = x.reshape(-1)
            if pad:
                x = jnp.concatenate(
                    [x, jnp.full((pad,), fill, x.dtype)])
            return x.reshape(n_chunks, qc)

        args = (flat(hi, 0), flat(lo, 0), flat(live, False),
                None if sub is None else flat(sub, 0))

        def one(chunk):
            chi, clo, clive, csub = chunk
            return _probe_dense(table, chi, clo, clive, default, csub)

        out_c, found_c = jax.lax.map(one, args)
        out = out_c.reshape(-1)[:q_total].reshape(shape)
        found = found_c.reshape(-1)[:q_total].reshape(shape)
        return out, found

    return _probe_dense(table, hi, lo, live, default, sub)


def _probe_dense(table: DeviceTable, hi, lo, live, default, sub):
    """One-shot probe (gathers all rows at once); see :func:`probe`."""
    out = jnp.full(hi.shape, default, dtype=jnp.int32)
    found = jnp.zeros(hi.shape, dtype=bool)
    valid = live

    if table.kind == "cuckoo":
        if table.group > 1:
            raise ValueError("cuckoo tables do not support grouping")
        # two-half quotient cuckoo: 2 gathers x 2 int32 per query (the
        # minimal exact probe; see index.table.CuckooKmerTable)
        s_bits = table.nb_bits
        half = jnp.int32(1 << s_bits)
        half_mask = np.uint32((1 << s_bits) - 1)

        def slot_rem(mixer):
            mhi, mlo = mixer(hi, lo)
            slot = (mlo & half_mask).astype(jnp.int32)
            rem = ((mlo >> np.uint32(s_bits))
                   | (mhi << np.uint32(25 - s_bits))).astype(jnp.int32)
            return slot, rem

        s0, r0 = slot_rem(mix_key)
        s1, r1 = slot_rem(mix_key2)
        row0 = jnp.take(table.rows, s0, axis=0)         # (..., 2)
        row1 = jnp.take(table.rows, s1 + half, axis=0)  # (..., 2)
        hit0 = (row0[..., 0] == r0) & live
        hit1 = (row1[..., 0] == r1) & live
        out = jnp.where(hit0, row0[..., 1],
                        jnp.where(hit1, row1[..., 1], out))
        return out, hit0 | hit1

    nb = table.n_buckets
    base = None if sub is None else sub.astype(jnp.int32) * jnp.int32(nb)
    if table.kind == "kmer":
        nb_bits = table.nb_bits
        mhi, mlo = mix_key(hi, lo)
        bucket = (mlo & np.uint32(nb - 1)).astype(jnp.int32)
        rem = ((mlo >> np.uint32(nb_bits))
               | (mhi << np.uint32(25 - nb_bits))).astype(jnp.int32)
        bk = table.bucket
        for r in range(table.max_probes + 1):
            row = jnp.take(table.rows,
                           bucket if base is None else base + bucket,
                           axis=0)  # (..., 2*bk)
            rr = row[..., 0:bk]
            rv = row[..., bk:2 * bk]
            tag = rem | jnp.int32(min(r, 1) << 30)
            hit8 = rr == tag[..., None]
            anyhit = jnp.any(hit8, axis=-1)
            val = jnp.sum(jnp.where(hit8, rv, 0), axis=-1)
            newly = live & anyhit
            out = jnp.where(newly, val, out)
            found = found | newly
            has_empty = jnp.any(rr == jnp.int32(-1), axis=-1)
            live = live & ~anyhit & ~has_empty
            bucket = (bucket + 1) & jnp.int32(nb - 1)
        if table.stash.shape[0]:
            mask = jnp.ones(hi.shape, dtype=bool) if valid is None else valid
            eq = ((hi[..., None] == table.stash[:, 0])
                  & (lo[..., None] == table.stash[:, 1]))  # (..., S)
            shit = jnp.any(eq, axis=-1) & mask
            sval = jnp.sum(jnp.where(eq, table.stash[:, 2], 0), axis=-1)
            out = jnp.where(shit, sval, out)
            found = found | shit
        return out, found

    # peptide (fingerprint) table
    bucket = (hash32_device(hi, lo) & jnp.uint32(nb - 1)).astype(jnp.int32)
    bk = table.bucket
    for _ in range(table.max_probes + 1):
        row = jnp.take(table.rows,
                       bucket if base is None else base + bucket,
                       axis=0)  # (..., 3*bk)
        rh = row[..., 0:bk]
        rl = row[..., bk:2 * bk]
        rv = row[..., 2 * bk:3 * bk]
        hit8 = (rh == hi[..., None]) & (rl == lo[..., None])
        anyhit = jnp.any(hit8, axis=-1)
        val = jnp.sum(jnp.where(hit8, rv, 0), axis=-1)
        newly = live & anyhit
        out = jnp.where(newly, val, out)
        found = found | newly
        has_empty = jnp.any(rh == jnp.int32(-1), axis=-1)
        live = live & ~anyhit & ~has_empty
        bucket = (bucket + 1) & jnp.int32(nb - 1)
    return out, found
