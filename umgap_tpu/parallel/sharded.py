"""Sharded k-mer table with all-to-all probe routing.

The reference keeps one full copy of the ~100 GB FST per host (its
src/commands/prot2kmer2lca.rs:109-114). Here: partition
keys by a hash-range function across the mesh, keep one shard per
device in device memory, and for each batch route every query to its
owner shard with ``lax.all_to_all``, probe locally, and route results
back. Reads stay data-parallel on the same mesh axis.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.table import build_kmer_table, hash32
from ..ops import kmers as kmerops
from ..ops import lookup


def owner_of(hi, lo, n_shards: int, kind: str = "kmer"):
    """Shard owner by range-partitioning a hash's upper 16 bits.

    ``kmer``: the k-mer probe's bucket index comes from ``mix_key``'s
    low bits, so ``hash32``'s top bits are independent of it.
    ``peptide``: the peptide probe's bucket index IS ``hash32(hi, lo)``
    (low bits), so the owner mixes the swapped lanes instead — large
    shards (bucket bits beyond 16) stay uniformly filled."""
    host = isinstance(hi, np.ndarray)
    if kind == "peptide":
        h = hash32(lo, hi) if host else lookup.hash32_device(lo, hi)
    else:
        h = hash32(hi, lo) if host else lookup.hash32_device(hi, lo)
    top = (h >> 16).astype(np.uint32 if host else jnp.uint32)
    return ((top * np.uint32(n_shards)) >> np.uint32(16)).astype(
        np.int32 if host else jnp.int32
    )


def build_sharded_tables(packed: np.ndarray, values: np.ndarray, k: int,
                         n_shards: int, load_factor: float = 0.4,
                         layout: str = "bucket8s"):
    """Split keys by owner and build per-shard tables with one common
    capacity (so the stacked arrays are rectangular). Grows the common
    capacity until every shard builds within its probe limits."""
    from ..index.table import BUCKET, MIN_NB_BITS, _pow2_capacity

    packed = packed.astype(np.uint64)
    hi, lo = kmerops.split_packed(packed)
    owner = owner_of(hi, lo, n_shards)
    max_n = max(
        (int((owner == s).sum()) for s in range(n_shards)), default=1)
    cap = _pow2_capacity(max_n, load_factor, BUCKET << MIN_NB_BITS)
    # Build shard-by-shard; a shard that fails its probe limits doubles
    # the COMMON capacity and only the failed/remaining shards rebuild
    # (already-built smaller shards are rebuilt once at the end so all
    # stacked rows stay rectangular).
    shards: list = []
    s = 0
    grew = False
    while s < n_shards:
        try:
            shards.append(
                build_kmer_table(packed[owner == s], values[owner == s], k,
                                 layout=layout, capacity=cap))
            s += 1
        except RuntimeError:
            cap *= 2
            grew = True
    if grew:
        shards = [
            t if t.capacity == cap else build_kmer_table(
                packed[owner == i], values[owner == i], k,
                layout=layout, capacity=cap)
            for i, t in enumerate(shards)
        ]
    return shards


def build_sharded_peptide_tables(peptides, values: np.ndarray,
                                 n_shards: int, load_factor: float = 0.45,
                                 store_keys: bool = False):
    """Partition tryptic peptides by fingerprint owner and build
    per-shard :class:`~umgap_tpu.index.table.PeptideTable`s with one
    common capacity (rectangular stacked rows).  The sharded analogue
    of the reference's single tryptic FST
    (/root/reference/src/commands/prot2tryp2lca.rs:100-139)."""
    from ..index.table import PeptideTable, _fingerprints, _pow2_capacity

    peptides = list(peptides)
    values = np.asarray(values, dtype=np.int32)
    hi, lo = _fingerprints(peptides)
    owner = owner_of(hi, lo, n_shards, kind="peptide")
    max_n = max((int((owner == s).sum()) for s in range(n_shards)),
                default=1)
    cap = _pow2_capacity(max_n, load_factor, 64)
    shards = []
    for s in range(n_shards):
        sel = owner == s
        shards.append(PeptideTable.build(
            [p for p, o in zip(peptides, owner) if o == s], values[sel],
            capacity=cap, store_keys=store_keys))
    return shards


@jax.tree_util.register_pytree_node_class
class ShardedTable:
    """Stacked packed shard rows, shard axis laid out over the mesh
    (registered pytree; pass as a jit argument)."""

    def __init__(self, rows, max_probes: int, n_shards: int, kind: str,
                 nb_bits: int, bucket: int, stash=None, group: int = 1):
        self.rows = rows  # (n_devices, group * n_buckets, row_width) int32
        self.max_probes = max_probes
        # total LOGICAL hash-range shards = n_devices * group; with
        # ``group`` > 1 each device holds ``group`` adjacent shards
        # stacked along the bucket axis (range partitioning makes the
        # device owner a pure prefix of the shard owner: owner_dev =
        # owner_shard // group)
        self.n_shards = n_shards
        self.kind = kind
        self.nb_bits = nb_bits
        self.bucket = bucket
        self.group = group
        # (n_devices, S, 3) int32 [key_hi, key_lo, value]; rows padded
        # with key_hi = -1 (impossible: packed hi has <= 20 bits)
        nd = n_shards // group
        self.stash = (jnp.zeros((nd, 0, 3), jnp.int32)
                      if stash is None else stash)

    @property
    def n_devices(self) -> int:
        return self.n_shards // self.group

    def tree_flatten(self):
        return (self.rows, self.stash), (self.max_probes, self.n_shards,
                                         self.kind, self.nb_bits,
                                         self.bucket, self.group)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux[:5], stash=children[1], group=aux[5])

    @classmethod
    def from_shards(cls, shards, mesh: Mesh, axis: str = "x",
                    devices: int | None = None) -> "ShardedTable":
        """Stack host shard tables over the mesh axis.

        With ``len(shards)`` == the mesh extent, one shard per device
        (the original layout). With more shards than devices (HBM-
        filling production artifacts: e.g. a 16-shard ``buildindex-dist``
        build served on 8 — or 1 — chips), each device holds
        ``len(shards) / n_devices`` ADJACENT shards stacked along the
        bucket axis and probes select the sub-shard per query; the shard
        count must be a multiple of the device count."""
        n = len(shards)
        if devices is None:
            devices = 1
            for a in ((axis,) if isinstance(axis, str) else axis):
                devices *= mesh.shape[a]
        if n % devices:
            raise ValueError(
                f"{n} shards cannot be grouped onto {devices} devices")
        group = n // devices
        sharding = NamedSharding(mesh, P(axis, None, None))
        t0 = shards[0]
        b0 = getattr(t0, "bucket", None)
        for i, t in enumerate(shards):
            if (t.capacity != t0.capacity or t.kind != t0.kind
                    or getattr(t, "bucket", None) != b0
                    or t.max_probes != t0.max_probes):
                raise ValueError(
                    f"shard {i} geometry mismatch: capacity="
                    f"{t.capacity} kind={t.kind} "
                    f"bucket={getattr(t, 'bucket', None)} "
                    f"max_probes={t.max_probes} vs shard 0's "
                    f"capacity={t0.capacity} kind={t0.kind} bucket={b0} "
                    f"max_probes={t0.max_probes} "
                    "— shards of one serving table must share one "
                    "layout (mixed bucket16/bucket64s/bucket64d "
                    "artifacts in one workdir?)")
        # Memory-lean assembly: one PER-DEVICE block at a time from the
        # (possibly mmap'd, possibly pre-packed) shard rows, put to its
        # device, then freed — peak host memory is one device's slice,
        # not the whole artifact (a 68.7 GB table + a full host-stacked
        # copy would not fit the build host's RAM). With one device and
        # one packed shard the mmap goes to device_put as a zero-copy
        # view, making cold start pure transfer.
        r0 = lookup.pack_rows(t0)
        nb_rows, width = r0.shape
        global_shape = (devices, group * nb_rows, width)

        def device_block(d: int) -> np.ndarray:
            if group == 1:
                t = shards[d]
                return np.asarray(r0 if t is t0 else lookup.pack_rows(t))[
                    None]
            block = np.empty((1, group * nb_rows, width), np.int32)
            for g in range(group):
                t = shards[d * group + g]
                block[0, g * nb_rows:(g + 1) * nb_rows] = (
                    r0 if t is t0 else lookup.pack_rows(t))
            return block
        if t0.kind == "kmer":
            nb_bits = t0.nb_bits
        elif t0.kind == "cuckoo":
            nb_bits = t0.s_bits
        else:
            nb_bits = 0
        smax = max((sum(len(getattr(t, "stash_hi", []))
                        for t in shards[d * group : (d + 1) * group])
                    for d in range(devices)), default=0)
        stash = np.full((devices, smax, 3), -1, np.int32)
        stash[:, :, 2] = 0
        for d in range(devices):
            at = 0
            for t in shards[d * group : (d + 1) * group]:
                sh = getattr(t, "stash_hi", None)
                if sh is not None and len(sh):
                    stash[d, at : at + len(sh), 0] = sh
                    stash[d, at : at + len(sh), 1] = t.stash_lo
                    stash[d, at : at + len(sh), 2] = t.stash_val
                    at += len(sh)
        # Assemble the global sharded array device by device; with
        # replicated extra mesh axes the same block is reused per
        # replica (indices_map names every device's slice).
        imap = sharding.addressable_devices_indices_map(global_shape)
        cache_d, cache_block = -1, None
        per_dev = []
        for dev, idx in imap.items():
            d = idx[0].start or 0
            if d != cache_d:
                cache_d, cache_block = d, device_block(d)
            per_dev.append(jax.device_put(cache_block, dev))
        cache_block = None
        rows = jax.make_array_from_single_device_arrays(
            global_shape, sharding, per_dev)
        return cls(
            rows=rows,
            max_probes=max(t.max_probes for t in shards),
            n_shards=n,
            kind=t0.kind,
            nb_bits=nb_bits,
            bucket=getattr(t0, "bucket", 8),
            stash=jax.device_put(stash, sharding),
            group=group,
        )


def _flat_axis_index(axis):
    """This device's index along a (possibly tuple) mesh axis, major
    axis first — matches all_to_all's flattened product-axis order."""
    if isinstance(axis, (tuple, list)):
        idx = jnp.int32(0)
        for a in axis:
            idx = idx * jax.lax.psum(1, a) + jax.lax.axis_index(a)
        return idx
    return jax.lax.axis_index(axis)


def sharded_probe_local(local_hi, local_lo, local_valid,
                        shard_rows, max_probes: int,
                        axis, default: int = 0,
                        kind: str = "kmer", nb_bits: int = 0,
                        bucket: int = 8, shard_stash=None,
                        group: int = 1):
    """Probe inside shard_map: local queries of any shape; the local
    table shard's packed rows. Routes via all_to_all both ways.
    ``axis`` may be one mesh axis name or a tuple of names (host, chip)
    — collectives then span the flattened product axis.

    ``group`` > 1: this device holds ``group`` adjacent logical shards
    stacked along the bucket axis; routing stays device-level (range
    partitioning: device owner = shard owner // group) and the local
    probe selects each query's sub-shard."""
    n = jax.lax.psum(1, axis)
    shape = local_hi.shape
    hi = local_hi.reshape(-1)
    lo = local_lo.reshape(-1)
    valid = local_valid.reshape(-1)
    B = hi.shape[0]

    owner = owner_of(hi, lo, n, kind=kind)
    owner = jnp.where(valid, owner, 0)

    # stable sort by owner; rank within owner group
    order = jnp.argsort(owner, stable=True)
    inv = jnp.argsort(order, stable=True)  # query -> sorted position
    sorted_owner = owner[order]
    counts = jax.ops.segment_sum(jnp.ones_like(owner), owner, num_segments=n)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(B, dtype=jnp.int32) - starts[sorted_owner].astype(jnp.int32)

    # scatter into (n, B) buckets
    def bucketize(x, fill):
        buckets = jnp.full((n, B), fill, x.dtype)
        return buckets.at[sorted_owner, rank].set(x[order])

    b_hi = bucketize(hi, jnp.int32(-1))
    b_lo = bucketize(lo, jnp.int32(-1))
    b_valid = bucketize(valid, False)

    # exchange: row j of the result = queries device j sends to me
    r_hi = jax.lax.all_to_all(b_hi, axis, 0, 0, tiled=False)
    r_lo = jax.lax.all_to_all(b_lo, axis, 0, 0, tiled=False)
    r_valid = jax.lax.all_to_all(b_valid, axis, 0, 0, tiled=False)

    local_table = lookup.DeviceTable(shard_rows, max_probes, kind, nb_bits,
                                     bucket, stash=shard_stash, group=group)
    sub = None
    if group > 1:
        # recompute the query's logical-shard owner locally (the key
        # rides with the query); my sub-shards are the ``group``
        # adjacent owners starting at my_device * group
        own = owner_of(r_hi, r_lo, n * group, kind=kind)
        sub = jnp.clip(own - _flat_axis_index(axis) * jnp.int32(group),
                       0, group - 1)
    vals, found = lookup.probe(local_table, r_hi, r_lo, valid=r_valid,
                               default=default, sub=sub)

    # route results back and unscatter
    back_vals = jax.lax.all_to_all(vals, axis, 0, 0, tiled=False)
    back_found = jax.lax.all_to_all(found, axis, 0, 0, tiled=False)
    out_sorted_v = back_vals[sorted_owner, rank]
    out_sorted_f = back_found[sorted_owner, rank]
    out_v = out_sorted_v[inv]
    out_f = out_sorted_f[inv]
    out_v = jnp.where(valid, out_v, default)
    out_f = out_f & valid
    return out_v.reshape(shape), out_f.reshape(shape)


def _agg_tail(dtax, hits, config, euler, n_ranks: int, axis,
              with_overflow: bool):
    """Shared taxa2agg tail of the sharded pipelines: dedup + filter +
    aggregate + snap + psum'd rank-frequency merge (the taxa2freq
    analogue; see parallel/freq.py for the standalone byte-identical
    command path)."""
    from ..agg import device as devagg

    utaxa, ucounts, uvalid, nuniq = devagg.dedup_counts(
        hits, jnp.ones_like(hits, jnp.float32), config.k_max,
        return_nuniq=True)
    uvalid = devagg.filter_lower_bound(ucounts, uvalid, config.lower_bound)
    agg = devagg.aggregate_batch(
        dtax, utaxa, ucounts, uvalid, config.method, config.strategy,
        config.factor, euler=euler)
    snapped = devagg.snap_batch(dtax.snap_valid, agg, default=0)
    nonempty = uvalid.any(axis=-1)
    out = jnp.where(nonempty, snapped, 1).astype(jnp.int32)

    # taxa2freq analogue: per-rank counts, psum-merged across chips
    ranks_of = devagg.snap_batch(dtax.snap_ranked, out, default=0)
    freq = jax.ops.segment_sum(
        jnp.ones_like(ranks_of, jnp.float32),
        jnp.clip(ranks_of, 0, n_ranks - 1),
        num_segments=n_ranks)
    freq = jax.lax.psum(freq, axis)
    if with_overflow:
        return out, freq, nuniq > config.k_max
    return out, freq


def _finish_sharded(local_step, stable: ShardedTable, mesh: Mesh, axis,
                    euler, with_overflow: bool):
    """Wrap a local step in shard_map + jit with the standard specs.
    The euler pytree (or a placeholder) rides replicated (P())."""
    from jax import shard_map

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis, None, None),
                  P(axis, None, None), P()),
        out_specs=(P(axis), P(), P(axis)) if with_overflow
        else (P(axis), P()),
        check_vma=False,
    )  # ``axis`` may be a tuple (host, chip): reads and table shards
    # then split over the flattened product axis, host-major

    @jax.jit
    def step(dna, lengths, rows, stash, eu):
        return fn(dna, lengths, rows, stash, eu)

    placeholder = euler if euler is not None else jnp.zeros((0,), jnp.int32)
    return lambda dna, lengths: step(dna, lengths, stable.rows,
                                     stable.stash, placeholder)


def make_sharded_pipeline(dtax, stable: ShardedTable, config, mesh: Mesh,
                          axis="x", n_ranks: int | None = None,
                          euler=None, with_overflow: bool = False,
                          wire: str = "codes", length: int | None = None):
    """The fused 9-mer pipeline under shard_map: reads data-parallel
    over the mesh, table sharded over the same axis, probes routed
    all-to-all.  ``euler`` (a DeviceEuler, replicated over the mesh)
    enables rmq/lca* aggregation; ``with_overflow`` adds a per-read
    k_max-overflow flag (see :class:`ShardedAnalyser` for the exact
    wide-program reroute).  ``wire='packed4'`` accepts 4-bit packed DNA
    (pass the unpacked ``length``), halving the host->device transfer
    like the single-chip pipeline."""
    if n_ranks is None:
        n_ranks = int(dtax.snap_ranked.shape[0])
    from ..agg.device_rmq import DeviceEuler
    from ..ops import encoding, seedextend, translate

    table = encoding.get_table(config.table_number)

    def local_step(dna, lengths, shard_rows, shard_stash, eu):
        # shard axis arrives with a leading length-1 mesh dim
        shard_rows = shard_rows[0]
        shard_stash = shard_stash[0]
        eu = eu if isinstance(eu, DeviceEuler) else None
        if wire == "packed4":
            dna = encoding.unpack_dna4_device(dna, length)
        B, E, L = dna.shape
        aa, plens = translate.translate6_batch(
            dna.reshape(B * E, L), lengths.reshape(B * E), table)
        hi, lo, wvalid = kmerops.pack_windows_batch(aa, plens, config.k)
        taxa, _found = sharded_probe_local(
            hi, lo, wvalid, shard_rows,
            stable.max_probes, axis, default=0,
            kind=stable.kind, nb_bits=stable.nb_bits, bucket=stable.bucket,
            shard_stash=shard_stash, group=stable.group)
        taxa = jnp.where(wvalid, taxa, 0)
        W = taxa.shape[-1]
        nk = jnp.maximum(plens - (config.k - 1), 0)
        keep = seedextend.seedextend_mask_batch(
            taxa, nk, config.min_seed_size, config.max_gap_size)
        hits = jnp.where(keep, taxa, 0).reshape(B, E * 6 * W)
        return _agg_tail(dtax, hits, config, eu, n_ranks, axis,
                         with_overflow)

    return _finish_sharded(local_step, stable, mesh, axis, euler,
                           with_overflow)


def make_sharded_tryptic_pipeline(dtax, stable: ShardedTable, config,
                                  mesh: Mesh, axis="x",
                                  n_ranks: int | None = None,
                                  euler=None, with_overflow: bool = False,
                                  min_len: int | None = None,
                                  max_len: int | None = None,
                                  wire: str = "codes",
                                  length: int | None = None):
    """The fused tryptic pipeline under shard_map: 6-frame translate +
    device digest locally, peptide fingerprints routed all-to-all to
    their owner shard (matching prot2tryp2lca semantics,
    /root/reference/src/commands/prot2tryp2lca.rs:100-139), misses
    dropped, taxa2agg tail merged like the 9-mer path."""
    if n_ranks is None:
        n_ranks = int(dtax.snap_ranked.shape[0])
    from ..agg.device_rmq import DeviceEuler
    from ..ops import encoding, translate
    from ..pipeline.tryptic import (
        MAX_PEP,
        MIN_PEP,
        tryptic_digest_device,
    )

    mn = MIN_PEP if min_len is None else min_len
    mx = MAX_PEP if max_len is None else max_len
    table = encoding.get_table(config.table_number)

    def local_step(dna, lengths, shard_rows, shard_stash, eu):
        shard_rows = shard_rows[0]
        shard_stash = shard_stash[0]
        eu = eu if isinstance(eu, DeviceEuler) else None
        if wire == "packed4":
            dna = encoding.unpack_dna4_device(dna, length)
        B, E, L = dna.shape
        aa, plens = translate.translate6_batch(
            dna.reshape(B * E, L), lengths.reshape(B * E), table)
        Rr, NF, Pp = aa.shape
        h1, h2, pvalid = tryptic_digest_device(
            aa.reshape(Rr * NF, Pp), plens.reshape(Rr * NF), mn, mx)
        F = h1.shape[-1]
        taxa, found = sharded_probe_local(
            h1, h2, pvalid, shard_rows,
            stable.max_probes, axis, default=0,
            kind=stable.kind, nb_bits=stable.nb_bits, bucket=stable.bucket,
            shard_stash=shard_stash, group=stable.group)
        hits = jnp.where(found & pvalid, taxa, 0).reshape(B, E * NF * F)
        return _agg_tail(dtax, hits, config, eu, n_ranks, axis,
                         with_overflow)

    return _finish_sharded(local_step, stable, mesh, axis, euler,
                           with_overflow)


class ShardedAnalyser:
    """Multi-chip analyse with exact k_max-overflow handling.

    Runs the fast sharded program (bounded per-read taxa capacity),
    detects overflowed reads on device, and re-runs just those reads
    through a WIDE sharded program (every hit slot its own taxon —
    exact), patching both the taxa and the psum'd frequency vector.
    Mirrors the single-chip runner's fallback
    (pipeline.runner.Analyser._resolve_overflow)."""

    def __init__(self, dtax, stable: ShardedTable, config, mesh: Mesh,
                 axis="x", tryptic: bool = False, euler=None,
                 read_length: int = 160, ends: int = 2):
        self.dtax = dtax
        self.config = config
        self.tryptic = tryptic
        self.n_ranks = int(dtax.snap_ranked.shape[0])
        maker = (make_sharded_tryptic_pipeline if tryptic
                 else make_sharded_pipeline)
        if euler is None and (config.method, config.strategy) == (
                "rmq", "lca*"):
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        self._maker = lambda cfg, ov: maker(
            dtax, stable, cfg, mesh, axis=axis, euler=euler,
            with_overflow=ov)
        self.step = self._maker(config, True)
        self._wide_step = None
        self.read_length = read_length
        self.ends = ends
        self.n_shards = stable.n_shards
        self.overflow_reads = 0

    def _exact_kmax(self) -> int:
        from ..pipeline.tryptic import MIN_PEP

        P_ = self.read_length // 3
        if self.tryptic:
            return self.ends * 6 * (P_ // MIN_PEP + 1)
        return self.ends * 6 * max((self.read_length + 2) // 3, 1)

    # wide batches are tiny; per-shard rows must divide evenly
    def _wide(self):
        if self._wide_step is None:
            cfg = self.config._replace(k_max=self._exact_kmax())
            self._wide_step = self._maker(cfg, False)
        return self._wide_step

    def run(self, dna: np.ndarray, lens: np.ndarray):
        """dna: (B, E, L) uint8 codes, B divisible by the mesh size.
        Returns (taxa (B,), freq (n_ranks,)) — exact (overflow
        re-routed), freq corrected for the re-routed reads."""
        if dna.shape[1] != self.ends or dna.shape[2] > self.read_length:
            # the wide program's exact k_max is sized from these; a
            # wider batch would silently lose the exactness guarantee
            raise ValueError(
                f"batch shape {dna.shape} exceeds the analyser's "
                f"(ends={self.ends}, read_length={self.read_length})")
        taxa, freq, over = self.step(jnp.asarray(dna), jnp.asarray(lens))
        taxa = np.array(taxa)
        freq = np.array(freq)
        over = np.asarray(over)
        idx = np.nonzero(over)[0]
        if len(idx):
            self.overflow_reads += len(idx)
            wide = self._wide()
            W = 8 * self.n_shards
            old = taxa[idx].copy()
            for s in range(0, len(idx), W):
                sel = idx[s : s + W]
                nd = dna[sel]
                nl = lens[sel]
                if len(sel) < W:
                    nd = np.pad(nd, ((0, W - len(sel)), (0, 0), (0, 0)),
                                constant_values=4)
                    nl = np.pad(nl, ((0, W - len(sel)), (0, 0)))
                out, _f = wide(jnp.asarray(nd), jnp.asarray(nl))
                taxa[idx[s : s + W]] = np.array(out)[: len(sel)]
            freq = self._fix_freq(freq, old, taxa[idx])
        return taxa, freq

    def _fix_freq(self, freq, old_taxa, new_taxa):
        return _fix_freq(self.dtax, self.n_ranks, freq, old_taxa, new_taxa)


def _fix_freq(dtax, n_ranks: int, freq, old_taxa, new_taxa):
    """Replace the overflowed reads' contributions in the rank
    frequency vector (device semantics: snap_batch(snap_ranked,
    taxon, default=0) then clip-bincount)."""
    from ..taxonomy import NONE

    sr = np.asarray(dtax.snap_ranked)
    size = len(sr)

    def hist(t):
        t = np.asarray(t)
        s = sr[np.clip(t, 0, size - 1)]
        ok = (t >= 0) & (t < size) & (s != NONE)
        r = np.where(ok, s, 0)
        return np.bincount(np.clip(r, 0, n_ranks - 1),
                           minlength=n_ranks).astype(freq.dtype)

    return freq - hist(old_taxa) + hist(new_taxa)


def make_sharded_stream_analyser(tax, stable: ShardedTable, config,
                                 mesh: Mesh, axis="x", tryptic: bool = False,
                                 batch_size: int = 16384,
                                 read_length: int = 160, ends: int = 2,
                                 dtax=None, euler=None):
    """Streaming multi-device analyser behind ``analyse --mesh``.

    The sharded counterpart of :class:`~umgap_tpu.pipeline.runner
    .Analyser`: the same order-preserving depth-bounded batch pipelining
    (the returned object IS a BatchStream), with the fused step running
    under shard_map — reads data-parallel over the mesh, the index table
    sharded (or sub-shard-grouped) over the same axis, probes routed
    all-to-all.  Overflowed reads re-run through a wide sharded program
    (exact).  This is the user-reachable form of the reference's one
    scale mechanism — the shared socket index of
    /root/reference/scripts/umgap-analyse.sh:257-264 — generalized from
    'share one RAM copy between processes' to 'shard one HBM copy over
    a mesh'.  (A factory, not a class: the runner base imports lazily so
    parallel/ stays importable without the pipeline layer.)"""
    from ..agg import device as devagg
    from ..ops import encoding
    from ..pipeline.runner import BatchStream

    dtax = dtax if dtax is not None else devagg.DeviceTaxonomy.from_host(tax)
    if euler is None and (config.method, config.strategy) == ("rmq", "lca*"):
        from ..agg.device_rmq import DeviceEuler

        euler = DeviceEuler.from_host(tax)
    maker = (make_sharded_tryptic_pipeline if tryptic
             else make_sharded_pipeline)
    n_dev = stable.n_devices
    if batch_size % n_dev:
        raise ValueError(
            f"batch size {batch_size} not divisible by the {n_dev}-device "
            "mesh")

    class _Sharded(BatchStream):
        def __init__(self):
            super().__init__(batch_size, read_length, ends)
            self.dtax = dtax
            self.config = config
            self.n_ranks = int(dtax.snap_ranked.shape[0])
            self.overflow_reads = 0
            self._wide_step = None
            self.step = self._make(config, True)

        def _make(self, cfg, with_overflow):
            return maker(dtax, stable, cfg, mesh, axis=axis, euler=euler,
                         with_overflow=with_overflow, wire="packed4",
                         length=read_length)

        def _exact_kmax(self) -> int:
            from ..pipeline.tryptic import MIN_PEP

            if tryptic:
                return ends * 6 * ((read_length // 3) // MIN_PEP + 1)
            return ends * 6 * max((read_length + 2) // 3, 1)

        def _wide(self):
            if self._wide_step is None:
                cfg = config._replace(k_max=self._exact_kmax())
                self._wide_step = self._make(cfg, False)
            return self._wide_step

        # -- BatchStream hooks ---------------------------------------- #

        def _dispatch(self, dna, lens):
            return self.step(jax.device_put(encoding.pack_dna4(dna)),
                             jax.device_put(lens))

        def _dispatch_packed(self, dna4, lens):
            return self.step(jax.device_put(dna4), jax.device_put(lens))

        def _reroute_overflow(self, taxa, idx, rows_packed, lens):
            self.overflow_reads += len(idx)
            wide = self._wide()
            # wide batches are tiny but must divide over the mesh
            W = max(n_dev, (64 // n_dev) * n_dev)
            for s in range(0, len(idx), W):
                sel = idx[s : s + W]
                nd = np.ascontiguousarray(rows_packed[sel])
                nl = np.ascontiguousarray(lens[sel])
                if len(sel) < W:
                    nd = np.pad(nd, ((0, W - len(sel)), (0, 0), (0, 0)),
                                constant_values=0x44)
                    nl = np.pad(nl, ((0, W - len(sel)), (0, 0)))
                out, _f = wide(jnp.asarray(nd), jnp.asarray(nl))
                taxa[sel] = np.array(out)[: len(sel)]
            return taxa

        def _finalize(self, handle, dna, lens, n):
            taxa = np.array(handle[0])
            over = np.asarray(handle[2])
            idx = np.nonzero(over[:n])[0]
            if len(idx):
                taxa = self._reroute_overflow(
                    taxa, idx, encoding.pack_dna4(dna), lens)
            return taxa

        def _finalize_packed(self, handle, dna4, lens, n):
            taxa = np.array(handle[0])
            over = np.asarray(handle[2])
            idx = np.nonzero(over[:n])[0]
            if len(idx):
                taxa = self._reroute_overflow(taxa, idx, dna4, lens)
            return taxa

    return _Sharded()
