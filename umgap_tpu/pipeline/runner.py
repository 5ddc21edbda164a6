"""Host-side streaming runner for the fused pipelines.

Reads FASTQ (paired or single), encodes into padded device batches,
runs the fused jitted pipeline, and emits the same per-read FASTA the
reference's analyse pipelines write (header stripped at the paired-end
delimiter, one consensus taxon per read).

The streaming engine (:class:`BatchStream`) keeps a bounded number of
batches in flight so host parse/encode/transfer overlaps device compute
(the runtime is asynchronous; outputs are only materialized when
popped), and holds O(batch) host memory regardless of sample size —
the analogue of the reference's record-at-a-time pipes."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..agg import device as devagg
from ..io import fasta, fastq
from ..ops import encoding, lookup
from ..taxonomy import Taxonomy
from ..utils import StageTimer, verbose
from .fused import PRESETS, PipelineConfig, make_pipeline


def encode_batch(groups: Sequence[Sequence[str]], ends: int, length: int):
    """Encode read groups into (B, E, L) codes + lengths (clipped)."""
    B = len(groups)
    dna = np.full((B, ends, length), encoding.DNA_N, dtype=np.uint8)
    lens = np.zeros((B, ends), dtype=np.int32)
    for i, group in enumerate(groups):
        for e, seq in enumerate(group[:ends]):
            codes = encoding.encode_dna(seq)[:length]
            dna[i, e, : len(codes)] = codes
            lens[i, e] = len(codes)
    return dna, lens


def read_groups_fastq(paths: Sequence[str], delimiter: str = "/"):
    """Yield (header, [sequences…]) groups from paired FASTQ files,
    header stripped at the delimiter (uniq -d semantics). Gzipped
    inputs are detected by magic bytes (umgap-analyse.sh:159-175)."""
    from ..configdir import sniff_open

    handles = [sniff_open(p) for p in paths]
    try:
        readers = [fastq.read_records(h) for h in handles]
        for group in fastq.interleave(readers):
            header = group[0].header
            idx = header.find(delimiter)
            if idx != -1:
                header = header[:idx]
            yield header, [rec.sequence for rec in group]
    finally:
        for h in handles:
            h.close()


class BatchStream:
    """Order-preserving streaming batcher with depth-bounded pipelining.

    Subclasses provide ``_dispatch(dna, lens)`` (launch one padded
    (B, E, L) batch asynchronously, return an opaque handle) and
    ``_finalize(handle, dna, lens, n)`` (materialize the handle into a
    per-read result array of length >= n).

    ``feed`` accepts pre-encoded chunks of ANY size and yields results
    as they complete; ``finish`` drains the tail.  At most
    ``depth + 1`` batches are held on the host at any time.

    depth tuning (measured on-chip, 131k-pair samples): depth 3 is
    within noise of 2 (105k vs 110k pairs/s); a background parse
    PREFETCH THREAD loses ~35% to GIL/CPU contention with the dispatch
    path on a 2-core host.  The remaining CLI-vs-fused gap is the
    per-sample ramp/drain and the unoverlappable first-chunk parse —
    both amortize with sample size."""

    depth = 2

    def __init__(self, batch_size: int, read_length: int, ends: int):
        self.batch_size = batch_size
        self.read_length = read_length
        self.ends = ends
        self.timer = StageTimer()
        self._pend: List[Tuple[List[str], np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._inflight: List = []

    # -- subclass hooks -------------------------------------------------- #

    def _dispatch(self, dna: np.ndarray, lens: np.ndarray):
        raise NotImplementedError

    def _finalize(self, handle, dna, lens, n) -> np.ndarray:
        raise NotImplementedError

    # -- pre-packed fast path (native ring stream) ----------------------- #
    # The C++ producer thread delivers batches already in the 4-bit
    # device wire format, so the host loop is just dispatch + drain:
    # no per-record Python, no numpy pack.

    def _dispatch_packed(self, dna4: np.ndarray, lens: np.ndarray):
        raise NotImplementedError

    def _finalize_packed(self, handle, dna4, lens, n) -> np.ndarray:
        raise NotImplementedError

    def feed_packed(self, headers, dna4: np.ndarray, lens: np.ndarray,
                    n: int):
        """Queue ONE pre-packed batch (rows beyond ``n`` are padding).
        ``headers`` may be any token carried through to the output side
        (the CLI passes a (blob, offsets) pair for native formatting).
        Yields completed (headers, taxa[:n]) batches."""
        with self.timer.stage("dispatch"):
            handle = self._dispatch_packed(dna4, lens)
        self._inflight.append((headers, dna4, lens, n, handle, True))
        while len(self._inflight) > self.depth:
            yield self._emit_batch(self._inflight.pop(0))

    # -- streaming ------------------------------------------------------- #

    def _norm(self, dna: np.ndarray, lens: np.ndarray):
        """Pad a chunk narrower than read_length up to it (widths only
        grow via the CLI's ladder; wider chunks are a caller bug)."""
        L = self.read_length
        if dna.shape[-1] > L:
            raise ValueError(
                f"chunk width {dna.shape[-1]} exceeds read_length {L}")
        if dna.shape[-1] < L:
            dna = np.pad(dna, ((0, 0), (0, 0), (0, L - dna.shape[-1])),
                         constant_values=encoding.DNA_N)
        return dna, np.minimum(lens, L)

    def _emit_batch(self, item):
        headers, dna, lens, n, handle, packed = item
        if packed:
            taxa = self._finalize_packed(handle, dna, lens, n)
        else:
            taxa = self._finalize(handle, dna, lens, n)
        return headers, taxa[:n]

    def _emit(self, item):
        headers, taxa = self._emit_batch(item)
        for h, t in zip(headers, taxa):
            yield h, int(t)

    def _launch(self, headers, dna, lens):
        n = len(headers)
        B = self.batch_size
        if n < B:
            dna = np.pad(dna, ((0, B - n), (0, 0), (0, 0)),
                         constant_values=encoding.DNA_N)
            lens = np.pad(lens, ((0, B - n), (0, 0)))
        with self.timer.stage("dispatch"):
            handle = self._dispatch(dna, lens)
        self._inflight.append((headers, dna, lens, n, handle, False))

    def _take_batch(self):
        """Pop exactly batch_size rows off the pending blocks."""
        B = self.batch_size
        hs: List[str] = []
        ds: List[np.ndarray] = []
        ls: List[np.ndarray] = []
        need = B
        while need:
            bh, bd, bl = self._pend[0]
            if len(bh) <= need:
                self._pend.pop(0)
                hs.extend(bh)
                ds.append(bd)
                ls.append(bl)
                need -= len(bh)
            else:
                hs.extend(bh[:need])
                ds.append(bd[:need])
                ls.append(bl[:need])
                self._pend[0] = (bh[need:], bd[need:], bl[need:])
                need = 0
        self._pend_n -= B
        return (hs, np.concatenate(ds) if len(ds) > 1 else ds[0],
                np.concatenate(ls) if len(ls) > 1 else ls[0])

    def reset(self):
        """Drop all pending/in-flight work (used when a caller falls
        back to a different ingest path and restarts the sample)."""
        self._pend, self._pend_n, self._inflight = [], 0, []

    def feed_batches(self, headers: List[str], dna: np.ndarray,
                     lens: np.ndarray):
        """Queue one chunk; yields completed (headers, taxa-array)
        batches — the zero-per-record-overhead form (the CLI writes
        these in one join; ``feed`` is the per-record convenience)."""
        if len(headers):
            dna, lens = self._norm(np.asarray(dna), np.asarray(lens))
            self._pend.append((list(headers), dna, lens))
            self._pend_n += len(headers)
        while self._pend_n >= self.batch_size:
            self._launch(*self._take_batch())
            while len(self._inflight) > self.depth:
                yield self._emit_batch(self._inflight.pop(0))

    def feed(self, headers: List[str], dna: np.ndarray, lens: np.ndarray):
        """Queue one chunk; yields any (header, taxon) that completed."""
        for hs, ts in self.feed_batches(headers, dna, lens):
            for h, t in zip(hs, ts):
                yield h, int(t)

    def finish_batches(self):
        """Flush the partial tail batch and drain everything in flight,
        as (headers, taxa-array) batches."""
        if self._pend_n:
            hs, ds, ls = [], [], []
            for bh, bd, bl in self._pend:
                hs.extend(bh)
                ds.append(bd)
                ls.append(bl)
            self._pend, self._pend_n = [], 0
            self._launch(hs, np.concatenate(ds) if len(ds) > 1 else ds[0],
                         np.concatenate(ls) if len(ls) > 1 else ls[0])
        while self._inflight:
            yield self._emit_batch(self._inflight.pop(0))
        verbose("stream timings:\n" + self.timer.report())

    def finish(self):
        """Flush the partial tail batch and drain everything in flight."""
        for hs, ts in self.finish_batches():
            for h, t in zip(hs, ts):
                yield h, int(t)

    def analyse_groups(self, groups):
        """groups: iterable of (header, [seq…]). Yields (header, taxon)."""
        buf_headers: List[str] = []
        buf_seqs: List[Sequence[str]] = []
        for header, seqs in groups:
            buf_headers.append(header)
            buf_seqs.append(seqs)
            if len(buf_headers) == self.batch_size:
                dna, lens = encode_batch(buf_seqs, self.ends,
                                         self.read_length)
                yield from self.feed(buf_headers, dna, lens)
                buf_headers, buf_seqs = [], []
        if buf_headers:
            dna, lens = encode_batch(buf_seqs, self.ends, self.read_length)
            yield from self.feed(buf_headers, dna, lens)
        yield from self.finish()


class Analyser(BatchStream):
    """Holds device-resident state (taxonomy + index) across samples —
    the analogue of the reference's socket index service
    (/root/reference/src/commands/prot2kmer2lca.rs:116-137), except the
    'service' is just arrays living in HBM.  Pass prebuilt ``dtax`` /
    ``dtable`` to share device state across analysers (the CLI caches
    one Analyser per (preset, batch, length) and shares the arrays)."""

    def __init__(self, tax: Taxonomy, table, config: PipelineConfig,
                 batch_size: int = 1024, read_length: int = 160,
                 ends: int = 2, dtax=None, dtable=None, euler=None):
        super().__init__(batch_size, read_length, ends)
        self.config = config
        with self.timer.stage("device_state_load"):
            self.dtax = dtax if dtax is not None else \
                devagg.DeviceTaxonomy.from_host(tax)
            self.dtable = dtable if dtable is not None else \
                lookup.DeviceTable.from_host(table)
            self._euler = euler
            if euler is None and (config.method, config.strategy) == (
                    "rmq", "lca*"):
                from ..agg.device_rmq import DeviceEuler

                self._euler = DeviceEuler.from_host(tax)
        self.step = self._make_step(config, with_overflow=True)
        self._wide_step = None  # built lazily on first k_max overflow
        self.overflow_reads = 0
        verbose(f"{type(self).__name__} ready: preset={config.name} "
                f"batch={batch_size} ends={ends}")

    # -- pipeline builders (overridden by TrypticAnalyser) --------------- #

    def _make_step(self, config: PipelineConfig, with_overflow: bool):
        return make_pipeline(self.dtax, self.dtable, config, self._euler,
                             wire="packed4", with_overflow=with_overflow)

    def _exact_kmax(self) -> int:
        # >= hit slots (windows per frame) for any padded protein length
        return self.ends * 6 * max((self.read_length + 2) // 3, 1)

    # -- k_max overflow fallback ---------------------------------------- #
    # config.k_max bounds the per-read distinct-taxa capacity of the fast
    # program (aggregation scales O(k_max^2)). Reads that exceed it are
    # rare; they are re-run through a program wide enough to be exact
    # (every window slot its own taxon), in small fixed batches.
    WIDE_BATCH = 64

    @property
    def _wide_batch(self) -> int:
        # Bound the wide program's (B, K, K) aggregation tensors to
        # ~1 GB of f32 regardless of the read-length bucket.
        exact = self._exact_kmax()
        return max(1, min(self.WIDE_BATCH,
                          (1 << 28) // max(exact * exact, 1)))

    def _wide(self):
        if self._wide_step is None:
            cfg = self.config._replace(k_max=self._exact_kmax())
            self._wide_step = self._make_step(cfg, with_overflow=False)
        return self._wide_step

    def _resolve_overflow(self, dna: np.ndarray, lens: np.ndarray,
                          taxa: np.ndarray, overflow: np.ndarray):
        """Re-run overflowed rows of one batch through the wide program
        and patch their results in place. dna: (B, E, L) uint8 codes."""
        idx = np.nonzero(overflow)[0]
        if not len(idx):
            return taxa
        self.overflow_reads += len(idx)
        wide = self._wide()
        W = self._wide_batch
        for s in range(0, len(idx), W):
            sel = idx[s : s + W]
            nd = np.ascontiguousarray(dna[sel])
            nl = np.ascontiguousarray(lens[sel])
            if len(sel) < W:
                nd = np.pad(nd, ((0, W - len(sel)), (0, 0), (0, 0)),
                            constant_values=encoding.DNA_N)
                nl = np.pad(nl, ((0, W - len(sel)), (0, 0)))
            out = np.asarray(self._wide_call(wide, nd, nl))
            taxa[sel] = out[: len(sel)]
        return taxa

    def _wide_call(self, wide, nd, nl):
        return wide(encoding.pack_dna4(nd), nl, self.read_length)

    # -- BatchStream hooks ----------------------------------------------- #

    def _dispatch(self, dna, lens):
        import jax

        # 4-bit packed wire + async H2D so the halved transfer overlaps
        # the previous batch's device compute
        return self.step(jax.device_put(encoding.pack_dna4(dna)),
                         jax.device_put(lens), self.read_length)

    def _finalize(self, handle, dna, lens, n):
        with self.timer.stage("materialize"):
            taxa = np.array(handle[0])
            overflow = np.asarray(handle[1])
        if overflow[:n].any():
            with self.timer.stage("overflow_fallback"):
                taxa = self._resolve_overflow(dna, lens, taxa, overflow)
        return taxa

    def _dispatch_packed(self, dna4, lens):
        import jax

        return self.step(jax.device_put(dna4), jax.device_put(lens),
                         self.read_length)

    def _finalize_packed(self, handle, dna4, lens, n):
        with self.timer.stage("materialize"):
            taxa = np.array(handle[0])
            overflow = np.asarray(handle[1])
        overflow = overflow.copy()
        overflow[n:] = False
        idx = np.nonzero(overflow)[0]
        if len(idx):
            with self.timer.stage("overflow_fallback"):
                # packing is per-row, so packed row slices feed the wide
                # program directly; pad rows are two N codes = 0x44
                self.overflow_reads += len(idx)
                wide = self._wide()
                W = self._wide_batch
                for s in range(0, len(idx), W):
                    sel = idx[s : s + W]
                    nd = np.ascontiguousarray(dna4[sel])
                    nl = np.ascontiguousarray(lens[sel])
                    if len(sel) < W:
                        nd = np.pad(nd, ((0, W - len(sel)), (0, 0), (0, 0)),
                                    constant_values=0x44)
                        nl = np.pad(nl, ((0, W - len(sel)), (0, 0)))
                    out = np.asarray(wide(nd, nl, self.read_length))
                    taxa[sel] = out[: len(sel)]
        return taxa

    # -- convenience entry points ---------------------------------------- #

    def analyse_arrays(self, headers, dna: np.ndarray, lens: np.ndarray,
                       depth: int = 2):
        """Pre-encoded groups: dna (N, E, L), lens (N, E)."""
        self.depth = depth
        yield from self.feed(list(headers), dna, lens)
        yield from self.finish()


def analyse_paired(fastq1: str, fastq2: str, tax: Taxonomy, table,
                   preset: str = "high-sensitivity", out=None,
                   batch_size: int = 256, read_length: int = 160,
                   use_native: bool = True):
    """Run a preset pipeline over a paired-end sample, writing per-read
    FASTA records (header, consensus taxon). Uses the native C++ parser
    when available (whole-file parse straight into padded code arrays)."""
    config = PRESETS[preset] if isinstance(preset, str) else preset
    analyser = Analyser(tax, table, config, batch_size, read_length, ends=2)
    results = None
    # Fall back to the Python parser only for EXPECTED conditions (the
    # toolchain is unavailable). Real parser bugs must fail loudly, not
    # silently degrade into a 10x slower path.
    native_ok = False
    if use_native:
        from ..io import native

        try:
            native_ok = native.ensure_built()
        except (OSError, RuntimeError):
            native_ok = False
    if native_ok:
        from ..io.native import StreamUnsupported

        try:
            results = []
            for headers, dna, lens, _t in stream_paired_chunks(
                    fastq1, fastq2, read_length):
                results.extend(analyser.feed(headers, dna, lens))
            results.extend(analyser.finish())
        except StreamUnsupported:
            # exotic record shape (e.g. multi-line FASTQ): redo the
            # sample through the Python reader
            analyser.reset()
            results = None
    if results is None:
        groups = read_groups_fastq([fastq1, fastq2])
        results = list(analyser.analyse_groups(groups))
    if out is not None:
        writer = fasta.Writer(out, "\n", False)
        for h, t in results:
            writer.write_record(fasta.Record(h, [str(t)]))
    return results


def _pad_width(codes: np.ndarray, w: int) -> np.ndarray:
    if codes.shape[-1] >= w:
        return codes
    pad = [(0, 0)] * (codes.ndim - 1) + [(0, w - codes.shape[-1])]
    return np.pad(codes, pad, constant_values=encoding.DNA_N)


def stream_paired_chunks(fastq1: str, fastq2: str, read_length: int,
                         delimiter: str = "/", chunk_bytes: int = 32 << 20,
                         width_ladder=None):
    """Aligned paired-end chunks from two FASTQ files via the native
    streaming parser: yields (headers, dna (n, 2, L), lens (n, 2),
    true_max).  Stops at the shorter file (utils::Zip semantics);
    headers come from file 1, stripped at ``delimiter``.  L grows along
    ``width_ladder`` when longer reads appear (never shrinks)."""
    from ..io import native

    streams = [
        native.stream_parse(p, "fastq", read_length, chunk_bytes,
                            width_ladder=width_ladder)
        for p in (fastq1, fastq2)
    ]
    bufs: List[List] = [[], []]  # per-file queues of (headers, codes, lens)
    counts = [0, 0]
    done = [False, False]

    def pull(i) -> bool:
        try:
            h, c, l, tmax = next(streams[i])
        except StopIteration:
            done[i] = True
            return False
        bufs[i].append((h, c, l, tmax))
        counts[i] += len(h)
        return True

    def take(i, n):
        hs: List[str] = []
        cs = []
        ls = []
        tmax = 0
        while n:
            bh, bc, bl, bt = bufs[i][0]
            tmax = max(tmax, bt)
            if len(bh) <= n:
                bufs[i].pop(0)
                hs.extend(bh)
                cs.append(bc)
                ls.append(bl)
                n -= len(bh)
            else:
                hs.extend(bh[:n])
                cs.append(bc[:n])
                ls.append(bl[:n])
                bufs[i][0] = (bh[n:], bc[n:], bl[n:], bt)
                n = 0
        counts[i] -= len(hs)
        w = max(c.shape[-1] for c in cs)
        cs = [_pad_width(c, w) for c in cs]
        return (hs, np.concatenate(cs) if len(cs) > 1 else cs[0],
                np.concatenate(ls) if len(ls) > 1 else ls[0], tmax)

    while True:
        while counts[0] == 0 and not done[0]:
            pull(0)
        while counts[1] == 0 and not done[1]:
            pull(1)
        n = min(counts[0], counts[1])
        if n == 0:
            return  # one side exhausted: Zip stops at the shortest
        h1, c1, l1, t1 = take(0, n)
        _h2, c2, l2, t2 = take(1, n)
        headers = []
        for h in h1:
            idx = h.find(delimiter)
            headers.append(h[:idx] if idx != -1 else h)
        w = max(c1.shape[-1], c2.shape[-1])
        dna = np.stack([_pad_width(c1, w), _pad_width(c2, w)], axis=1)
        lens = np.stack([np.minimum(l1, w), np.minimum(l2, w)], axis=1)
        yield headers, dna, lens, max(t1, t2)


def stream_single_chunks(path: str, read_length: int, fmt: str = "fasta",
                         delimiter: str = "/", chunk_bytes: int = 32 << 20,
                         width_ladder=None):
    """Single-end chunks: yields (headers, dna (n, 1, L), lens (n, 1),
    true_max) via the native streaming parser."""
    from ..io import native

    for h, c, l, tmax in native.stream_parse(
            path, fmt, read_length, chunk_bytes, width_ladder=width_ladder):
        headers = []
        for hd in h:
            idx = hd.find(delimiter)
            headers.append(hd[:idx] if idx != -1 else hd)
        yield headers, c[:, None, :], l[:, None], tmax


def analyse_stream(groups, tax: Taxonomy, table,
                   preset: str = "high-sensitivity", ends: int = 2,
                   batch_size: int = 256, read_length: int = 160):
    config = PRESETS[preset] if isinstance(preset, str) else preset
    analyser = Analyser(tax, table, config, batch_size, read_length, ends)
    return list(analyser.analyse_groups(groups))
