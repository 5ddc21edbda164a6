"""ctypes bindings for the native host runtime (native/umgap_native.cpp).

Provides drop-in accelerated versions of the host hot loops: FASTQ/FASTA
parsing into padded device-ready batches and TSV -> packed-k-mer
splitting for index builds. Falls back to the pure-Python paths when the
shared library is missing; ``ensure_built()`` compiles it with make.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libumgap_native.so")

_lib: Optional[ctypes.CDLL] = None


def ensure_built(quiet: bool = True) -> bool:
    """Build the shared library if needed. Returns availability."""
    global _lib
    if _lib is not None:
        return True
    try:
        # make is a no-op when the .so is fresh; rebuilds stale ones
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, os.path.basename(_LIB_PATH)],
            check=True,
            capture_output=quiet,
        )
    except Exception:
        if not os.path.exists(_LIB_PATH):
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return False
    for name in ("umgap_parse_fastq", "umgap_parse_fasta"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
        ]
    lib.umgap_split_kmers.restype = ctypes.c_long
    lib.umgap_split_kmers.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
    ]
    if hasattr(lib, "umgap_insert_bucketized"):
        lib.umgap_insert_bucketized.restype = ctypes.c_longlong
        lib.umgap_insert_bucketized.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ]
    if hasattr(lib, "umgap_insert_conveyor"):
        lib.umgap_insert_conveyor.restype = ctypes.c_longlong
        lib.umgap_insert_conveyor.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ]
    if hasattr(lib, "umgap_sort_rows"):
        lib.umgap_sort_rows.restype = None
        lib.umgap_sort_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong,
        ]
    if hasattr(lib, "umgap_stream_open"):
        lib.umgap_stream_open.restype = ctypes.c_void_p
        lib.umgap_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char,
        ]
        lib.umgap_stream_next.restype = ctypes.c_longlong
        lib.umgap_stream_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.umgap_stream_close.restype = None
        lib.umgap_stream_close.argtypes = [ctypes.c_void_p]
        lib.umgap_format_output.restype = ctypes.c_longlong
        lib.umgap_format_output.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong,
        ]
    if hasattr(lib, "umgap_join_kmers"):
        lib.umgap_join_kmers.restype = ctypes.c_longlong
        lib.umgap_join_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return True


def join_kmers_native(keys: np.ndarray, snapped: np.ndarray,
                      parent: np.ndarray, ranksnap: np.ndarray,
                      factor: float = 0.95,
                      n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Native grouped joinkmers aggregation over sorted rows.

    Args:
      keys: (N,) uint64 sorted packed k-mers (duplicates = one group).
      snapped: (N,) int64 valid-ancestor-snapped taxids (< 0 = dropped).
      parent: (T,) int32 parent vector; ranksnap: (T,) int32 ranked snap.

    Returns (out_keys uint64, out_vals int32), one entry per surviving
    group, in key order.
    """
    if not available() or not hasattr(_lib, "umgap_join_kmers"):
        raise RuntimeError("native join_kmers unavailable")
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    snapped = np.ascontiguousarray(snapped, dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int32)
    ranksnap = np.ascontiguousarray(ranksnap, dtype=np.int32)
    out_keys = np.zeros(len(keys), dtype=np.uint64)
    out_vals = np.zeros(len(keys), dtype=np.int32)
    n = _lib.umgap_join_kmers(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        snapped.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ranksnap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(parent), ctypes.c_float(factor), n_threads,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_keys[:n], out_vals[:n]


def sort_rows_native(keys: np.ndarray, tids: np.ndarray) -> None:
    """In-place (key, tid) sort by key (unstable; within-key order is
    irrelevant to the grouped join)."""
    if not available() or not hasattr(_lib, "umgap_sort_rows"):
        raise RuntimeError("native sort unavailable")
    assert keys.flags["C_CONTIGUOUS"] and tids.flags["C_CONTIGUOUS"]
    _lib.umgap_sort_rows(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys))


def insert_bucketized_native(bucket0: np.ndarray, payloads, cap: int,
                             tag_distance: bool, bucket: int,
                             max_round):
    """Native bucketized placement, slot-identical to the numpy
    reference implementation (index.table._insert_bucketized).
    Returns (outs, max_probes, leftover_indices)."""
    if not available() or not hasattr(_lib, "umgap_insert_bucketized"):
        raise RuntimeError("native insert unavailable")
    from ..index.table import EMPTY

    n = len(bucket0)
    bucket0 = np.ascontiguousarray(bucket0, dtype=np.int64)
    ps = [np.ascontiguousarray(p, dtype=np.int32) for p in payloads]
    if not 1 <= len(ps) <= 3:
        raise ValueError("1-3 payload columns supported")
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(ps))]
    leftover = np.zeros(max(n, 1), dtype=np.int64)
    max_probes = ctypes.c_int(0)
    I32P = ctypes.POINTER(ctypes.c_int32)

    def p32(a):
        return a.ctypes.data_as(I32P) if a is not None else None

    pin = ps + [None] * (3 - len(ps))
    pout = outs + [None] * (3 - len(outs))
    rc = _lib.umgap_insert_bucketized(
        bucket0.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
        p32(pin[0]), p32(pin[1]), p32(pin[2]),
        cap, bucket, -1 if max_round is None else int(max_round),
        1 if tag_distance else 0,
        p32(pout[0]), p32(pout[1]), p32(pout[2]),
        leftover.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.byref(max_probes),
    )
    if rc < 0:
        raise RuntimeError("table capacity exhausted")
    return outs, int(max_probes.value), leftover[:rc]


def insert_conveyor_native(bucket0: np.ndarray, payloads, cap: int,
                           bucket: int):
    """Native conveyor placement (slot-identical to the numpy path in
    index.table._insert_conveyor). Returns (outs, max_probes,
    stash_indices)."""
    if not available() or not hasattr(_lib, "umgap_insert_conveyor"):
        raise RuntimeError("native conveyor unavailable")
    from ..index.table import EMPTY

    n = len(bucket0)
    bucket0 = np.ascontiguousarray(bucket0, dtype=np.int64)
    ps = [np.ascontiguousarray(p, dtype=np.int32) for p in payloads]
    if not 1 <= len(ps) <= 3:
        raise ValueError("1-3 payload columns supported")
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(ps))]
    leftover = np.zeros(max(n, 1), dtype=np.int64)
    max_probes = ctypes.c_int(0)
    I32P = ctypes.POINTER(ctypes.c_int32)

    def p32(a):
        return a.ctypes.data_as(I32P) if a is not None else None

    pin = ps + [None] * (3 - len(ps))
    pout = outs + [None] * (3 - len(outs))
    rc = _lib.umgap_insert_conveyor(
        bucket0.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
        p32(pin[0]), p32(pin[1]), p32(pin[2]),
        cap, bucket,
        p32(pout[0]), p32(pout[1]), p32(pout[2]),
        leftover.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.byref(max_probes),
    )
    return outs, int(max_probes.value), np.sort(leftover[:rc])


def available() -> bool:
    return _lib is not None or ensure_built()


def _parse(fn_name: str, data: bytes, max_len: int, cap_reads: int):
    """Returns (headers, codes, clipped lens, true max length). The
    native parser reports TRUE sequence lengths; codes rows are clipped
    at ``max_len`` — callers can re-parse at a wider bucket when
    ``true_max > max_len`` instead of silently truncating."""
    fn = getattr(_lib, fn_name)
    codes = np.full((cap_reads, max_len), 4, dtype=np.uint8)  # N
    lens = np.zeros(cap_reads, dtype=np.int32)
    hs = np.zeros(cap_reads, dtype=np.int64)
    he = np.zeros(cap_reads, dtype=np.int64)
    n = fn(
        data, len(data),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_len,
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        he.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        cap_reads,
    )
    if n < 0:
        raise ValueError(f"malformed input for {fn_name}")
    headers = [data[hs[i]:he[i]].decode() for i in range(n)]
    lens = lens[:n]
    true_max = int(lens.max()) if n else 0
    return headers, codes[:n], np.minimum(lens, max_len), true_max


def _parse_all(fn_name: str, data: bytes, max_len: int, cap: int):
    cap = max(cap, 16)
    while True:
        headers, codes, lens, tmax = _parse(fn_name, data, max_len, cap)
        if len(headers) < cap:
            return headers, codes, lens, tmax
        cap *= 4


def parse_fastq_file(path: str, max_len: int = 160,
                     cap_hint: int = 1 << 16):
    """Whole-file FASTQ parse -> (headers, (N, max_len) DNA codes, lengths)."""
    if not available():
        raise RuntimeError("native library unavailable")
    with open(path, "rb") as f:
        data = f.read()
    return _parse_all("umgap_parse_fastq", data, max_len, cap_hint)[:3]


def parse_fasta_file(path: str, max_len: int = 160,
                     cap_hint: int = 1 << 16):
    if not available():
        raise RuntimeError("native library unavailable")
    with open(path, "rb") as f:
        data = f.read()
    return _parse_all("umgap_parse_fasta", data, max_len, cap_hint)[:3]


# ---------------------------------------------------------------------- #
# Streaming chunked parse (constant memory over multi-GB inputs)
# ---------------------------------------------------------------------- #

def _open_stream(path: str):
    """Binary stream; gzip sniffed by magic (one implementation —
    configdir.sniff_open — serves text and binary callers)."""
    from ..configdir import sniff_open

    return sniff_open(path, "rb")


class StreamUnsupported(ValueError):
    """The input's shape defeats chunked native parsing (e.g. multi-line
    FASTQ records); callers fall back to the Python reader."""


def _fastq_cut(buf: bytes, eof: bool) -> int:
    """Byte offset of the last complete-FASTQ-record boundary.

    Valid ONLY for strict 4-line records (all real-world FASTQ; the
    readers also accept multi-line records, src/io/fastq.rs:60-77), so
    the 4-line shape is VERIFIED vectorized — every record's line 0
    must start '@' and line 2 must start '+' — and violations raise
    :class:`StreamUnsupported` rather than silently mis-cutting."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(a == 10)
    if eof:
        m = len(nl) + (1 if len(buf) and buf[-1] != 0x0A else 0)
        if m % 4:
            raise StreamUnsupported("fastq line count not a multiple of 4")
        cut = len(buf)
    else:
        m = (len(nl) // 4) * 4
        if m == 0:
            return 0
        cut = int(nl[m - 1]) + 1
    starts = np.concatenate([np.zeros(1, np.int64), nl + 1])
    if not ((a[starts[0:m:4]] == ord("@")).all()
            and (a[starts[2:m:4]] == ord("+")).all()):
        raise StreamUnsupported("fastq records are not strictly 4-line")
    return cut


def _fasta_cut(buf: bytes, eof: bool) -> int:
    """Cut before the last header line ('\\n>') so every parsed record
    is complete; 0 when the chunk holds at most one record start."""
    if eof:
        return len(buf)
    i = buf.rfind(b"\n>")
    return i + 1 if i >= 0 else 0


def stream_parse(path: str, fmt: str, max_len: int = 160,
                 chunk_bytes: int = 32 << 20,
                 width_ladder: Optional[list] = None):
    """Yield (headers, codes, lens, true_max) per chunk of a (possibly
    gzipped) FASTQ/FASTA file, holding O(chunk_bytes) on the host.

    ``lens`` are clipped to the chunk's code width; ``true_max`` is the
    widest sequence actually seen in the chunk.  With a ``width_ladder``
    (ascending widths, first >= ``max_len``), a chunk containing a
    record longer than the current width is re-parsed at the smallest
    ladder width that fits, and all later chunks use that width too —
    code widths only grow over a stream.  Records longer than the TOP
    ladder width stay clipped (true_max tells the caller to warn)."""
    if not available():
        raise RuntimeError("native library unavailable")
    fn = {"fastq": "umgap_parse_fastq", "fasta": "umgap_parse_fasta"}[fmt]
    cut = {"fastq": _fastq_cut, "fasta": _fasta_cut}[fmt]

    def n_records(buf: bytes) -> int:
        """Exact record count of a complete-records buffer, so the
        (records x width) codes allocation never overshoots — a
        byte-based guess times a grown width ladder could balloon to
        GBs per chunk."""
        if fmt == "fastq":
            nl = buf.count(b"\n")
            if buf and not buf.endswith(b"\n"):
                nl += 1
            return nl // 4
        return buf.count(b"\n>") + (1 if buf.startswith(b">") else 0)

    width = max_len
    tail = b""
    with _open_stream(path) as f:
        while True:
            data = f.read(chunk_bytes)
            eof = len(data) < chunk_bytes
            buf = tail + data if tail else data
            if not buf:
                return
            at = cut(buf, eof)
            if at == 0:  # no boundary yet: keep growing the buffer
                tail = buf
                continue
            buf, tail = buf[:at], buf[at:]
            if buf:
                cap_hint = n_records(buf) + 1
                out = _parse_all(fn, buf, width, cap_hint)
                if width_ladder and out[3] > width:
                    new_w = next((w for w in width_ladder if w >= out[3]),
                                 width_ladder[-1])
                    if new_w > width:
                        width = new_w
                        out = _parse_all(fn, buf, width, cap_hint)
                yield out
            if eof and not tail:
                return


# ---------------------------------------------------------------------- #
# Ring-buffer batch stream (GIL-free producer thread)
# ---------------------------------------------------------------------- #

class NativeBatchStream:
    """C++-threaded batch assembly: the producer parses (possibly
    gzipped) FASTQ/FASTA, encodes + 4-bit-packs reads straight into a
    ring of pre-allocated device-wire batches; ``next()`` blocks with
    the GIL RELEASED (ctypes) until a batch is ready.  Python never
    touches a record — only whole-batch numpy views and one header
    blob per batch.

    Yields (n, dna4 (n<=B, E, pw), lens (B, E), hdr_blob bytes,
    hoff int64 array, true_max).  Arrays are COPIES (the slot recycles
    on the next call; in-flight device transfers and overflow reroutes
    outlive it)."""

    def __init__(self, path1: str, path2: Optional[str], fmt: str,
                 read_length: int, batch: int, n_slots: int = 4,
                 delimiter: str = "/"):
        if not available() or not hasattr(_lib, "umgap_stream_open"):
            raise RuntimeError("native stream unavailable")
        self.ends = 2 if path2 else 1
        self.batch = batch
        self.read_length = read_length
        self.pw = (read_length + 1) // 2
        self._h = _lib.umgap_stream_open(
            path1.encode(), path2.encode() if path2 else None,
            {"fastq": 0, "fasta": 1}[fmt], read_length, batch,
            self.ends, n_slots, delimiter.encode())
        if not self._h:
            raise RuntimeError("native stream open failed")

    def next(self):
        """One batch, or None at clean EOF. Raises StreamUnsupported
        (caller falls back) or OSError."""
        dna = ctypes.POINTER(ctypes.c_ubyte)()
        lens = ctypes.POINTER(ctypes.c_int32)()
        hdr = ctypes.c_char_p()
        hoff = ctypes.POINTER(ctypes.c_longlong)()
        hlen = ctypes.c_longlong()
        tmax = ctypes.c_int()
        n = _lib.umgap_stream_next(
            self._h, ctypes.byref(dna), ctypes.byref(lens),
            ctypes.byref(hdr), ctypes.byref(hoff), ctypes.byref(hlen),
            ctypes.byref(tmax))
        if n == 0:
            return None
        if n == -2:
            raise StreamUnsupported(
                "input shape defeats the native batch stream")
        if n < 0:
            raise OSError("native stream read error")
        B, E, pw = self.batch, self.ends, self.pw
        dna4 = np.ctypeslib.as_array(dna, shape=(B, E, pw)).copy()
        ln = np.ctypeslib.as_array(lens, shape=(B, E)).copy()
        blob = ctypes.string_at(hdr, hlen.value) if hlen.value else b""
        offs = np.ctypeslib.as_array(hoff, shape=(int(n) + 1,)).astype(
            np.int64)
        return int(n), dna4, ln, blob, offs, int(tmax.value)

    def close(self):
        if self._h:
            _lib.umgap_stream_close(self._h)
            self._h = None

    def __del__(self):  # noqa: D105 — belt-and-braces cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def format_output(blob: bytes, hoff: np.ndarray,
                  taxa: np.ndarray) -> bytes:
    """(header blob, offsets, taxa) -> b'>hdr\\ntaxon\\n' per record."""
    if not available() or not hasattr(_lib, "umgap_format_output"):
        raise RuntimeError("native formatter unavailable")
    n = len(hoff) - 1
    taxa = np.ascontiguousarray(taxa, dtype=np.int32)
    hoff = np.ascontiguousarray(hoff, dtype=np.int64)
    cap = int(hoff[-1]) + n * 14
    out = ctypes.create_string_buffer(cap)
    w = _lib.umgap_format_output(
        blob, hoff.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        taxa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out, cap)
    if w > cap:
        raise RuntimeError("formatter capacity miscomputed")
    return out.raw[: int(w)]


def split_kmers_tsv(data: bytes, k: int = 9,
                    cap_hint: int = 1 << 20) -> Tuple[np.ndarray, np.ndarray]:
    """(taxid TAB protein) TSV -> (packed uint64 kmers, int32 taxids)."""
    if not available():
        raise RuntimeError("native library unavailable")
    cap = max(cap_hint, 16)
    while True:
        packed = np.zeros(cap, dtype=np.uint64)
        tids = np.zeros(cap, dtype=np.int32)
        n = _lib.umgap_split_kmers(
            data, len(data), k,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap,
        )
        if n <= cap:
            return packed[:n], tids[:n]
        cap = int(n * 1.1) + 16
