"""Run `analyse` end to end on the GPU and check what comes out.

    python chip_smoke.py            # one card: device, parity, serve
    python chip_smoke.py --multi    # four cards: analyse --mesh 4 only

Every phase drives the user entry point, ``umgap_tpu.cli.main``, in this
one process, so only one process ever holds a card. Any failure raises
and exits non-zero before the result line is printed.

device  The card's name and power limit (nvidia-smi) and JAX's platform,
        kind and device count. Fails unless JAX's platform is gpu and
        the native host runtime builds from native/*.cpp here.
parity  The 9-mer and tryptic indexes built with ``buildindex`` from
        tests/golden/data/*.tsv; all six presets through ``analyse`` on
        the committed read corpus (tests/golden/data/A{1,2}.fq), byte-
        equal to tests/golden/expected/pipeline_*.golden, which the
        independent oracle (tests/oracle/refimpl.py) produced.
serve   A 9-mer table generated from ``--seed``: the 2M planted keys of
        .bench_data plus seeded random 45-bit keys, ``--keys`` in all
        (the default fills 2^30 bucket64s slots, 8.6 GB on the card),
        saved packed and uncompressed. ``analyse --serve`` loads it once
        and answers three socket requests of the 32,768 pairs of
        .bench_data/reads.bin (high-sensitivity twice, then
        max-sensitivity). The first 1,024 records of each are byte-
        equal to the oracle's composition over exactly the table entries
        those reads can touch. Index load seconds and the step's
        memory_analysis() come from a copy the smoke loads and compiles
        itself before the server starts; the server's own figures are
        its request times, the device bytes it holds and the peak.

``--multi`` runs only this: the same table and reads through
``analyse --mesh 4`` (reads data-parallel, the table sharded over four
cards, probes routed with all_to_all) and through one-card ``analyse``,
byte-equal.

The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from typing import NamedTuple, Optional

import numpy as np

from umgap_tpu.cli import main as cli_main
from umgap_tpu.utils import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
CORPUS = os.path.join(GOLDEN, "data")
BENCH_DATA = os.path.join(REPO, ".bench_data")
WORKDIR = os.path.join(REPO, ".smoke")

PRESETS = ["max-sensitivity", "high-sensitivity", "high-precision",
           "max-precision", "tryptic-sensitivity", "tryptic-precision"]
# 2^30 bucket64s slots x 8 B at the layout's 0.5 load factor
DEFAULT_KEYS = 530_000_000
# leading pairs of each served request compared with the oracle
CHECK_PAIRS = 1024
MASK45 = (1 << 45) - 1


class SmokeFailure(Exception):
    pass


def first_difference(got: str, want: str) -> Optional[str]:
    """None when the texts are equal, else where they first differ."""
    if got == want:
        return None
    g, w = got.splitlines(), want.splitlines()
    for i, (a, b) in enumerate(zip(g, w)):
        if a != b:
            return f"line {i + 1}: got {a!r}, want {b!r}"
    return f"got {len(g)} lines, want {len(w)}"


def _require_equal(what: str, got: str, want: str) -> None:
    diff = first_difference(got, want)
    if diff is not None:
        raise SmokeFailure(f"{what} differs from the oracle: {diff}")


def _analyse(argv) -> str:
    out = io.StringIO()
    rc = cli_main(["analyse", *argv], stdin=io.StringIO(""), stdout=out)
    if rc != 0:
        raise SmokeFailure(f"analyse {' '.join(argv)} exited {rc}")
    return out.getvalue()


# ---------------------------------------------------------------------- #
# device
# ---------------------------------------------------------------------- #

def phase_device(n_cards: int) -> tuple[dict, str]:
    """Check the card and build the native runtime; returns the device
    as JAX reports it and the nvidia-smi label of the first card."""
    import jax

    devs = jax.devices()
    d = devs[0]
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(devs)}
    print(f"jax: {device}", flush=True)
    if d.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's platform is {d.platform}")
    if len(devs) < n_cards:
        raise SmokeFailure(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    cards = smi.strip().splitlines()
    for line in cards:
        print(line, flush=True)
    # always rebuild: a library copied in from another host must never load
    r = subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SmokeFailure(f"native runtime did not build: {r.stderr[-2000:]}")
    from umgap_tpu.io import native

    if not native.ensure_built():
        raise SmokeFailure("native runtime built but does not load")
    print("native runtime: built from native/*.cpp on this machine",
          flush=True)
    return device, cards[0]


# ---------------------------------------------------------------------- #
# parity
# ---------------------------------------------------------------------- #

class _BinOut(io.StringIO):
    """stdout stand-in exposing a .buffer for binary index output."""

    def __init__(self):
        super().__init__()
        self.buffer = io.BytesIO()


def run_parity(workdir: str) -> None:
    """All six presets on the committed corpus, byte-equal to the
    goldens."""
    index = {}
    for name in ("ninemer", "tryptic"):
        out = _BinOut()
        with open(os.path.join(CORPUS, name + ".tsv")) as f:
            rc = cli_main(["buildindex"], stdin=f, stdout=out)
        if rc != 0:
            raise SmokeFailure(f"buildindex {name} exited {rc}")
        index[name] = os.path.join(workdir, name + ".npz")
        with open(index[name], "wb") as f:
            f.write(out.buffer.getvalue())
    for preset in PRESETS:
        kind = "tryptic" if preset.startswith("tryptic") else "ninemer"
        got = _analyse(["-t", preset,
                        "-1", os.path.join(CORPUS, "A1.fq"),
                        "-2", os.path.join(CORPUS, "A2.fq"),
                        "--taxons", os.path.join(CORPUS, "taxonomy.tsv"),
                        "--index", index[kind]])
        golden = "pipeline_" + preset.replace("-", "_") + ".golden"
        with open(os.path.join(GOLDEN, "expected", golden)) as f:
            _require_equal(f"analyse -t {preset}", got, f.read())
        print(f"parity {preset}: byte-equal ({got.count('>')} records)",
              flush=True)


# ---------------------------------------------------------------------- #
# the at-scale world: a seeded table, its taxonomy and reads
# ---------------------------------------------------------------------- #

class KeyGen(NamedTuple):
    """``n`` seeded random 45-bit keys: key(c) = (c * a + b) mod 2^45 for
    c in [0, n), with ``a`` odd. That is a bijection of the 45-bit space,
    so the keys are distinct without a sort, and a key's counter is
    (key - b) * a^-1 mod 2^45."""

    a: int
    b: int
    n: int

    @classmethod
    def from_seed(cls, seed: int, n: int) -> "KeyGen":
        rng = np.random.default_rng(seed)
        a = int(rng.integers(1 << 40, 1 << 45)) | 1
        return cls(a, int(rng.integers(0, 1 << 45)), n)

    def keys(self, c: np.ndarray) -> np.ndarray:
        c = c.astype(np.uint64)
        return (c * np.uint64(self.a) + np.uint64(self.b)) & np.uint64(MASK45)

    def counters(self, keys: np.ndarray) -> np.ndarray:
        inv = pow(self.a, -1, 1 << 45)
        k = keys.astype(np.uint64)
        return ((k - np.uint64(self.b)) * np.uint64(inv)) & np.uint64(MASK45)


class World(NamedTuple):
    index: str        # packed .npz
    taxons: str       # taxon TSV
    reads: tuple      # (A1.fq, A2.fq)
    n_pairs: int
    planted: np.ndarray       # sorted planted keys
    planted_vals: np.ndarray
    gen: KeyGen
    random_vals: np.ndarray   # value of random key with counter c


def build_world(workdir: str, n_keys: int, seed: int,
                n_pairs: Optional[int] = None) -> World:
    """Generate the table (in the layout ``build_kmer_table`` picks),
    save it packed and uncompressed, and write the taxonomy and reads."""
    import bench
    from umgap_tpu.index.table import build_kmer_table

    with open(os.path.join(BENCH_DATA, "manifest.json")) as f:
        manifest = json.load(f)
    planted = bench.load("index_keys.bin", np.uint64)
    planted_vals = bench.load("index_vals.bin", np.int32)
    order = np.argsort(planted)
    planted, planted_vals = planted[order], planted_vals[order]
    n_tax = manifest["n_tax"]

    n_random = max(n_keys - len(planted), 0)
    gen = KeyGen.from_seed(seed, n_random)
    rng = np.random.default_rng(seed + 1)
    random_vals = rng.integers(1, n_tax + 1, size=n_random, dtype=np.int32)
    # counters whose key is a planted key stay out: those keys carry
    # their planted value
    clash = gen.counters(planted)
    clash = clash[clash < np.uint64(n_random)]
    keep = np.ones(n_random, dtype=bool)
    keep[clash.astype(np.int64)] = False
    kept = np.nonzero(keep)[0]
    del keep
    keys = np.concatenate([planted, gen.keys(kept)])
    vals = np.concatenate([planted_vals, random_vals[kept]])
    del kept

    t0 = time.perf_counter()
    table = build_kmer_table(keys, vals, k=9)
    build_s = time.perf_counter() - t0
    del keys, vals
    index = os.path.join(workdir, "table.npz")
    t0 = time.perf_counter()
    table.save(index, packed=True)
    save_s = time.perf_counter() - t0
    print(f"table: {table.n} keys in bucket{table.bucket} "
          f"({table.capacity} slots, {table.capacity * 8} B, "
          f"stash {len(table.stash_hi)}); host build {build_s:.1f} s, "
          f"save {save_s:.1f} s", flush=True)
    del table

    taxons = os.path.join(workdir, "taxons.tsv")
    bench.write_taxons_tsv(taxons, bench.load("parent.bin", np.int32),
                           bench.load("snap.bin", np.int32), n_tax)
    P, L = manifest["n_pairs"], manifest["read_len"]
    reads = bench.load("reads.bin", np.uint8).reshape(P, 2, L)
    n_pairs = P if n_pairs is None else n_pairs
    paths = (os.path.join(workdir, "A1.fq"), os.path.join(workdir, "A2.fq"))
    bench.write_fastq_pairs(paths, reads[:n_pairs])
    return World(index, taxons, paths, n_pairs, planted, planted_vals, gen,
                 random_vals)


# ---------------------------------------------------------------------- #
# the oracle over the entries the reads can touch
# ---------------------------------------------------------------------- #

def _pack_kmer(kmer: str) -> Optional[int]:
    key = 0
    for c in kmer:
        if c == "*":
            code = 26
        elif "A" <= c <= "Z":
            code = ord(c) - ord("A")
        else:
            return None  # never a stored key
        key = (key << 5) | code
    return key


def table_entries(world: World, kmers) -> dict:
    """{k-mer: taxon} for exactly those ``kmers`` the table holds: the
    planted keys by ``np.searchsorted`` on their sorted array, the
    random keys by inverting their generator."""
    packed = [(k, _pack_kmer(k)) for k in kmers]
    packed = [(k, p) for k, p in packed if p is not None]
    if not packed:
        return {}
    kmers = [k for k, _p in packed]
    q = np.array([p for _k, p in packed], dtype=np.uint64)
    pos = np.minimum(np.searchsorted(world.planted, q),
                     len(world.planted) - 1)
    is_planted = world.planted[pos] == q
    c = world.gen.counters(q)
    is_random = ~is_planted & (c < np.uint64(world.gen.n))
    out = {}
    for i in np.nonzero(is_planted)[0]:
        out[kmers[i]] = int(world.planted_vals[pos[i]])
    for i in np.nonzero(is_random)[0]:
        out[kmers[i]] = int(world.random_vals[int(c[i])])
    return out


def oracle_records(world: World, n_pairs: int, preset: str) -> str:
    """The oracle's output for the first ``n_pairs`` pairs: the
    composition tests/golden/gen.py uses for the pipeline goldens."""
    from tests.golden.gen import ninemer_pipeline
    from tests.oracle import refimpl as R

    texts = []
    for path in world.reads:
        with open(path) as f:
            texts.append("".join(f.readline() for _ in range(4 * n_pairs)))
    translated = R.translate(R.fastq2fasta(texts), all_frames=True)
    kmers = set()
    for _header, seq in R.read_fasta(translated, unwrap=True):
        prot = seq[0]
        kmers.update(prot[i:i + 9] for i in range(len(prot) - 8))
    with open(world.taxons) as f:
        tax_tsv = f.read()
    return ninemer_pipeline(translated, table_entries(world, kmers),
                            tax_tsv, preset)


def head_records(text: str, n: int) -> str:
    """The first ``n`` two-line FASTA records of ``text``."""
    return "".join(text.splitlines(keepends=True)[: 2 * n])


# ---------------------------------------------------------------------- #
# serve
# ---------------------------------------------------------------------- #

def _request(sock_path: str, line: str, timeout: float = 900) -> str:
    deadline = time.time() + 600
    while True:
        try:
            c = socket.socket(socket.AF_UNIX)
            c.connect(sock_path)
            break
        except (FileNotFoundError, ConnectionRefusedError):
            c.close()
            if time.time() > deadline:
                raise SmokeFailure("analyse --serve never came up")
            time.sleep(0.05)
    with c:
        c.settimeout(timeout)
        c.sendall((line + "\n").encode())
        c.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = c.recv(65536)
            if not b:
                return b"".join(chunks).decode()
            chunks.append(b)


def _device_memory(device) -> dict:
    return device.memory_stats() or {}


def report_step_memory(world: World, card: str, batch: int, length: int):
    """Load a copy of the table the way the server does (disk -> device),
    time it, and print memory_analysis() of the high-sensitivity step
    (the packed4 step the server's Analyser builds) at the server's batch
    geometry. The copy is freed before the server starts."""
    import jax

    from umgap_tpu.agg import device as devagg
    from umgap_tpu.cli import _load_taxonomy
    from umgap_tpu.index.table import load_table
    from umgap_tpu.ops import encoding, lookup
    from umgap_tpu.pipeline import PRESETS
    from umgap_tpu.pipeline.fused import pipeline_step

    dev = jax.devices()[0]
    before = _device_memory(dev).get("bytes_in_use", 0)
    t0 = time.perf_counter()
    dtable = lookup.DeviceTable.from_host(load_table(world.index, mmap=True))
    jax.block_until_ready(dtable.rows)
    load_s = time.perf_counter() - t0
    table_bytes = _device_memory(dev).get("bytes_in_use", 0) - before
    print(f"[{card}] index load of the smoke's own copy (disk -> device): "
          f"{load_s} s; table on device: {table_bytes} B (memory_stats "
          "bytes_in_use delta)", flush=True)

    config = PRESETS["high-sensitivity"]
    dtax = devagg.DeviceTaxonomy.from_host(_load_taxonomy(world.taxons))

    @jax.jit
    def step(dna4, lengths, dtable, dtax):
        dna = encoding.unpack_dna4_device(dna4, length)
        return pipeline_step(dna, lengths, dtax, dtable, config,
                             with_overflow=True)

    compiled = step.lower(
        jax.ShapeDtypeStruct((batch, 2, (length + 1) // 2), np.uint8),
        jax.ShapeDtypeStruct((batch, 2), np.int32), dtable, dtax).compile()
    print(f"[{card}] memory_analysis of the high-sensitivity step as the "
          f"smoke compiled it (batch {batch}, {length} bp): "
          f"{compiled.memory_analysis()}", flush=True)


def run_serve(world: World, card: str, check_pairs: int = CHECK_PAIRS,
              batch: int = 16384) -> None:
    """One `analyse --serve` process-lifetime, three requests, checked
    against the oracle."""
    import jax

    length = 100
    report_step_memory(world, card, batch, length)
    dev = jax.devices()[0]
    base = _device_memory(dev).get("bytes_in_use", 0)

    workdir = os.path.dirname(world.index)
    sock = os.path.relpath(os.path.join(workdir, "serve.sock"))
    rc_box = {}

    def serve():
        rc_box["rc"] = cli_main(
            ["analyse", "--serve", sock, "--taxons", world.taxons,
             "--index", world.index, "--read-length", str(length),
             "--batch-size", str(batch)],
            stdin=io.StringIO(""), stdout=io.StringIO())

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    outputs = []
    try:
        for i, preset in enumerate(["high-sensitivity", "high-sensitivity",
                                    "max-sensitivity"]):
            out = os.path.join(workdir, f"request{i + 1}.fa")
            t0 = time.perf_counter()
            reply = _request(sock, f"-t {preset} -1 {world.reads[0]} "
                                   f"-2 {world.reads[1]} -o {out}")
            dt = time.perf_counter() - t0
            if reply.strip() != f"ok {world.n_pairs}":
                raise SmokeFailure(f"request {i + 1} ({preset}): {reply!r}")
            print(f"[{card}] request {i + 1} ({preset}): {dt} s, "
                  f"{world.n_pairs / dt} pairs/s", flush=True)
            if i == 0:
                served = _device_memory(dev).get("bytes_in_use", 0) - base
                print(f"[{card}] device bytes held by the server after "
                      f"request 1: {served} B", flush=True)
            with open(out) as f:
                outputs.append((preset, f.read()))
    finally:
        if server.is_alive():
            _request(sock, "quit")
        server.join(timeout=120)
    if server.is_alive() or rc_box.get("rc") != 0:
        raise SmokeFailure(f"analyse --serve did not stop cleanly: {rc_box}")
    stats = _device_memory(dev)
    print(f"[{card}] peak device memory: {stats.get('peak_bytes_in_use')} B "
          f"of {stats.get('bytes_limit')} B", flush=True)

    _require_equal("request 2", outputs[1][1], outputs[0][1])
    for i in (0, 2):
        preset, text = outputs[i]
        if text.count(">") != world.n_pairs:
            raise SmokeFailure(f"request {i + 1}: {text.count('>')} records")
        t0 = time.perf_counter()
        want = oracle_records(world, check_pairs, preset)
        _require_equal(f"request {i + 1} ({preset}), first {check_pairs} "
                       "pairs", head_records(text, check_pairs), want)
        print(f"request {i + 1} ({preset}): first {check_pairs} pairs "
              f"byte-equal to the oracle (oracle {time.perf_counter() - t0:.1f}"
              " s on the host)", flush=True)


# ---------------------------------------------------------------------- #
# multi
# ---------------------------------------------------------------------- #

def run_multi(world: World, card: str, n_mesh: int = 4) -> None:
    """``analyse --mesh n`` over the world, byte-equal to one-card
    ``analyse``."""
    argv = ["-t", "high-sensitivity", "-1", world.reads[0],
            "-2", world.reads[1], "--taxons", world.taxons,
            "--index", world.index, "--read-length", "100"]
    outs = {}
    for label, extra in (("one card", []),
                         (f"--mesh {n_mesh}", ["--mesh", str(n_mesh)])):
        t0 = time.perf_counter()
        outs[label] = _analyse(argv + extra)
        print(f"[{card}] analyse {label}: {time.perf_counter() - t0} s "
              f"(table load, compile and {world.n_pairs} pairs)", flush=True)
    single, meshed = outs.values()
    if single.count(">") != world.n_pairs:
        raise SmokeFailure(f"one-card analyse gave {single.count('>')} "
                           "records")
    _require_equal(f"analyse --mesh {n_mesh} vs one card", meshed, single)
    print(f"analyse --mesh {n_mesh}: byte-equal to one-card analyse "
          f"({world.n_pairs} records)", flush=True)


# ---------------------------------------------------------------------- #

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="only analyse --mesh 4 vs one card (four GPUs)")
    p.add_argument("--keys", type=int, default=DEFAULT_KEYS,
                   help="keys in the generated table")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cache = enable_compile_cache()
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"compile cache: {cache}, {entries} entries at start", flush=True)
    n_cards = 4 if args.multi else 1
    device, card = phase_device(n_cards)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    os.makedirs(WORKDIR)
    try:
        if not args.multi:
            run_parity(WORKDIR)
        world = build_world(WORKDIR, args.keys, args.seed)
        if args.multi:
            run_multi(world, card, n_cards)
        else:
            run_serve(world, card)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
