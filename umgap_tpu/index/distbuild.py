"""Distributed multi-process index-build job.

The runnable analogue of the reference's cluster build job
(/root/reference/scripts/build-index-phanpy.hpc.sh:1-10, a PBS job
running ``splitkmers | sort | joinkmers | buildindex`` over the UniProt
TSV).  Here the job is a supervisor + worker subprocesses over a shared
work directory, every task checkpointed with atomic ``.done`` markers so
a killed worker — or a killed driver — resumes exactly where it stopped:

  1. **partition** (per input chunk, parallel): rows -> packed
     (u64 k-mer, i32 taxid) spills, hash-range partitioned with the
     SAME ``owner_of`` as the serving-time sharded tables
     (parallel/sharded.py), so built shards drop straight into
     ``ShardedTable.from_shards``.
  2. **join** (per shard, parallel): concat spills -> sort ->
     joinkmers aggregation (valid-ancestor snap, tree-hybrid f=0.95,
     ranked snap; native multithreaded C++ when available).
  3. **build** (per shard, parallel): packed KmerTable at one common
     capacity (rectangular across shards) -> ``shards/shard_*.npz``.

Workers are plain subprocesses re-invoking the CLI with ``--task``;
the supervisor survives worker crashes (it records the failure, keeps
other workers running, and a re-run with the same workdir finishes the
remaining tasks).
"""

from __future__ import annotations

import glob
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

# At-scale shards default to bucket64s: 64-slot buckets resolved by ONE
# full-tile (512 B) row gather — measured 4x the probe rate of 2-round
# bucket16 at multi-GB tables (PERF.md round 4) at the same 8 B/slot.
# Sized at load <= 0.5 so the single round's overflow stays within the
# stash.  bucket64d is the DENSE variant of the same row shape:
# conveyor placement (distance <= 1, tags 0/1) lifts the load ceiling
# to ~0.9, fitting ~1.76x the keys in the same artifact bytes
# (~9.2 B/key realized vs 16.3 at 0.49 load — denser than the
# reference's ~10 B/key FST, README.md:54-57) at a 2-round probe,
# which gathers twice the bytes per query of bucket64s (tuned on an
# earlier accelerator, not yet measured on this card).  bucket16
# (conveyor-placed, <= 2 gathers, load
# <= 0.9 ceiling) remains for memory-lean builds; bucket8s (the
# cache-regime layout) needs its stash to absorb all bucket overflow,
# capping realized load around 0.1 at 10M+ keys/shard.  --layout
# selects per build.
class ShardArtifactError(ValueError):
    """A shard artifact is unreadable (truncated/corrupt) — ValueError
    so the CLI prints the remedy instead of a traceback."""


LOAD_FACTORS = {"bucket64s": 0.50, "bucket64d": 0.88,
                "bucket16": 0.60, "bucket8s": 0.60}
BUCKETS = {"bucket64s": 64, "bucket64d": 64, "bucket16": 16, "bucket8s": 8}
PROBE_LIMITS = {"bucket64s": 0, "bucket64d": 1, "bucket16": 1, "bucket8s": 0}
LOAD_FACTOR = 0.60
LAYOUT = "bucket64s"


def _done(path: str) -> str:
    return path + ".done"


def _mark(path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("ok")
    os.replace(tmp, _done(path))


def _is_done(path: str) -> bool:
    return os.path.exists(_done(path))


def _save_atomic(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# Input descriptions
# ---------------------------------------------------------------------- #

def tsv_chunks(path: str, chunk_bytes: int = 256 << 20) -> List[Tuple[int, int]]:
    """Byte ranges covering the TSV; workers align to newlines (a worker
    starts after the first newline past ``start`` unless start==0, and
    finishes the line spanning ``end``)."""
    size = os.path.getsize(path)
    return [(s, min(s + chunk_bytes, size))
            for s in range(0, size, chunk_bytes)]


def read_tsv_chunk(path: str, start: int, end: int, k: int):
    """Parse one newline-aligned chunk into packed rows (native)."""
    from ..io import native

    with open(path, "rb") as f:
        if start:
            f.seek(start - 1)
            f.readline()  # consume the partial first line
            start = f.tell()
        if start >= end:
            # a single line spanned the whole range: the chunk owning
            # the line's start parses it; this one contributes nothing
            return np.zeros(0, np.uint64), np.zeros(0, np.int32)
        data = f.read(end - start)
        if not data.endswith(b"\n"):
            data += f.readline()
    return native.split_kmers_tsv(data, k=k)


def synthetic_chunk(seed: int, chunk: int, rows: int, n_tax: int):
    """Deterministic synthetic rows (bench / driver-scale tests):
    ~70% singleton groups, duplicated hot taxa — the group structure of
    real UniProt-derived corpora (scripts/bench_index_build.py)."""
    rng = np.random.default_rng([seed, chunk])
    n_base = int(rows / 1.6)
    keys = rng.integers(0, 2 ** 45, size=n_base, dtype=np.uint64)
    extra_mask = rng.random(n_base) < 0.3
    extra_counts = rng.integers(1, 8, size=int(extra_mask.sum()))
    packed = np.concatenate([keys, np.repeat(keys[extra_mask], extra_counts)])
    tids = rng.integers(1, n_tax + 1, size=len(packed)).astype(np.int32)
    hot = rng.random(len(packed)) < 0.5
    tids[hot] = rng.integers(1, min(2000, n_tax), size=int(hot.sum()))
    return packed, tids


def write_synthetic_taxonomy(path: str, n_tax: int, seed: int) -> None:
    """Random NCBI-shaped taxonomy TSV shared by all workers."""
    from .. import ranks

    rng = np.random.default_rng([seed, 999])
    parent = np.ones(n_tax + 1, dtype=np.int64)
    parent[2:] = (rng.random(n_tax - 1)
                  * (np.arange(2, n_tax + 1) - 1)).astype(np.int64) + 1
    rk = rng.integers(0, ranks.RANK_COUNT, size=n_tax + 1)
    vd = rng.random(n_tax + 1) > 0.1
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("1\troot\tno rank\t1\t\x01\n")
        for i in range(2, n_tax + 1):
            valid = "\x01" if vd[i] else "\x00"
            f.write(f"{i}\tt{i}\t{ranks.rank_name(int(rk[i]))}"
                    f"\t{int(parent[i])}\t{valid}\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# Worker tasks
# ---------------------------------------------------------------------- #

def _punch_hole(path: str, start: int, length: int) -> bool:
    """Best-effort FALLOC_FL_PUNCH_HOLE: frees the byte range's blocks
    while keeping file size/offsets (so the manifest's chunk ranges stay
    valid for resume).  Returns False where unsupported (non-Linux, or a
    filesystem without hole support) — reclaim is then simply skipped."""
    if length <= 0 or not hasattr(ctypes, "CDLL"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        fd = os.open(path, os.O_RDWR)
        try:
            # PUNCH_HOLE (0x2) requires KEEP_SIZE (0x1)
            rc = libc.fallocate(fd, ctypes.c_int(0x3),
                                ctypes.c_longlong(start),
                                ctypes.c_longlong(length))
        finally:
            os.close(fd)
        return rc == 0
    except (OSError, AttributeError):
        return False


# Punch guard: a chunk's parse reads up to one line past each manifest
# boundary (read_tsv_chunk newline alignment), so reclaiming a finished
# chunk must leave its edge bytes for the neighbours.  1 MB dwarfs any
# plausible line length.
_PUNCH_MARGIN = 1 << 20


def task_partition(workdir: str, manifest: dict, chunk: int) -> None:
    from ..parallel.sharded import owner_of
    from ..ops import kmers as kmerops

    part = os.path.join(workdir, "part")
    stamp = os.path.join(part, f"c{chunk:05d}")
    if _is_done(stamp):
        return
    n_shards = manifest["n_shards"]
    if manifest["input"] == "synthetic":
        rows = min(manifest["rows_per_chunk"],
                   manifest["total_rows"]
                   - chunk * manifest["rows_per_chunk"])
        packed, tids = synthetic_chunk(
            manifest["seed"], chunk, rows, manifest["n_tax"])
    else:
        start, end = manifest["chunks"][chunk]
        packed, tids = read_tsv_chunk(manifest["tsv"], start, end,
                                      manifest["k"])
    hi, lo = kmerops.split_packed(packed.astype(np.uint64))
    owner = owner_of(hi, lo, n_shards)
    order = np.argsort(owner, kind="stable")
    packed = packed[order]
    tids = tids[order]
    owner = owner[order]
    bounds = np.searchsorted(owner, np.arange(n_shards + 1))
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        if a == b:
            continue
        _save_atomic(os.path.join(part, f"c{chunk:05d}_s{s:03d}.npz"),
                     keys=packed[a:b], tids=tids[a:b])
    _mark(stamp)
    if manifest.get("reclaim_input") and manifest["input"] == "tsv":
        # the input is declared scratch: free this chunk's bytes so the
        # TSV's disk shrinks as partitioning advances (peak disk at
        # 10^10-row scale is TSV + all spills, right here)
        start, end = manifest["chunks"][chunk]
        _punch_hole(manifest["tsv"], start + _PUNCH_MARGIN,
                    (end - _PUNCH_MARGIN) - (start + _PUNCH_MARGIN))


def task_join(workdir: str, manifest: dict, shard: int,
              n_threads: int = 1, tax=None) -> None:
    from ..taxonomy import read_taxa_file, Taxonomy
    from .scale import join_kmers_sorted

    joined = os.path.join(workdir, "joined")
    stamp = os.path.join(joined, f"s{shard:03d}")
    if _is_done(stamp):
        return
    parts = sorted(glob.glob(
        os.path.join(workdir, "part", f"c*_s{shard:03d}.npz")))
    part_files = list(parts)
    keys: List[np.ndarray] = []
    tids: List[np.ndarray] = []
    for p in parts:
        z = np.load(p)
        keys.append(z["keys"])
        tids.append(z["tids"])
    if keys:
        packed = np.concatenate(keys)
        tid = np.concatenate(tids).astype(np.int64)
    else:
        packed = np.zeros(0, np.uint64)
        tid = np.zeros(0, np.int64)
    # sort rows by key (grouping only needs adjacency; within-key order
    # is irrelevant to the aggregation, so the faster unstable native
    # pair sort is exact)
    try:
        from ..io.native import sort_rows_native

        packed = np.ascontiguousarray(packed)
        tid = np.ascontiguousarray(tid)
        sort_rows_native(packed, tid)
    except (RuntimeError, OSError):
        order = np.argsort(packed, kind="stable")
        packed = packed[order]
        tid = tid[order]
    if tax is None:
        tax = Taxonomy(read_taxa_file(manifest["taxons"]))
    out_keys, out_vals = join_kmers_sorted(packed, tid, tax,
                                           n_threads=n_threads)
    _save_atomic(os.path.join(joined, f"s{shard:03d}.npz"),
                 keys=out_keys, values=out_vals)
    # key count sideband: final accounting must not re-load (or depend
    # on the continued existence of) the joined arrays
    with open(stamp + ".count.tmp", "w") as f:
        f.write(str(len(out_keys)))
    os.replace(stamp + ".count.tmp", stamp + ".count")
    _mark(stamp)
    if manifest.get("reclaim"):
        # disk-bounded mode: the spills for this shard are consumed and
        # no later stage reads them
        for p in part_files:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def common_capacity(workdir: str, manifest: dict) -> int:
    """Post-join barrier: one capacity so shard rows stack rectangular
    (parallel/sharded.ShardedTable.from_shards).

    bucket8s resolves every probe with ONE row gather, so keys past a
    full home bucket must fit the 256-slot stash.  The exact overflow
    for a candidate capacity is ``sum(max(0, bucket_count - 8))`` — we
    size it on the LARGEST shard's real bucket histogram (shards are
    hash-balanced, so the others match statistically) and keep a margin
    of half the stash."""
    from .table import MIN_NB_BITS, _pow2_capacity, mix_key
    from ..ops import kmers as kmerops

    cap_path = os.path.join(workdir, "capacity.json")
    if os.path.exists(cap_path):
        with open(cap_path) as f:
            return json.load(f)["capacity"]
    max_n, max_s = 1, 0
    for s in range(manifest["n_shards"]):
        n = _shard_key_count(workdir, s)
        if n > max_n:
            max_n, max_s = n, s
    bucket = BUCKETS.get(manifest["layout"], 16)
    load = LOAD_FACTORS.get(manifest["layout"], LOAD_FACTOR)
    cap = _pow2_capacity(max_n, load, bucket << MIN_NB_BITS)
    joined_path = os.path.join(workdir, "joined", f"s{max_s:03d}.npz")
    if manifest["layout"] == "bucket8s" and os.path.exists(joined_path):
        # bucket8s pre-sizes from the largest shard's real bucket
        # histogram (single-round, no conveyor); skipped when the
        # joined arrays were reclaimed (the build backstop still
        # doubles on stash overflow)
        z = np.load(joined_path)
        keys = z["keys"].astype(np.uint64)
        if len(keys):
            hi, lo = kmerops.split_packed(keys)
            _mhi, mlo = mix_key(hi, lo)
            while True:
                nb = max(cap // 8, 1)
                cnt = np.bincount(
                    (mlo & np.uint32(nb - 1)).astype(np.int64),
                    minlength=nb)
                if int(np.maximum(cnt - 8, 0).sum()) <= 128:
                    break
                cap *= 2
    with open(cap_path + ".tmp", "w") as f:
        json.dump({"capacity": cap, "max_keys": max_n}, f)
    os.replace(cap_path + ".tmp", cap_path)
    return cap


def _shard_key_count(workdir: str, shard: int) -> int:
    """Key count of one joined shard, via the sideband written at join
    time (survives --reclaim deletion of the arrays themselves)."""
    cpath = os.path.join(workdir, "joined", f"s{shard:03d}.count")
    if os.path.exists(cpath):
        with open(cpath) as f:
            return int(f.read().strip())
    z = np.load(os.path.join(workdir, "joined", f"s{shard:03d}.npz"))
    return len(z["keys"])


def bump_capacity(workdir: str) -> int:
    """Backstop for a shard whose stash still overflowed at the sized
    capacity: double it and invalidate built shards.  Built shards whose
    joined inputs were reclaimed are RENAMED (.old.npz) instead of
    deleted — task_build reconstructs their keys via ``items()``."""
    cap_path = os.path.join(workdir, "capacity.json")
    with open(cap_path) as f:
        meta = json.load(f)
    meta["capacity"] *= 2
    with open(cap_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(cap_path + ".tmp", cap_path)
    for p in glob.glob(os.path.join(workdir, "shards", "shard_*.npz")):
        if p.endswith(".old.npz"):
            continue
        shard = os.path.splitext(os.path.basename(p))[0]  # shard_NNN
        joined = os.path.join(workdir, "joined", f"s{shard[6:]}.npz")
        if os.path.exists(joined):
            os.remove(p)
        else:
            os.replace(p, p[: -len(".npz")] + ".old.npz")
    for p in glob.glob(os.path.join(workdir, "shards", "shard_*.done")):
        os.remove(p)
    return meta["capacity"]


def task_build(workdir: str, manifest: dict, shard: int) -> None:
    from .table import KmerTable

    shards_dir = os.path.join(workdir, "shards")
    stamp = os.path.join(shards_dir, f"shard_{shard:03d}")
    if _is_done(stamp):
        return
    cap = common_capacity(workdir, manifest)
    joined_path = os.path.join(workdir, "joined", f"s{shard:03d}.npz")
    old_path = os.path.join(shards_dir, f"shard_{shard:03d}.old.npz")
    if os.path.exists(joined_path):
        z = np.load(joined_path)
        keys = z["keys"].astype(np.uint64)
        values = z["values"].astype(np.int32)
    else:
        # joined inputs reclaimed; a capacity bump renamed the previous
        # build — its items() reconstruct the exact key/value set
        from .table import load_table

        keys, values = load_table(old_path).items()
        keys = keys.astype(np.uint64)
    # explicit geometry (no layout fallback): every shard MUST share
    # one row shape or the stacked serving table breaks
    bucket = BUCKETS.get(manifest["layout"], 16)
    probes = PROBE_LIMITS.get(manifest["layout"], 1)
    table = KmerTable.build(keys, values.astype(np.int32),
                            k=manifest["k"], bucket=bucket,
                            max_probe_limit=probes, stash_cap=256,
                            capacity=cap)
    # Uniform probe depth by construction: ``build`` records the
    # REALIZED displacement depth, so at mid load one shard of a
    # conveyor layout can realize 0 while its siblings realize 1 —
    # ShardedTable.from_shards would then refuse the build's own
    # artifact as a layout mix.  Stamp the layout's declared depth
    # instead (probing an undisplaced table one round deeper is exact:
    # round-2 comparisons expect distance-1 tags, which an undisplaced
    # table never stores).
    table.max_probes = max(table.max_probes, probes)
    # packed wire layout, uncompressed: serving mmaps these and feeds
    # device_put directly — cold start is pure disk->HBM transfer (no
    # zlib, no host-side row repacking)
    table.save(os.path.join(shards_dir, f"shard_{shard:03d}.npz"),
               packed=True)
    _mark(stamp)
    if os.path.exists(old_path):
        os.remove(old_path)
    if manifest.get("reclaim") and os.path.exists(joined_path):
        os.remove(joined_path)


# ---------------------------------------------------------------------- #
# Supervisor
# ---------------------------------------------------------------------- #

def _spawn(workdir: str, task: str, indexes: List[int], threads: int = 1):
    return subprocess.Popen(
        [sys.executable, "-m", "umgap_tpu", "buildindex-dist",
         "--workdir", workdir, "--task", task,
         "--index", ",".join(str(i) for i in indexes),
         "--join-threads", str(threads)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _run_stage(workdir: str, task: str, pending: List[int],
               workers: int, threads: int = 1) -> List[Tuple[int, int]]:
    """Run tasks across worker subprocesses — each worker handles a
    strided SLICE of tasks in one process (a fresh interpreter per task
    would pay the Python+jax import ~1-2s x tasks).  Returns (index,
    exit-code) pairs for failed slices (reported per-slice; .done
    markers keep resume granularity per-task)."""
    from ..utils import log

    slices = [pending[w::workers] for w in range(workers)]
    slices = [s for s in slices if s]
    running = {tuple(s): _spawn(workdir, task, s, threads) for s in slices}
    failed: List[Tuple[int, int]] = []
    while running:
        done_key = None
        for key, proc in running.items():
            rc = proc.poll()
            if rc is not None:
                done_key = key
                if rc != 0:
                    log(f"buildindex-dist: {task} worker for tasks "
                        f"{list(key)[:6]}... failed (exit {rc}); "
                        "finished tasks are checkpointed, re-run to "
                        "resume the rest")
                    failed.extend((i, rc) for i in key
                                  if not _is_done(_task_stamp(
                                      workdir, task, i)))
                break
        if done_key is not None:
            running.pop(done_key)
        else:
            time.sleep(0.05)
    return failed


def _task_stamp(workdir: str, task: str, index: int) -> str:
    if task == "partition":
        return os.path.join(workdir, "part", f"c{index:05d}")
    if task == "join":
        return os.path.join(workdir, "joined", f"s{index:03d}")
    return os.path.join(workdir, "shards", f"shard_{index:03d}")


def drive(workdir: str, tsv: Optional[str], taxons: Optional[str],
          n_shards: int = 16, workers: int = 2, k: int = 9,
          synthetic_rows: Optional[int] = None, seed: int = 7,
          n_tax: int = 200_000, chunk_bytes: int = 256 << 20,
          rows_per_chunk: int = 20_000_000, layout: str = LAYOUT,
          reclaim: bool = False, reclaim_input: bool = False) -> dict:
    """Run (or resume) the whole job; returns the manifest with timing
    and completion state.  Idempotent: finished tasks are skipped via
    their ``.done`` markers."""
    from ..utils import log

    workdir = os.path.abspath(workdir)  # workers may run elsewhere
    os.makedirs(workdir, exist_ok=True)
    for sub in ("part", "joined", "shards"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)

    man_path = os.path.join(workdir, "manifest.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)
    else:
        if synthetic_rows is not None:
            n_chunks = max(1, -(-synthetic_rows // rows_per_chunk))
            taxons_path = os.path.abspath(
                taxons or os.path.join(workdir, "taxons.tsv"))
            manifest = dict(input="synthetic", seed=seed, n_tax=n_tax,
                            rows_per_chunk=rows_per_chunk,
                            total_rows=synthetic_rows,
                            n_chunks=n_chunks, taxons=taxons_path,
                            n_shards=n_shards, k=k, layout=layout,
                            reclaim=reclaim)
        else:
            chunks = tsv_chunks(tsv, chunk_bytes)
            manifest = dict(input="tsv", tsv=os.path.abspath(tsv),
                            chunks=chunks, n_chunks=len(chunks),
                            taxons=os.path.abspath(taxons),
                            n_shards=n_shards, k=k, layout=layout,
                            reclaim=reclaim, reclaim_input=reclaim_input)
        with open(man_path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(man_path + ".tmp", man_path)

    if manifest["input"] == "synthetic" and \
            not os.path.exists(manifest["taxons"]):
        log("buildindex-dist: generating synthetic taxonomy")
        write_synthetic_taxonomy(manifest["taxons"], manifest["n_tax"],
                                 manifest["seed"])

    timings = {}
    stages = [
        ("partition", [c for c in range(manifest["n_chunks"])
                       if not _is_done(os.path.join(workdir, "part",
                                                    f"c{c:05d}"))], 1),
        ("join", [s for s in range(manifest["n_shards"])
                  if not _is_done(os.path.join(workdir, "joined",
                                               f"s{s:03d}"))],
         max(1, (os.cpu_count() or 2) // workers)),
        ("build", [s for s in range(manifest["n_shards"])
                   if not _is_done(os.path.join(workdir, "shards",
                                                f"shard_{s:03d}"))], 1),
    ]
    for task, pending, threads in stages:
        t0 = time.perf_counter()
        attempts = 0
        while pending:
            log(f"buildindex-dist: stage {task}: {len(pending)} task(s) "
                f"over {workers} worker(s)")
            failed = _run_stage(workdir, task, pending, workers, threads)
            if not failed:
                break
            # capacity backstop: exit code 3 = stash overflow at the
            # sized capacity; double and rebuild the whole stage
            if task == "build" and all(rc == 3 for _i, rc in failed) \
                    and attempts < 3:
                cap = bump_capacity(workdir)
                log(f"buildindex-dist: capacity bumped to {cap}; "
                    "rebuilding shards")
                pending = list(range(manifest["n_shards"]))
                attempts += 1
                continue
            raise RuntimeError(
                f"stage {task}: {len(failed)} task(s) failed "
                f"({failed[:8]}...); re-run the same command to resume")
        timings[task] = round(time.perf_counter() - t0, 2)

    manifest["timings"] = timings
    manifest["capacity"] = common_capacity(workdir, manifest)
    n_keys = sum(_shard_key_count(workdir, s)
                 for s in range(manifest["n_shards"]))
    manifest["n_keys"] = n_keys
    with open(man_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(man_path + ".tmp", man_path)
    log(f"buildindex-dist: complete — {n_keys} keys in "
        f"{manifest['n_shards']} shards under {workdir}/shards "
        f"(timings {timings})")
    return manifest


def load_shards(workdir: str, mmap: bool = False):
    """The built artifacts, ready for ShardedTable.from_shards (serving)
    or single-host concatenated probing.  ``mmap`` maps the slot arrays
    instead of reading them (the shards are saved uncompressed for
    exactly this), so serve-time cold-start streams pages disk -> packed
    rows -> HBM without first materializing every artifact in RAM."""
    from .table import load_table

    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    shards = []
    for s in range(manifest["n_shards"]):
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"shard artifact missing: {path} — the manifest names "
                f"{manifest['n_shards']} shards; re-run buildindex-dist "
                f"--workdir {workdir} to resume the build")
        try:
            shards.append(load_table(path, mmap=mmap))
        except Exception as e:
            raise ShardArtifactError(
                f"shard artifact unreadable (truncated or corrupt): "
                f"{path}: {e}; delete it and its .done marker, then "
                f"re-run buildindex-dist --workdir {workdir}") from e
    return shards


def repack_shards(workdir: str, log=lambda s: None) -> int:
    """Relayout existing shard artifacts into the packed wire format
    (``KmerTable.save(packed=True)``) in place — atomic per shard,
    already-packed shards skipped, safe to re-run. Converts artifacts
    built before the packed format existed so serving cold starts become
    pure disk->HBM transfer (no ~100 s host-side row repack).
    Returns the number of shards rewritten."""
    # load_shards (not a bare load_table loop) so missing/truncated
    # artifacts fail with the same named-file + resume remedy serving
    # gives
    shards = load_shards(workdir, mmap=True)
    n = 0
    for s, t in enumerate(shards):
        if t.kind != "kmer" or t.rows_packed is not None:
            continue
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        tmp = path + ".repack.npz"
        t.save(tmp, packed=True)
        os.replace(tmp, path)
        n += 1
        log(f"repacked shard {s}")
    return n


def densify_shards(workdir: str, log=lambda s: None) -> int:
    """Relayout existing 64-slot shard artifacts into the dense
    ``bucket64d`` geometry in place — atomic per shard, safe to re-run
    (shards already at the dense capacity are skipped).  items() gives
    each shard's exact key/value set; the rebuild conveyor-places them
    at up to ~0.88 load, typically HALVING artifact bytes (the build
    sizes bucket64s at load 0.50) at the cost of a 2-row probe.
    Returns the number of shards rewritten."""
    from .table import KmerTable, MIN_NB_BITS, _pow2_capacity

    man_path = os.path.join(workdir, "manifest.json")
    with open(man_path) as f:
        manifest = json.load(f)
    shards = load_shards(workdir, mmap=True)
    if any(t.kind != "kmer" or t.bucket != 64 for t in shards):
        raise ValueError(
            "--densify relayouts 64-slot-bucket k-mer shards "
            "(bucket64s); rebuild other layouts with --layout bucket64d")
    cap = _pow2_capacity(max(t.n for t in shards),
                         LOAD_FACTORS["bucket64d"], 64 << MIN_NB_BITS)
    n = 0
    for s, t in enumerate(shards):
        if t.capacity == cap and t.max_probes == PROBE_LIMITS["bucket64d"]:
            continue
        keys, values = t.items()
        try:
            dense = KmerTable.build(
                keys.astype(np.uint64), values.astype(np.int32),
                k=t.k, bucket=64,
                max_probe_limit=PROBE_LIMITS["bucket64d"],
                stash_cap=256, capacity=cap)
        except RuntimeError as e:
            raise RuntimeError(
                f"shard {s} will not densify at capacity {cap} ({e}); "
                "its realized load exceeds the conveyor ceiling — "
                "rebuild with more shards instead") from e
        # uniform probe depth by construction (see task_build)
        dense.max_probes = max(dense.max_probes,
                               PROBE_LIMITS["bucket64d"])
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        tmp = path + ".densify.npz"
        dense.save(tmp, packed=True)
        os.replace(tmp, path)
        n += 1
        log(f"densified shard {s}: {t.capacity} -> {cap} slots "
            f"(load {t.n / cap:.2f})")
    manifest["layout"] = "bucket64d"
    manifest["capacity"] = cap
    with open(man_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(man_path + ".tmp", man_path)
    return n


def worker_main(workdir: str, task: str, indexes, join_threads: int = 1) -> None:
    """Run one or more tasks (comma-separated indexes) in this process;
    expensive per-process state (the taxonomy) loads once."""
    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    if isinstance(indexes, int):
        indexes = [indexes]
    elif isinstance(indexes, str):
        indexes = [int(x) for x in indexes.split(",") if x != ""]
    tax = None
    for index in indexes:
        if task == "partition":
            task_partition(workdir, manifest, index)
        elif task == "join":
            if tax is None:
                from ..taxonomy import Taxonomy, read_taxa_file

                tax = Taxonomy(read_taxa_file(manifest["taxons"]))
            task_join(workdir, manifest, index, n_threads=join_threads,
                      tax=tax)
        elif task == "build":
            try:
                task_build(workdir, manifest, index)
            except RuntimeError:
                sys.exit(3)  # stash overflow at the common capacity:
                #              the driver doubles it and rebuilds
        else:
            raise ValueError(f"unknown task {task}")
