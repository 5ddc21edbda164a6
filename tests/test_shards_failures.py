"""`analyse --shards` failure modes (round-5 item 6).

Every broken-artifact shape must fail with a SPECIFIC message — not an
opaque numpy/zip traceback — because a production serve job hitting one
of these needs to know which shard to rebuild and how.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest

from umgap_tpu.cli import main as cli_main
from umgap_tpu.index import distbuild
from umgap_tpu.index.table import KmerTable, build_kmer_table


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A healthy miniature 8-shard serving workdir + reads + taxonomy."""
    tmp = tmp_path_factory.mktemp("shards_fail")
    work = tmp / "work"
    (work / "shards").mkdir(parents=True)

    rng = np.random.default_rng(21)
    packed = np.unique(
        rng.integers(0, 2**45, size=8000).astype(np.uint64))[:4000]
    values = rng.integers(2, 10, size=len(packed)).astype(np.int32)
    from umgap_tpu.parallel.sharded import build_sharded_tables

    shards = build_sharded_tables(packed, values, k=9, n_shards=8,
                                  layout="bucket16")
    for s, t in enumerate(shards):
        t.save(work / "shards" / f"shard_{s:03d}.npz", packed=True)

    taxons = tmp / "taxons.tsv"
    with open(taxons, "w") as f:
        f.write("1\troot\tno rank\t1\t\x01\n")
        for i in range(2, 11):
            f.write(f"{i}\tt{i}\tspecies\t1\t\x01\n")
    with open(work / "manifest.json", "w") as f:
        json.dump({"n_shards": 8, "k": 9, "layout": "bucket16",
                   "capacity": shards[0].capacity,
                   "taxons": str(taxons)}, f)

    reads = tmp / "reads.fa"
    with open(reads, "w") as f:
        for i in range(8):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 60))
            f.write(f">r{i}\n{seq}\n")
    return {"work": str(work), "reads": str(reads), "taxons": str(taxons),
            "capacity": shards[0].capacity, "tmp": str(tmp)}


def _run(workdir, reads, taxons, extra=()):
    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "max-sensitivity", "-1", reads,
         "--taxons", taxons, "--shards", workdir,
         "--batch-size", "16", "--read-length", "64", *extra],
        stdin=io.StringIO(""), stdout=out)
    return rc, out.getvalue()


def _clone(src_work, dst):
    shutil.copytree(src_work, dst)
    return str(dst)


def test_happy_path(workdir):
    rc, out = _run(workdir["work"], workdir["reads"], workdir["taxons"])
    assert rc == 0
    assert out.count(">") == 8


def test_missing_shard(workdir, tmp_path, capsys):
    work = _clone(workdir["work"], tmp_path / "w")
    os.remove(os.path.join(work, "shards", "shard_003.npz"))
    rc, _ = _run(work, workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "shard artifact missing" in err and "shard_003.npz" in err
    assert "re-run buildindex-dist" in err


def test_truncated_shard(workdir, tmp_path, capsys):
    work = _clone(workdir["work"], tmp_path / "w")
    path = os.path.join(work, "shards", "shard_002.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    rc, _ = _run(work, workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "unreadable" in err and "shard_002.npz" in err


def test_mixed_layouts(workdir, tmp_path, capsys):
    """A bucket64s shard inside a bucket16 workdir (same capacity) is a
    geometry mismatch, named by shard index."""
    work = _clone(workdir["work"], tmp_path / "w")
    path = os.path.join(work, "shards", "shard_005.npz")
    from umgap_tpu.index.table import load_table

    keys, vals = load_table(path).items()
    t64 = KmerTable.build(keys.astype(np.uint64), vals, k=9, bucket=64,
                          max_probe_limit=0, stash_cap=256,
                          capacity=workdir["capacity"])
    t64.save(path, packed=True)
    rc, _ = _run(work, workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "geometry mismatch" in err and "shard 5" in err
    assert "bucket=64" in err and "bucket=16" in err


def test_capacity_mismatch(workdir, tmp_path, capsys):
    work = _clone(workdir["work"], tmp_path / "w")
    path = os.path.join(work, "shards", "shard_001.npz")
    from umgap_tpu.index.table import load_table

    keys, vals = load_table(path).items()
    big = KmerTable.build(keys.astype(np.uint64), vals, k=9, bucket=16,
                          max_probe_limit=1, stash_cap=256,
                          capacity=2 * workdir["capacity"])
    big.save(path, packed=True)
    rc, _ = _run(work, workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "geometry mismatch" in err and "shard 1" in err


def test_hbm_guard_refusal_impossible(workdir, monkeypatch, capsys):
    """UMGAP_HBM_BYTES drives the capacity pre-check: when even one
    shard per device exceeds the limit, the advice is to rebuild with
    more shards (a bigger mesh cannot help)."""
    monkeypatch.setenv("UMGAP_HBM_BYTES", "100000")
    rc, _ = _run(workdir["work"], workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "rebuild with more shards" in err


def test_hbm_guard_divisor_advice(workdir, monkeypatch, capsys):
    """The mesh-size advice must be a divisor of n_shards (whole shards
    per device): a raw need of 3 on an 8-shard artifact rounds to 4."""
    cap = workdir["capacity"]
    # per-device rows on the requested 2-device mesh = 4 shards * cap*8
    # bytes > 0.95*limit, and total/(0.95*limit) lands in (2, 3]
    monkeypatch.setenv("UMGAP_HBM_BYTES", str(int(23.23 * cap)))
    rc, _ = _run(workdir["work"], workdir["reads"], workdir["taxons"],
                 extra=("--mesh", "2"))
    assert rc == 1
    err = capsys.readouterr().err
    assert "serve this artifact on a mesh of >= 4 devices" in err


def test_hbm_guard_reports_unknown_limit(workdir, monkeypatch, capsys):
    """With no UMGAP_HBM_BYTES and a device that reports no memory limit
    (CPU devices report none) the guard says so and does not guess."""
    monkeypatch.delenv("UMGAP_HBM_BYTES", raising=False)
    rc, out = _run(workdir["work"], workdir["reads"], workdir["taxons"])
    assert rc == 0
    assert out.count(">") == 8
    assert "no device memory limit known" in capsys.readouterr().err


def test_no_manifest(workdir, tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, _ = _run(str(empty), workdir["reads"], workdir["taxons"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "no manifest.json" in err
