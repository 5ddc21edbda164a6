"""CLI-reachable multi-device serving: `analyse --mesh / --shards`.

The reference's one scale mechanism — the shared socket index of
umgap-analyse.sh:257-264 — is user-facing; these tests drive its
multi-device counterpart through the SAME user-facing CLI entry point over
the 8-device virtual CPU mesh and require byte-identical output to the
single-device path for every preset.
"""

import io
import json
import os

import numpy as np
import pytest

from umgap_tpu.cli import main as cli_main

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "data")
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")

PRESETS_6 = ["max-sensitivity", "high-sensitivity", "high-precision",
             "max-precision", "tryptic-sensitivity", "tryptic-precision"]


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The golden-corpus 9-mer and tryptic indexes as .npz files."""
    from umgap_tpu.index.build import build_table

    tmp = tmp_path_factory.mktemp("sharded_cli")

    def rows(name):
        out = []
        with open(os.path.join(DATA, name)) as f:
            for line in f:
                k, v = line.rstrip("\n").split("\t")[:2]
                out.append((k, int(v)))
        return out

    nine = tmp / "ninemer.npz"
    build_table(rows("ninemer.tsv"), kind="kmer").save(nine)
    tryp = tmp / "tryptic.npz"
    build_table(rows("tryptic.tsv"), kind="peptide").save(tryp)
    return str(nine), str(tryp)


def _run_analyse(preset, index, extra=()):
    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", preset,
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", os.path.join(DATA, "taxonomy.tsv"),
         "--index", index,
         "--batch-size", "32", "--read-length", "100", *extra],
        stdin=io.StringIO(""), stdout=out)
    assert rc == 0, out.getvalue()
    return out.getvalue()


@pytest.mark.parametrize("preset", PRESETS_6)
def test_analyse_mesh_matches_single(indexes, preset):
    """All six presets through `analyse --mesh 8`: byte-identical to the
    single-device CLI path on the 100-pair corpus."""
    nine, tryp = indexes
    index = tryp if preset.startswith("tryptic") else nine
    single = _run_analyse(preset, index)
    meshed = _run_analyse(preset, index, extra=("--mesh", "8"))
    assert meshed == single
    assert single.count(">") == 100


def test_analyse_mesh_one_device(indexes):
    """--mesh degrades gracefully to a 1-shard mesh (the real-chip
    case)."""
    nine, _ = indexes
    single = _run_analyse("max-sensitivity", nine)
    one = _run_analyse("max-sensitivity", nine, extra=("--mesh", "1"))
    assert one == single


@pytest.mark.parametrize("layout", ["bucket64s", "bucket64d"])
def test_analyse_shards_dir_grouped(tmp_path, indexes, layout):
    """`analyse --shards <buildindex-dist workdir>`: a 16-shard build
    served on the 8-device mesh (2 sub-shards per device), byte-equal
    to serving the merged single-table index.  Parametrized over the
    sparse single-gather layout AND the dense 2-round bucket64d one —
    grouped sub-shard addressing must compose with displacement
    probing (production artifacts serve this way)."""
    from umgap_tpu.index import distbuild
    from umgap_tpu.index.table import KmerTable
    from umgap_tpu.ops import encoding, kmers as kmerops, translate

    # index the frame-1 9-mers of the first 8 reads so hits exist
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        lines = f.read().splitlines()
    seqs = [lines[i] for i in range(1, 32, 4)]
    packed = []
    for seq in seqs:
        pep = translate.translate_sequence(
            seq, ["1"], encoding.get_table(1))[0]
        packed.append(kmerops.pack_kmers_host(encoding.encode_aa(pep), 9))
    packed = np.unique(np.concatenate(packed))
    values = np.where(np.arange(len(packed)) % 3 == 0, 2, 3).astype(np.int32)

    # write the pairs as a joinable TSV-free workdir: drive a real
    # buildindex-dist over a tiny TSV built from these very k-mers
    tsv = tmp_path / "seqs.tsv"
    with open(tsv, "w") as f:
        for p, v in zip(packed, values):
            f.write(f"{v}\t{kmerops.unpack_kmer(int(p), 9)}\n")
    taxons = os.path.join(DATA, "taxonomy.tsv")
    distbuild.drive(str(tmp_path / "work"), str(tsv), taxons,
                    n_shards=16, workers=2, k=9, layout=layout)
    with open(tmp_path / "work" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_shards"] == 16

    # single-table reference: merge the shard items into one npz
    shards = distbuild.load_shards(str(tmp_path / "work"))
    allp = np.concatenate([t.items()[0] for t in shards])
    allv = np.concatenate([t.items()[1] for t in shards])
    single_table = KmerTable.build(allp, allv, k=9)
    single_npz = tmp_path / "single.npz"
    single_table.save(single_npz)

    single = _run_analyse("max-sensitivity", str(single_npz))
    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "max-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", taxons,
         "--shards", str(tmp_path / "work"),
         "--batch-size", "32", "--read-length", "100"],
        stdin=io.StringIO(""), stdout=out)
    assert rc == 0
    assert out.getvalue() == single
    # shards/ subdirectory is accepted too, and a bad mesh divisor errors
    out2 = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "max-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", taxons,
         "--shards", str(tmp_path / "work" / "shards"),
         "--mesh", "4",
         "--batch-size", "32", "--read-length", "100"],
        stdin=io.StringIO(""), stdout=out2)
    assert rc == 0
    assert out2.getvalue() == single
    rc = cli_main(
        ["analyse", "-t", "max-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "--taxons", taxons,
         "--shards", str(tmp_path / "work"), "--mesh", "5"],
        stdin=io.StringIO(""), stdout=io.StringIO())
    assert rc == 1


def test_mesh_serve_socket(tmp_path, indexes):
    """`analyse --serve` combined with --mesh: the persistent service
    runs the sharded pipeline per request."""
    import socket
    import threading

    nine, _ = indexes
    sock = str(tmp_path / "svc.sock")
    outfile = str(tmp_path / "out.fa")

    t = threading.Thread(
        target=cli_main,
        args=(["analyse", "--taxons",
               os.path.join(DATA, "taxonomy.tsv"),
               "--index", nine, "--mesh", "8",
               "--batch-size", "32", "--read-length", "100",
               "--serve", sock],),
        kwargs=dict(stdin=io.StringIO(""), stdout=io.StringIO()),
        daemon=True)
    t.start()
    import time

    for _ in range(100):
        if os.path.exists(sock):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("service socket never appeared")

    def request(line):
        c = socket.socket(socket.AF_UNIX)
        c.connect(sock)
        c.sendall(line.encode())
        chunks = []
        while True:
            b = c.recv(65536)
            if not b:
                break
            chunks.append(b)
        c.close()
        return b"".join(chunks).decode()

    rep = request(
        f"-t max-sensitivity -1 {TESTDATA}/A1.fq -2 {TESTDATA}/A2.fq "
        f"-o {outfile}\n")
    assert rep.strip() == "ok 100"
    with open(outfile) as f:
        served = f.read()
    single = _run_analyse("max-sensitivity", nine)
    assert served == single
    request("quit\n")
    t.join(timeout=30)
