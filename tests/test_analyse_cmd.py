"""End-to-end `analyse` command test on the golden read corpus."""

import io
import os

import numpy as np
import pytest

from umgap_tpu import ranks
from umgap_tpu.cli import main as cli_main
from umgap_tpu.index.table import KmerTable
from umgap_tpu.ops import encoding, kmers as kmerops
from umgap_tpu.taxonomy import Taxon, Taxonomy

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "data")


@pytest.fixture
def world(tmp_path):
    S = ranks.rank_index("superkingdom")
    taxa = [
        Taxon(1, "root", ranks.NO_RANK, 1, True),
        Taxon(2, "Bacteria", S, 1, True),
    ]
    tax = Taxonomy(taxa)
    taxfile = tmp_path / "taxons.tsv"
    taxfile.write_text("1\troot\tno rank\t1\t\x01\n2\tBacteria\tsuperkingdom\t1\t\x01\n")

    # index the 9-mers of frame-1 translations of the first testdata read
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        lines = f.read().splitlines()
    seq = lines[1]
    from umgap_tpu.ops import translate as transmod

    pep = transmod.translate_sequence(seq, ["1"], encoding.get_table(1))[0]
    packed = kmerops.pack_kmers_host(encoding.encode_aa(pep), 9)
    packed = np.unique(packed)
    table = KmerTable.build(packed, np.full(len(packed), 2, np.int32), k=9)
    idxfile = tmp_path / "nine.npz"
    table.save(idxfile)
    return str(taxfile), str(idxfile)


def test_analyse_command_runs(world, tmp_path):
    taxfile, idxfile = world
    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "max-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", taxfile, "--index", idxfile,
         "--batch-size", "32", "--read-length", "100"],
        stdin=io.StringIO(""), stdout=out)
    assert rc == 0
    text = out.getvalue()
    records = text.count(">")
    assert records == 100  # 100 read pairs in the sample
    # the first read's frame-1 9-mers are all indexed -> resolves to taxon 2
    first = text.split(">")[1].splitlines()
    assert first[1] == "2"


def test_analyse_tryptic_runs(world, tmp_path):
    taxfile, idxfile = world
    from umgap_tpu.index.table import PeptideTable

    tryp = PeptideTable.build(["AAAAAAAAA"], np.array([2], np.int32))
    tfile = tmp_path / "tryp.npz"
    tryp.save(tfile)
    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "tryptic-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", taxfile, "--index", str(tfile),
         "--batch-size", "32"],
        stdin=io.StringIO(""), stdout=out)
    assert rc == 0
    assert out.getvalue().count(">") == 100


def _ancestor_chain(by_parent, t):
    out = set()
    cur = t
    while True:
        out.add(cur)
        p = by_parent.get(cur)
        if p is None or p == cur:
            break
        cur = p
    return out


def test_analyse_ground_truth_accuracy(tmp_path):
    """analyse vs the planted per-pair ground truth of the golden corpus
    (tests/golden/data/ground_truth.tsv): known pairs must resolve to
    their species or an ancestor, noise pairs must stay unassigned."""
    golden_dir = os.path.join(os.path.dirname(__file__), "golden")
    data = os.path.join(golden_dir, "data")

    # build the committed ninemer index
    from umgap_tpu.index.build import build_table

    rows = []
    with open(os.path.join(data, "ninemer.tsv")) as f:
        for line in f:
            k, v = line.rstrip("\n").split("\t")
            rows.append((k, int(v)))
    table = build_table(rows, kind="kmer")
    idxfile = tmp_path / "nine.npz"
    table.save(idxfile)

    out = io.StringIO()
    rc = cli_main(
        ["analyse", "-t", "high-sensitivity",
         "-1", os.path.join(TESTDATA, "A1.fq"),
         "-2", os.path.join(TESTDATA, "A2.fq"),
         "--taxons", os.path.join(data, "taxonomy.tsv"),
         "--index", str(idxfile),
         "--batch-size", "32", "--read-length", "100"],
        stdin=io.StringIO(""), stdout=out)
    assert rc == 0

    truth = {}
    with open(os.path.join(data, "ground_truth.tsv")) as f:
        for line in f:
            h, sp = line.rstrip("\n").split("\t")
            truth[h] = int(sp)
    by_parent = {}
    with open(os.path.join(data, "taxonomy.tsv")) as f:
        for line in f:
            cells = line.rstrip("\n").split("\t")
            by_parent[int(cells[0])] = int(cells[3])

    got = {}
    for block in out.getvalue().split(">")[1:]:
        ls = block.splitlines()
        got[ls[0]] = int(ls[1])
    assert len(got) == 100

    known_ok = known_tot = exact = unk_ok = unk_tot = 0
    for h, result in got.items():
        t = truth[h]
        if t == 0:
            unk_tot += 1
            unk_ok += result == 1
        else:
            known_tot += 1
            ok = result in _ancestor_chain(by_parent, t)
            known_ok += ok
            exact += result == t
    # measured on the committed corpus: 90/90 anc-or-self, 71 exact,
    # 10/10 unassigned; thresholds leave margin for future pipeline edits
    assert known_ok / known_tot >= 0.90
    assert exact / known_tot >= 0.60
    assert unk_ok / unk_tot >= 0.85
