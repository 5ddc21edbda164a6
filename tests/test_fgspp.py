"""FGSpp gene-prediction front end: wrapper plumbing driven by a mock
binary (the real FGSpp is an optional external dependency in the
reference too and is absent here; tests requiring it skip)."""

import io
import os
import stat

import numpy as np
import pytest

from umgap_tpu import fgspp, ranks
from umgap_tpu.cli import main as cli_main
from umgap_tpu.index.table import KmerTable, PeptideTable
from umgap_tpu.ops import encoding, kmers as kmerops

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "data")
# digest: "MK" (dropped, <9) + "AAAAAAAAAK" (kept); 4 distinct 9-mers
PROT = "MKAAAAAAAAAK"


@pytest.fixture
def confdir(tmp_path):
    """Config dir with a mock FGSpp that predicts PROT for every read."""
    d = tmp_path / "conf"
    (d / "FGSpp").mkdir(parents=True)
    (d / "FGSpp" / "train").mkdir()
    binary = d / "FGSpp" / "FGSpp"
    binary.write_text(
        "#!/bin/sh\n"
        f"awk '/^>/{{print $0 \"_1_99_+\"; print \"{PROT}\"}}'\n")
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    return str(d)


@pytest.fixture
def world(tmp_path):
    taxfile = tmp_path / "taxons.tsv"
    taxfile.write_text(
        "1\troot\tno rank\t1\t\x01\n2\tBacteria\tsuperkingdom\t1\t\x01\n")
    packed = np.unique(
        kmerops.pack_kmers_host(encoding.encode_aa(PROT), 9))
    KmerTable.build(packed, np.full(len(packed), 2, np.int32),
                    k=9).save(tmp_path / "nine.npz")
    PeptideTable.build(["AAAAAAAAAK"], np.array([2], np.int32)).save(
        tmp_path / "tryp.npz")
    return str(taxfile), str(tmp_path / "nine.npz"), str(tmp_path / "tryp.npz")


def test_find_fgspp(confdir, tmp_path):
    assert fgspp.find_fgspp(confdir) is not None
    assert fgspp.find_fgspp(str(tmp_path)) is None


def test_predict_and_group(confdir):
    fg = fgspp.find_fgspp(confdir)
    records = [("r1/1", "ACGT" * 10), ("r1/2", "TTTT" * 10),
               ("r2/1", "GGGG" * 10)]
    genes = list(fgspp.predict_genes(fg[0], fg[1], records))
    assert genes == [("r1/1_1_99_+", PROT), ("r1/2_1_99_+", PROT),
                     ("r2/1_1_99_+", PROT)]
    groups = list(fgspp.group_genes(genes))
    assert groups == [("r1", [PROT, PROT]), ("r2", [PROT])]


def _run(argv):
    out = io.StringIO()
    rc = cli_main(["analyse"] + argv, stdin=io.StringIO(""), stdout=out)
    return rc, out.getvalue()


def test_analyse_fgspp_kmer_precision(confdir, world):
    """high-precision with the mock front end: every read's two ends
    each predict PROT; all 9-mers hit taxon 2 -> consensus 2."""
    taxfile, nine, _ = world
    rc, text = _run([
        "-t", "high-precision",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", nine,
        "--configdir", confdir, "--read-length", "100"])
    assert rc == 0
    blocks = [b.splitlines() for b in text.split(">")[1:]]
    assert len(blocks) == 100
    assert all(b[1] == "2" for b in blocks)


def test_analyse_fgspp_tryptic(confdir, world):
    taxfile, _, tryp = world
    rc, text = _run([
        "-t", "tryptic-precision",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", tryp,
        "--configdir", confdir, "--read-length", "100"])
    assert rc == 0
    blocks = [b.splitlines() for b in text.split(">")[1:]]
    assert len(blocks) == 100
    # tryptic-precision lower bound is 5; each read group digests two
    # copies of AAAAAAAAAK (count 2 < 5) -> filtered -> root default 1
    assert all(b[1] == "1" for b in blocks)


def test_analyse_fgspp_sensitivity_lower_bound(confdir, world):
    """tryptic-sensitivity (bound 1): the two digested copies survive
    and aggregate to the planted taxon."""
    taxfile, _, tryp = world
    rc, text = _run([
        "-t", "tryptic-sensitivity",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", tryp,
        "--configdir", confdir, "--read-length", "100"])
    assert rc == 0
    blocks = [b.splitlines() for b in text.split(">")[1:]]
    assert all(b[1] == "2" for b in blocks)


def test_analyse_fgspp_require_missing(world, tmp_path):
    taxfile, nine, _ = world
    rc, _ = _run([
        "-t", "high-precision",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", nine,
        "--configdir", str(tmp_path), "--fgspp", "require"])
    assert rc == 1


def test_analyse_fgspp_never_uses_translation(confdir, world, tmp_path):
    """--fgspp never must ignore an installed FGSpp and produce the
    self-contained 6-frame result (mock would say taxon 2 everywhere;
    translation of random testdata reads misses this toy index)."""
    taxfile, nine, _ = world
    rc, text = _run([
        "-t", "max-precision",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", nine,
        "--configdir", confdir, "--fgspp", "never",
        "--read-length", "100"])
    assert rc == 0
    blocks = [b.splitlines() for b in text.split(">")[1:]]
    assert len(blocks) == 100
    assert any(b[1] == "1" for b in blocks)  # not the mock's uniform 2


def test_protein_analyser_overflow_reroute():
    """ProteinAnalyser k_max overflow: a gene group hitting more
    distinct taxa than k_max must re-route through the exact wide
    program and match a wide-configured run."""
    from umgap_tpu.agg import device as devagg
    from umgap_tpu.ops import lookup
    from umgap_tpu.pipeline import PRESETS
    from umgap_tpu.pipeline.proteins import (
        ProteinAnalyser,
        encode_protein_groups,
    )
    from umgap_tpu.taxonomy import Taxonomy, fixture_taxa

    rng = np.random.default_rng(31)
    # 30 proteins of 12 AAs; each 9-mer its own taxon from the fixture
    prots = ["".join(rng.choice(list("ACDEFGHILMNQSTVWY"), 12))
             for _ in range(30)]
    packed = []
    for p in prots:
        packed.append(kmerops.pack_kmers_host(encoding.encode_aa(p), 9))
    packed = np.unique(np.concatenate(packed))
    ids = np.array([2, 10239, 12884, 185751, 185752], np.int32)
    values = rng.choice(ids, size=len(packed)).astype(np.int32)
    table = KmerTable.build(packed, values, k=9)
    tax = Taxonomy(fixture_taxa())
    dtax = devagg.DeviceTaxonomy.from_host(tax)
    dtable = lookup.DeviceTable.from_host(table)

    groups = [(f"g{i}", [prots[2 * i], prots[2 * i + 1]])
              for i in range(15)]
    aa, lens = encode_protein_groups(groups, 2, 16)
    config = PRESETS["max-sensitivity"]._replace(k_max=2, min_seed_size=1)

    an = ProteinAnalyser(tax, None, config, batch_size=16,
                         read_length=16, ends=2, dtax=dtax, dtable=dtable)
    got = dict(list(an.feed([h for h, _ in groups], aa, lens))
               + list(an.finish()))
    assert an.overflow_reads > 0, "workload must overflow k_max=2"

    wide_cfg = config._replace(k_max=2 * 8)  # exact: 8 windows per lane
    an2 = ProteinAnalyser(tax, None, wide_cfg, batch_size=16,
                          read_length=16, ends=2, dtax=dtax,
                          dtable=dtable)
    expect = dict(list(an2.feed([h for h, _ in groups], aa, lens))
                  + list(an2.finish()))
    assert got == expect


def test_protein_pipeline_matches_cli_composition(tmp_path):
    """The FGSpp k-mer protein pipeline vs the composed CLI commands
    the reference pipes gene records through (umgap-analyse.sh:305-311:
    prot2kmer2lca -o | seedextend | uniq -d / | taxa2agg): identical
    per-read consensus taxa on random protein groups."""
    from umgap_tpu.cli import main as cli_main
    from umgap_tpu.pipeline import PRESETS
    from umgap_tpu.pipeline.proteins import analyse_protein_groups
    from umgap_tpu.taxonomy import Taxon, Taxonomy

    rng = np.random.default_rng(47)
    S = ranks.rank_index("superkingdom")
    SP = ranks.rank_index("species")
    taxa = [Taxon(1, "root", ranks.NO_RANK, 1, True),
            Taxon(2, "Bacteria", S, 1, True)]
    taxa += [Taxon(100 + i, f"sp{i}", SP, 2, True) for i in range(6)]
    tax = Taxonomy(taxa)
    taxfile = tmp_path / "t.tsv"
    taxfile.write_text("".join(
        f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t{t.parent}\t\x01\n"
        for t in taxa))

    aas = list("ACDEFGHIKLMNPQRSTVWY")
    prots = ["".join(rng.choice(aas, size=40)) for _ in range(24)]
    # index ~70% of all 9-mers, values among the species
    packed = np.unique(np.concatenate([
        kmerops.pack_kmers_host(encoding.encode_aa(p), 9) for p in prots]))
    keep = rng.random(len(packed)) < 0.7
    packed = packed[keep]
    values = rng.integers(100, 106, size=len(packed)).astype(np.int32)
    from umgap_tpu.index.table import KmerTable

    table = KmerTable.build(packed, values, k=9)
    idxfile = tmp_path / "nine.npz"
    table.save(idxfile)

    # gene records: 2 genes per read, FGSpp-style suffixed headers
    records = []
    for i in range(12):
        records.append((f"r{i}/1_1_99_+", prots[2 * i]))
        records.append((f"r{i}/2_1_99_-", prots[2 * i + 1]))
    cfg = PRESETS["high-precision"]

    def run_cli(argv, stdin):
        out = io.StringIO()
        rc = cli_main(argv, stdin=io.StringIO(stdin), stdout=out)
        assert rc == 0
        return out.getvalue()

    fasta_in = "".join(f">{h}\n{p}\n" for h, p in records)
    s = run_cli(["prot2kmer2lca", "-o", str(idxfile)], fasta_in)
    s = run_cli(["seedextend", f"-g{cfg.max_gap_size}",
                 f"-s{cfg.min_seed_size}"], s)
    s = run_cli(["uniq", "-d", "/"], s)
    s = run_cli(["taxa2agg", "-l", str(int(cfg.lower_bound)),
                 "-a", cfg.strategy, str(taxfile)], s)
    cli_out = {}
    for block in s.split(">")[1:]:
        ls = block.splitlines()
        cli_out[ls[0]] = int(ls[1])

    from umgap_tpu.fgspp import group_genes

    fused = dict(analyse_protein_groups(
        group_genes(records), tax, table, cfg, batch_size=8))
    assert fused == cli_out


def test_tryptic_protein_pipeline_matches_cli_composition(tmp_path):
    """The FGSpp tryptic protein path vs the composed CLI commands
    (umgap-analyse.sh:289-298: prot2tryp2lca -l9 -L45 | uniq -d / |
    taxa2agg -l1 -m rmq -a mrtl)."""
    from umgap_tpu.cli import main as cli_main
    from umgap_tpu.index.table import PeptideTable
    from umgap_tpu.pipeline import TRYPTIC_PRESETS
    from umgap_tpu.pipeline.proteins import analyse_tryptic_protein_groups
    from umgap_tpu.taxonomy import Taxon, Taxonomy

    rng = np.random.default_rng(53)
    S = ranks.rank_index("superkingdom")
    SP = ranks.rank_index("species")
    taxa = [Taxon(1, "root", ranks.NO_RANK, 1, True),
            Taxon(2, "Bacteria", S, 1, True)]
    taxa += [Taxon(100 + i, f"sp{i}", SP, 2, True) for i in range(6)]
    tax = Taxonomy(taxa)
    taxfile = tmp_path / "t.tsv"
    taxfile.write_text("".join(
        f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t{t.parent}\t\x01\n"
        for t in taxa))

    # K/R-rich proteins so the digest yields multiple 9-45aa fragments
    aas = list("ACDEFGHILMNQSTVWY") + ["K", "R"] * 3
    prots = ["".join(rng.choice(aas, size=60)) for _ in range(24)]
    frags = set()
    for p in prots:
        for f in kmerops.tryptic_digest(p):
            if 9 <= len(f) <= 45:
                frags.add(f)
    frags = sorted(frags)
    keep = rng.random(len(frags)) < 0.8
    frags = [f for f, k in zip(frags, keep) if k] or ["AAAAAAAAAK"]
    values = rng.integers(100, 106, size=len(frags)).astype(np.int32)
    ptable = PeptideTable.build(frags, values)
    idxfile = tmp_path / "tryp.npz"
    ptable.save(idxfile)

    records = []
    for i in range(12):
        records.append((f"r{i}/1_1_99_+", prots[2 * i]))
        records.append((f"r{i}/2_1_99_-", prots[2 * i + 1]))
    cfg = TRYPTIC_PRESETS["tryptic-sensitivity"]

    def run_cli(argv, stdin):
        out = io.StringIO()
        rc = cli_main(argv, stdin=io.StringIO(stdin), stdout=out)
        assert rc == 0
        return out.getvalue()

    fasta_in = "".join(f">{h}\n{p}\n" for h, p in records)
    s = run_cli(["prot2tryp2lca", "-l", "9", "-L", "45", str(idxfile)],
                fasta_in)
    s = run_cli(["uniq", "-d", "/"], s)
    s = run_cli(["taxa2agg", "-l", str(int(cfg.lower_bound)),
                 "-m", cfg.method, "-a", cfg.strategy, str(taxfile)], s)
    cli_out = {}
    for block in s.split(">")[1:]:
        ls = block.splitlines()
        cli_out[ls[0]] = int(ls[1])

    from umgap_tpu.fgspp import group_genes

    fused = dict(analyse_tryptic_protein_groups(
        group_genes(records), tax, ptable, cfg, batch_size=8))
    assert fused == cli_out
