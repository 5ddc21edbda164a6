"""Golden-output parity: the umgap_tpu CLI vs the independent oracle.

Every test byte-compares a CLI invocation against a committed golden
file in tests/golden/expected/, generated by the oracle transliteration
of the reference Rust (tests/oracle/refimpl.py, see PARITY.md for why
the Rust binary itself cannot run here). Inputs are the reference's own
seeded paired read corpus (tests/golden/data/A1.fq+A2.fq, written by
tests/golden/gen.py) pushed through the full pipeline, with committed
synthetic taxonomy/indexes beside it.
"""

import io
import json
import os

import pytest

from umgap_tpu.cli import main

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(GOLDEN, "data")
EXPECTED = os.path.join(GOLDEN, "expected")
A1 = os.path.join(DATA, "A1.fq")
A2 = os.path.join(DATA, "A2.fq")
TAXONOMY = os.path.join(DATA, "taxonomy.tsv")


def golden(name: str) -> str:
    with open(os.path.join(EXPECTED, name + ".golden")) as f:
        return f.read()


def data(name: str) -> str:
    with open(os.path.join(DATA, name)) as f:
        return f.read()


class _BinOut(io.StringIO):
    """stdout stand-in exposing a .buffer for binary index output."""

    def __init__(self):
        super().__init__()
        self.buffer = io.BytesIO()


def run(argv, stdin=""):
    out = io.StringIO()
    rc = main(argv, stdin=io.StringIO(stdin), stdout=out)
    assert rc == 0, f"exit {rc} for {argv}"
    return out.getvalue()


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """Build .npz indexes from the committed TSVs via the CLI."""
    d = tmp_path_factory.mktemp("idx")
    paths = {}
    for name in ("ninemer", "tryptic"):
        out = _BinOut()
        rc = main(["buildindex"], stdin=io.StringIO(data(name + ".tsv")),
                  stdout=out)
        assert rc == 0
        p = d / f"{name}.npz"
        p.write_bytes(out.buffer.getvalue())
        paths[name] = str(p)
    return paths


# ---------------------------------------------------------------------- #
# stream commands
# ---------------------------------------------------------------------- #

def test_fastq2fasta():
    assert run(["fastq2fasta", A1, A2]) == golden("fastq2fasta")


def test_translate_all_frames():
    assert run(["translate", "-a"], golden("fastq2fasta")) == golden("translate_a")


def test_translate_frames_named_t11_m():
    out = run(["translate", "-f", "1", "-f", "2R", "-n", "-t", "11", "-m"],
              golden("fastq2fasta"))
    assert out == golden("translate_n_f1_f2R")


def test_translate_show_table():
    assert run(["translate", "-t", "11", "-s"]) == golden("translate_show_t11")


def test_prot2kmer():
    assert run(["prot2kmer"], golden("translate_a")) == golden("prot2kmer")


def test_prot2tryp():
    assert run(["prot2tryp"], golden("translate_a")) == golden("prot2tryp")


def test_filter_default():
    assert run(["filter"], golden("prot2tryp")) == golden("filter")


def test_filter_flags():
    out = run(["filter", "-m", "6", "-M", "40", "-c", "R", "-l", "C"],
              golden("prot2tryp"))
    assert out == golden("filter_c_l")


def test_filter_9_45():
    out = run(["filter", "-m", "9", "-M", "45"], golden("prot2tryp"))
    assert out == golden("filter_9_45")


# ---------------------------------------------------------------------- #
# lookups
# ---------------------------------------------------------------------- #

def test_prot2kmer2lca_one_on_one(indexes):
    out = run(["prot2kmer2lca", "-o", indexes["ninemer"]], golden("translate_a"))
    assert out == golden("prot2kmer2lca_o")


def test_prot2kmer2lca_drop_misses(indexes):
    out = run(["prot2kmer2lca", indexes["ninemer"]], golden("translate_a"))
    assert out == golden("prot2kmer2lca")


def test_pept2lca_kmers(indexes):
    out = run(["pept2lca", "-o", indexes["ninemer"]], golden("prot2kmer"))
    assert out == golden("pept2lca_kmers_o")


def test_pept2lca_tryptic(indexes):
    out = run(["pept2lca", indexes["tryptic"]], golden("filter_9_45"))
    assert out == golden("pept2lca_tryptic")


def test_prot2tryp2lca(indexes):
    out = run(["prot2tryp2lca", "-l", "9", "-L", "45", indexes["tryptic"]],
              golden("translate_a"))
    assert out == golden("prot2tryp2lca")


# ---------------------------------------------------------------------- #
# seedextend / uniq / bestof
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("s, name", [(2, "seedextend_g1_s2"),
                                     (3, "seedextend_g1_s3"),
                                     (4, "seedextend_g1_s4")])
def test_seedextend(s, name):
    out = run(["seedextend", "-g", "1", "-s", str(s)], golden("prot2kmer2lca_o"))
    assert out == golden(name)


def test_seedextend_default():
    out = run(["seedextend"], golden("prot2kmer2lca_o"))
    assert out == golden("seedextend_default")


def test_seedextend_ranked():
    out = run(["seedextend", "-g", "1", "-s", "2", "-r", TAXONOMY],
              golden("prot2kmer2lca_o"))
    assert out == golden("seedextend_ranked")


def test_uniq():
    out = run(["uniq", "-d", "/"], golden("seedextend_g1_s3"))
    assert out == golden("uniq_d")


def test_uniq_separator_wrap():
    out = run(["uniq", "-s", " ", "-w", "-d", "/"], golden("seedextend_g1_s3"))
    assert out == golden("uniq_sep_wrap")


def test_bestof():
    assert run(["bestof"], golden("prot2kmer2lca_o")) == golden("bestof")


# ---------------------------------------------------------------------- #
# aggregation
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name, flags", [
    ("taxa2agg_rmq_mrtl", ["-m", "rmq", "-a", "mrtl"]),
    ("taxa2agg_rmq_lca", ["-m", "rmq", "-a", "lca*"]),
    ("taxa2agg_rmq_hybrid", ["-m", "rmq", "-a", "hybrid", "-f", "0.25"]),
    ("taxa2agg_tree_lca", ["-m", "tree", "-a", "lca*"]),
    ("taxa2agg_tree_hybrid", ["-m", "tree", "-a", "hybrid", "-f", "0.25"]),
])
def test_taxa2agg(name, flags):
    out = run(["taxa2agg", "-l", "1", *flags, TAXONOMY], golden("uniq_d"))
    assert out == golden(name)


def test_taxa2agg_ranked_l2():
    out = run(["taxa2agg", "-r", "-l", "2", "-m", "tree", "-a", "lca*",
               TAXONOMY], golden("uniq_d"))
    assert out == golden("taxa2agg_ranked_l2")


def test_taxa2agg_scored():
    out = run(["taxa2agg", "-s", "-l", "0.5", TAXONOMY],
              data("taxa2agg_scored_input.fa"))
    assert out == golden("taxa2agg_scored")


# ---------------------------------------------------------------------- #
# reporting
# ---------------------------------------------------------------------- #

def test_taxa2freq_species():
    out = run(["taxa2freq", TAXONOMY], data("hs_taxa.txt"))
    assert out == golden("taxa2freq_species")


def test_taxa2freq_phylum():
    out = run(["taxa2freq", "-r", "phylum", "-f", "0", TAXONOMY],
              data("hs_taxa.txt"))
    assert out == golden("taxa2freq_phylum_f0")


def test_taxa2freq_two_files(tmp_path, monkeypatch):
    (tmp_path / "a.txt").write_text(data("hs_taxa.txt"))
    (tmp_path / "b.txt").write_text(data("hs_taxa.txt"))
    monkeypatch.chdir(tmp_path)
    out = run(["taxa2freq", "-r", "family", TAXONOMY, "a.txt", "b.txt"])
    assert out == golden("taxa2freq_two_files")


def test_snaptaxon_family():
    out = run(["snaptaxon", "-r", "family", TAXONOMY], data("hs_taxa.txt"))
    assert out == golden("snaptaxon_family")


def test_snaptaxon_taxa():
    taxa = sorted({int(l) for l in data("hs_taxa.txt").split() if l != "1"})[:3]
    argv = ["snaptaxon", "-i"]
    for t in taxa:
        argv += ["-t", str(t)]
    out = run(argv + [TAXONOMY], golden("pipeline_high_sensitivity"))
    assert out == golden("snaptaxon_taxa")


def test_taxonomy_cmd():
    out = run(["taxonomy", TAXONOMY], data("hs_taxa.txt"))
    assert out == golden("taxonomy")


def test_taxonomy_all_ranks_no_header():
    out = run(["taxonomy", "-a", "-H", TAXONOMY], data("hs_taxa.txt"))
    assert out == golden("taxonomy_a_H")


def test_taxa2tree_payload(monkeypatch):
    captured = {}

    class FakeResponse:
        def read(self):
            return b"<html></html>"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(req, timeout=None):
        captured["payload"] = json.loads(req.data.decode())
        return FakeResponse()

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    run(["taxa2tree"], golden("pipeline_high_sensitivity"))
    assert captured["payload"] == json.loads(golden("taxa2tree_payload"))


# ---------------------------------------------------------------------- #
# index build
# ---------------------------------------------------------------------- #

def test_splitkmers():
    assert run(["splitkmers"], data("proteins.tsv")) == golden("splitkmers")


def test_splitkmers_prefix():
    out = run(["splitkmers", "-p", "A"], data("proteins.tsv"))
    assert out == golden("splitkmers_p")


def test_joinkmers():
    sorted_rows = "".join(sorted(golden("splitkmers").splitlines(keepends=True)))
    assert run(["joinkmers", TAXONOMY], sorted_rows) == golden("joinkmers")


def test_buildindex_printindex_roundtrip(tmp_path):
    rows = "".join(
        "\t".join(line.split("\t")[:2]) + "\n"
        for line in golden("joinkmers").splitlines()
    )
    out = _BinOut()
    rc = main(["buildindex"], stdin=io.StringIO(rows), stdout=out)
    assert rc == 0
    p = tmp_path / "t.npz"
    p.write_bytes(out.buffer.getvalue())
    assert run(["printindex", str(p)]) == golden("printindex_roundtrip")


# ---------------------------------------------------------------------- #
# the six preset pipelines, composed from CLI commands
# ---------------------------------------------------------------------- #

def _ninemer_pipeline(indexes, s, l, method, strategy):
    x = run(["fastq2fasta", A1, A2])
    x = run(["translate", "-a"], x)
    x = run(["prot2kmer2lca", "-o", indexes["ninemer"]], x)
    x = run(["seedextend", "-g", "1", "-s", str(s)], x)
    x = run(["uniq", "-d", "/"], x)
    return run(["taxa2agg", "-l", str(l), "-m", method, "-a", strategy,
                TAXONOMY], x)


def _tryptic_pipeline(indexes, l):
    x = run(["fastq2fasta", A1, A2])
    x = run(["translate", "-a"], x)
    x = run(["prot2tryp2lca", "-l", "9", "-L", "45", indexes["tryptic"]], x)
    x = run(["uniq", "-d", "/"], x)
    return run(["taxa2agg", "-l", str(l), "-m", "rmq", "-a", "mrtl",
                TAXONOMY], x)


@pytest.mark.parametrize("name, s, l, method, strategy", [
    ("pipeline_max_sensitivity", 2, 1, "rmq", "mrtl"),
    ("pipeline_high_sensitivity", 3, 1, "tree", "hybrid"),
    ("pipeline_high_precision", 3, 2, "tree", "lca*"),
    ("pipeline_max_precision", 4, 5, "tree", "lca*"),
])
def test_ninemer_pipelines(indexes, name, s, l, method, strategy):
    assert _ninemer_pipeline(indexes, s, l, method, strategy) == golden(name)


@pytest.mark.parametrize("name, l", [
    ("pipeline_tryptic_sensitivity", 1),
    ("pipeline_tryptic_precision", 5),
])
def test_tryptic_pipelines(indexes, name, l):
    assert _tryptic_pipeline(indexes, l) == golden(name)


# ---------------------------------------------------------------------- #
# the fused `analyse` command against the same goldens
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("preset, name", [
    ("max-sensitivity", "pipeline_max_sensitivity"),
    ("high-sensitivity", "pipeline_high_sensitivity"),
    ("high-precision", "pipeline_high_precision"),
    ("max-precision", "pipeline_max_precision"),
    ("tryptic-sensitivity", "pipeline_tryptic_sensitivity"),
    ("tryptic-precision", "pipeline_tryptic_precision"),
])
def test_analyse_fused_matches_golden(indexes, preset, name):
    key = "tryptic" if preset.startswith("tryptic") else "ninemer"
    out = run(["analyse", "-t", preset, "-1", A1, "-2", A2,
               "--taxons", TAXONOMY, "--index", indexes[key]])
    assert out == golden(name)
