"""Config-dir layer: setup, version discovery, visualize, gzip ingest
(umgap-setup.sh / umgap-visualize.sh equivalents, VERDICT item 8)."""

import gzip
import io
import json
import os

import numpy as np
import pytest

from umgap_tpu import configdir as cfg
from umgap_tpu.cli import main


def run(argv, stdin=""):
    out = io.StringIO()
    rc = main(argv, stdin=io.StringIO(stdin), stdout=out)
    return rc, out.getvalue()


FIXTURE_TSV = (
    "1\troot\tno rank\t1\t\x01\n"
    "2\tBacteria\tsuperkingdom\t1\t\x01\n"
    "12884\tViroids\tsuperkingdom\t1\t\x01\n"
    "185751\tPospiviroidae\tfamily\t12884\t\x01\n"
)


def test_xdg_discovery(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    assert cfg.default_config_dir() == str(tmp_path / "cfg" / "unipept")
    assert cfg.default_data_dir() == str(tmp_path / "data" / "unipept")


def test_setup_local_install_and_discovery(tmp_path):
    conf = tmp_path / "conf"
    data = tmp_path / "data"
    src = tmp_path / "taxons.tsv"
    src.write_text(FIXTURE_TSV)

    rc, out = run(["setup", "-c", str(conf), "-d", str(data),
                   "-v", "2026-08", "--taxons", str(src)])
    assert rc == 0
    link = conf / "2026-08" / "taxons.tsv"
    assert link.is_symlink()
    assert link.read_text() == FIXTURE_TSV
    assert (data / "2026-08" / "taxons.tsv").exists()
    assert "taxons.tsv (2026-08): available" in out
    assert "tryptic.npz (2026-08): missing" in out

    # discovery: taxonomy-only version found; index-requiring discovery fails
    assert cfg.discover_version(str(conf)) == "2026-08"
    assert cfg.discover_version(str(conf), ninemer=True) is None

    # newer complete version wins
    idx = tmp_path / "n.npz"
    idx.write_bytes(b"dummy")
    rc, _ = run(["setup", "-c", str(conf), "-d", str(data), "-v", "2027-01",
                 "--taxons", str(src), "--ninemer", str(idx),
                 "--tryptic", str(idx)])
    assert rc == 0
    assert cfg.discover_version(str(conf), ninemer=True) == "2027-01"
    assert cfg.discover_version(str(conf)) == "2027-01"


def test_setup_local_requires_version(tmp_path):
    src = tmp_path / "t.tsv"
    src.write_text(FIXTURE_TSV)
    rc, _ = run(["setup", "-c", str(tmp_path / "c"), "-d", str(tmp_path / "d"),
                 "--taxons", str(src)])
    assert rc != 0


def test_visualize_csv(tmp_path):
    conf = tmp_path / "conf"
    data = tmp_path / "data"
    src = tmp_path / "taxons.tsv"
    src.write_text(FIXTURE_TSV)
    run(["setup", "-c", str(conf), "-d", str(data), "-v", "1",
         "--taxons", str(src)])

    sample = tmp_path / "sub" / "sample1.txt"
    sample.parent.mkdir()
    sample.write_text("185751\n185751\n12884\n")
    rc, out = run(["visualize", "-t", "family", "-c", str(conf),
                   str(sample)])
    assert rc == 0
    lines = out.splitlines()
    # directory prefix stripped from the header column
    assert lines[0] == "taxon id,taxon name,sample1.txt"
    assert "185751,Pospiviroidae,2" in lines


def test_visualize_csv_gzipped_input(tmp_path):
    src = tmp_path / "taxons.tsv"
    src.write_text(FIXTURE_TSV)
    sample = tmp_path / "s.txt.gz"
    with gzip.open(sample, "wt") as f:
        f.write("185751\n185751\n")
    rc, out = run(["visualize", "-t", "family", "--taxons", str(src),
                   str(sample)])
    assert rc == 0
    assert "185751,Pospiviroidae,2" in out


def test_visualize_url_payload(tmp_path, monkeypatch):
    captured = {}

    class FakeRes:
        def read(self):
            return json.dumps({"gist": "https://gist.github.com/abc"}).encode()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(req, timeout=None):
        captured["payload"] = json.loads(req.data.decode())
        return FakeRes()

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    sample = tmp_path / "in.fa"
    sample.write_text(">h\n12884\n")
    rc, out = run(["visualize", "-u", str(sample)])
    assert rc == 0
    assert out.strip() == "https://bl.ocks.org/abc"
    assert captured["payload"]["counts"] == {"12884": 1}


def test_analyse_gzip_and_configdir(tmp_path):
    """analyse with gzipped FASTQ and config-dir data discovery."""
    pytest.importorskip("jax")
    import io as iomod

    from tests.test_golden import DATA, A1, A2, data

    class _BinOut(iomod.StringIO):
        def __init__(self):
            super().__init__()
            self.buffer = iomod.BytesIO()

    out = _BinOut()
    rc = main(["buildindex"], stdin=iomod.StringIO(data("ninemer.tsv")),
              stdout=out)
    assert rc == 0
    idx = tmp_path / "ninemer.npz"
    idx.write_bytes(out.buffer.getvalue())

    conf = tmp_path / "conf"
    run(["setup", "-c", str(conf), "-d", str(tmp_path / "dat"), "-v", "1",
         "--taxons", os.path.join(DATA, "taxonomy.tsv"),
         "--ninemer", str(idx)])

    # gzip the fastq inputs
    gz1 = tmp_path / "A1.fq.gz"
    gz2 = tmp_path / "A2.fq.gz"
    for src_path, dst in ((A1, gz1), (A2, gz2)):
        with open(src_path, "rb") as fsrc, gzip.open(dst, "wb") as fdst:
            fdst.write(fsrc.read())

    rc, got = run(["analyse", "-t", "high-sensitivity", "-1", str(gz1),
                   "-2", str(gz2), "-c", str(conf)])
    assert rc == 0
    with open(os.path.join(os.path.dirname(DATA), "expected",
                           "pipeline_high_sensitivity.golden")) as f:
        assert got == f.read()


def test_analyse_multi_sample(tmp_path):
    """umgap-analyse.sh multi-sample mode: repeated -1/-2/-t/-z/-o
    groups sharing loaded indexes; single-end FASTA input; gzip output."""
    import io as iomod

    from tests.test_golden import DATA, A1, A2, data, golden

    class _BinOut(iomod.StringIO):
        def __init__(self):
            super().__init__()
            self.buffer = iomod.BytesIO()

    out = _BinOut()
    rc = main(["buildindex"], stdin=iomod.StringIO(data("ninemer.tsv")),
              stdout=out)
    assert rc == 0
    idx = tmp_path / "ninemer.npz"
    idx.write_bytes(out.buffer.getvalue())
    tx = os.path.join(DATA, "taxonomy.tsv")

    out1 = tmp_path / "s1.fa"
    out2gz = tmp_path / "s2.fa.gz"
    rc, text = run([
        "analyse", "--taxons", tx, "--index", str(idx),
        "--batch-size", "32", "--read-length", "100",
        "-t", "high-sensitivity", "-1", A1, "-2", A2, "-o", str(out1),
        "-t", "max-sensitivity", "-1", A1, "-2", A2, "-z", "-o", str(out2gz),
    ])
    assert rc == 0
    assert out1.read_text() == golden("pipeline_high_sensitivity")
    with gzip.open(out2gz, "rt") as f:
        assert f.read() == golden("pipeline_max_sensitivity")

    # single-end FASTA form (the script's one-file mode): 100 records
    fasta_in = tmp_path / "reads.fa"
    # derive a FASTA from A1 only
    rc, fa = run(["fastq2fasta", A1])
    fasta_in.write_text(fa)
    rc, text = run(["analyse", "--taxons", tx, "--index", str(idx),
                    "--batch-size", "32", "--read-length", "100",
                    "-t", "max-sensitivity", "-1", str(fasta_in)])
    assert rc == 0
    assert text.count(">") == 100
