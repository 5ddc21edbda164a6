"""Streaming ingest + CLI fast-path tests: chunked native parse parity,
width-ladder growth, batch bucketing, cross-sample program reuse, and
the exotic-input fallbacks."""

import gzip
import io
import os

import numpy as np
import pytest

from umgap_tpu import ranks
from umgap_tpu.cli import main as cli_main
from umgap_tpu.index.table import KmerTable, PeptideTable
from umgap_tpu.io import native
from umgap_tpu.ops import encoding, kmers as kmerops
from umgap_tpu.taxonomy import Taxon, Taxonomy

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "data")

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


# ---------------------------------------------------------------------- #
# stream_parse parity
# ---------------------------------------------------------------------- #

def _cat_chunks(chunks):
    items = list(chunks)
    hs = [h for item in items for h in item[0]]
    w = max(item[1].shape[-1] for item in items)
    cs = [np.pad(item[1], ((0, 0), (0, w - item[1].shape[-1])),
                 constant_values=encoding.DNA_N) for item in items]
    return hs, np.concatenate(cs), np.concatenate([it[2] for it in items])


def test_stream_parse_fastq_matches_whole_file():
    whole_h, whole_c, whole_l = native.parse_fastq_file(
        os.path.join(TESTDATA, "A1.fq"), max_len=100)
    for chunk_bytes in (100, 1 << 10, 1 << 22):
        h, c, l = _cat_chunks(native.stream_parse(
            os.path.join(TESTDATA, "A1.fq"), "fastq", 100,
            chunk_bytes=chunk_bytes))
        assert h == whole_h
        assert (c == whole_c).all()
        assert (l == whole_l).all()


def test_stream_parse_fasta_matches_whole_file(tmp_path):
    recs = [(f"r{i}", "ACGT" * (i + 1)) for i in range(37)]
    p = tmp_path / "x.fa"
    p.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    whole_h, whole_c, whole_l = native.parse_fasta_file(str(p), max_len=200)
    for chunk_bytes in (64, 256, 1 << 20):
        h, c, l = _cat_chunks(native.stream_parse(
            str(p), "fasta", 200, chunk_bytes=chunk_bytes))
        assert h == whole_h
        assert (c == whole_c).all()
        assert (l == whole_l).all()


def test_stream_parse_gzip(tmp_path):
    with open(os.path.join(TESTDATA, "A1.fq"), "rb") as f:
        raw = f.read()
    p = tmp_path / "a.fq.gz"
    with gzip.open(p, "wb") as f:
        f.write(raw)
    whole = native.parse_fastq_file(os.path.join(TESTDATA, "A1.fq"), 100)
    h, c, l = _cat_chunks(native.stream_parse(str(p), "fastq", 100,
                                              chunk_bytes=777))
    assert h == whole[0]
    assert (c == whole[1]).all()


def test_stream_parse_width_ladder(tmp_path):
    """A long record mid-stream bumps the code width to the smallest
    ladder entry that fits; subsequent chunks stay wide."""
    p = tmp_path / "x.fa"
    seqs = ["A" * 50, "C" * 50, "G" * 300, "T" * 40]
    p.write_text("".join(f">{i}\n{s}\n" for i, s in enumerate(seqs)))
    chunks = list(native.stream_parse(str(p), "fasta", 100,
                                      chunk_bytes=60,
                                      width_ladder=[100, 256, 512]))
    widths = [c.shape[-1] for _h, c, _l, _t in chunks]
    assert widths[0] == 100
    assert max(widths) == 512
    # widths never shrink
    assert widths == sorted(widths)
    h, c, l = _cat_chunks(chunks)
    assert h == [str(i) for i in range(4)]
    assert list(l) == [50, 50, 300, 40]
    assert (c[2, :300] == encoding.encode_dna("G" * 300)).all()


def test_stream_parse_true_lengths_reported(tmp_path):
    """Records longer than max_len report clipped lens but a true_max
    that exposes the clipping (the old parser hid it)."""
    p = tmp_path / "x.fa"
    p.write_text(">a\n" + "A" * 70 + "\n>b\n" + "C" * 10 + "\n")
    (h, c, l, tmax), = list(native.stream_parse(str(p), "fasta", 32))
    assert list(l) == [32, 10]
    assert tmax == 70


def test_stream_parse_multiline_fastq_unsupported(tmp_path):
    p = tmp_path / "m.fq"
    p.write_text("@r1\nACGT\nACGT\n+\nIIII\nIIII\n@r2\nAC\n+\nII\n")
    with pytest.raises(native.StreamUnsupported):
        list(native.stream_parse(str(p), "fastq", 100))


# ---------------------------------------------------------------------- #
# CLI fast path
# ---------------------------------------------------------------------- #

@pytest.fixture
def world(tmp_path):
    S = ranks.rank_index("superkingdom")
    taxfile = tmp_path / "taxons.tsv"
    taxfile.write_text(
        "1\troot\tno rank\t1\t\x01\n2\tBacteria\tsuperkingdom\t1\t\x01\n")
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        seq = f.read().splitlines()[1]
    from umgap_tpu.ops import translate as transmod

    pep = transmod.translate_sequence(seq, ["1"], encoding.get_table(1))[0]
    packed = np.unique(kmerops.pack_kmers_host(encoding.encode_aa(pep), 9))
    table = KmerTable.build(packed, np.full(len(packed), 2, np.int32), k=9)
    idxfile = tmp_path / "nine.npz"
    table.save(idxfile)
    return str(taxfile), str(idxfile)


def _run_analyse(argv):
    out = io.StringIO()
    rc = cli_main(["analyse"] + argv, stdin=io.StringIO(""), stdout=out)
    assert rc == 0
    return out.getvalue()


def test_analyse_two_samples_compile_once(world, tmp_path, monkeypatch):
    """A two-sample run must construct (and therefore trace/compile)
    each (preset, batch, length) program exactly once."""
    import umgap_tpu.pipeline.runner as runner_mod

    calls = []
    orig = runner_mod.Analyser._make_step

    def counting(self, config, with_overflow):
        calls.append((config.name, self.batch_size, self.read_length,
                      with_overflow))
        return orig(self, config, with_overflow)

    monkeypatch.setattr(runner_mod.Analyser, "_make_step", counting)
    taxfile, idxfile = world
    o1, o2 = tmp_path / "o1.fa", tmp_path / "o2.fa"
    _run_analyse([
        "-t", "max-sensitivity",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"), "-o", str(o1),
        "-t", "max-sensitivity",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"), "-o", str(o2),
        "--taxons", taxfile, "--index", idxfile, "--read-length", "150"])
    assert o1.read_text() == o2.read_text()
    assert o1.read_text().count(">") == 100
    assert len(calls) == 1  # one fast program; no wide program needed


def test_analyse_batch_bucketing(world, monkeypatch):
    """Small samples run small power-of-two batches even with the big
    default --batch-size (no 16k pad for a 100-read sample)."""
    import umgap_tpu.pipeline.runner as runner_mod

    sizes = []
    orig = runner_mod.Analyser.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        sizes.append(self.batch_size)

    monkeypatch.setattr(runner_mod.Analyser, "__init__", spy)
    taxfile, idxfile = world
    text = _run_analyse([
        "-t", "max-sensitivity",
        "-1", os.path.join(TESTDATA, "A1.fq"),
        "-2", os.path.join(TESTDATA, "A2.fq"),
        "--taxons", taxfile, "--index", idxfile, "--read-length", "150"])
    assert text.count(">") == 100
    assert sizes == [128]  # 100 reads -> 128 bucket


def test_analyse_long_fasta_not_clipped(world, tmp_path):
    """A FASTA record longer than --read-length grows the width bucket:
    9-mers past the old 160bp clip are still found."""
    taxfile, idxfile = world
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        seq = f.read().splitlines()[1]  # 100bp, fully indexed in frame 1
    long_seq = ("ACT" * 60) + seq  # indexed part sits at 180..280
    fa = tmp_path / "long.fa"
    fa.write_text(f">L/1\n{long_seq}\n")
    text = _run_analyse([
        "-t", "max-sensitivity", "-1", str(fa),
        "--taxons", taxfile, "--index", idxfile])
    lines = text.strip().splitlines()
    assert lines[0] == ">L"
    assert lines[1] == "2"  # old silent clip would miss -> "1"


def test_analyse_multiline_fastq_falls_back(world, tmp_path):
    """Multi-line FASTQ records defeat chunked native parsing; the CLI
    must fall back to the Python reader and still answer correctly."""
    taxfile, idxfile = world
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        lines = f.read().splitlines()
    h, seq, q = lines[0], lines[1], lines[3]
    m1 = tmp_path / "m1.fq"
    m1.write_text(f"{h}\n{seq[:50]}\n{seq[50:]}\n+\n{q[:50]}\n{q[50:]}\n")
    m2 = tmp_path / "m2.fq"
    m2.write_text(f"{h.replace('/1', '/2')}\n{'A' * 100}\n+\n{'I' * 100}\n")
    text = _run_analyse([
        "-t", "max-sensitivity", "-1", str(m1), "-2", str(m2),
        "--taxons", taxfile, "--index", idxfile, "--read-length", "100"])
    lines = text.strip().splitlines()
    assert len(lines) == 2
    assert lines[1] == "2"


def test_analyse_gzip_paired(world, tmp_path):
    taxfile, idxfile = world
    outs = []
    for gz in (False, True):
        argv = ["-t", "max-sensitivity"]
        if gz:
            for name in ("A1.fq", "A2.fq"):
                with open(os.path.join(TESTDATA, name), "rb") as f:
                    data = f.read()
                with gzip.open(tmp_path / (name + ".gz"), "wb") as f:
                    f.write(data)
            argv += ["-1", str(tmp_path / "A1.fq.gz"),
                     "-2", str(tmp_path / "A2.fq.gz")]
        else:
            argv += ["-1", os.path.join(TESTDATA, "A1.fq"),
                     "-2", os.path.join(TESTDATA, "A2.fq")]
        argv += ["--taxons", taxfile, "--index", idxfile,
                 "--read-length", "100"]
        outs.append(_run_analyse(argv))
    assert outs[0] == outs[1]
    assert outs[0].count(">") == 100


def test_analyse_tryptic_long_record_host_fallback(world, tmp_path):
    """Tryptic presets re-route samples with records beyond
    --read-length through the host-digest path: a peptide landing past
    the device clip must still be found."""
    taxfile, _ = world
    # DNA encoding K + 10xA + K in frame 1, placed beyond 160bp
    pep_dna = "AAA" + "GCT" * 10 + "AAA"
    long_seq = "CCC" * 60 + pep_dna  # 180bp prefix
    fa = tmp_path / "t.fa"
    fa.write_text(f">T/1\n{long_seq}\n")
    # frame-1 digest of long_seq: P*60+K (61, dropped) then A*10+K (kept)
    tryp = PeptideTable.build(["AAAAAAAAAA" + "K"], np.array([2], np.int32))
    tfile = tmp_path / "tryp.npz"
    tryp.save(tfile)
    text = _run_analyse([
        "-t", "tryptic-sensitivity", "-1", str(fa),
        "--taxons", taxfile, "--index", str(tfile)])
    lines = text.strip().splitlines()
    assert lines[0] == ">T"
    assert lines[1] == "2"


def test_analyse_paired_zip_stops_at_shortest(world, tmp_path):
    """utils::Zip semantics through the native streaming path: a
    shorter second file truncates the sample at its length."""
    taxfile, idxfile = world
    with open(os.path.join(TESTDATA, "A2.fq")) as f:
        lines = f.read().splitlines()
    short = tmp_path / "A2short.fq"
    short.write_text("\n".join(lines[: 4 * 37]) + "\n")
    text = _run_analyse([
        "-t", "max-sensitivity",
        "-1", os.path.join(TESTDATA, "A1.fq"), "-2", str(short),
        "--taxons", taxfile, "--index", idxfile, "--read-length", "100"])
    assert text.count(">") == 37
