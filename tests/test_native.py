"""Native host-runtime tests: C++ parser vs the Python IO layer."""

import os

import numpy as np
import pytest

from umgap_tpu.io import fastq, native
from umgap_tpu.ops import encoding, kmers

pytestmark = pytest.mark.skipif(
    not native.ensure_built(), reason="native library unavailable")

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "data", "A1.fq")


def test_parse_fastq_matches_python():
    headers, codes, lens = native.parse_fastq_file(TESTDATA, max_len=150)
    with open(TESTDATA) as f:
        py = list(fastq.read_records(f))
    assert len(headers) == len(py) == 100
    for i, rec in enumerate(py):
        assert headers[i] == rec.header
        assert lens[i] == len(rec.sequence)
        assert encoding.decode_dna(codes[i, : lens[i]]) == rec.sequence.replace(
            "a", "N")  # testdata is uppercase; identity check


def test_parse_fastq_clips_long_reads(tmp_path):
    p = tmp_path / "x.fq"
    p.write_text("@r1\n" + "ACGT" * 50 + "\n+\n" + "I" * 200 + "\n")
    headers, codes, lens = native.parse_fastq_file(str(p), max_len=100)
    assert lens[0] == 100
    assert headers == ["r1"]


def test_parse_fasta(tmp_path):
    p = tmp_path / "x.fa"
    p.write_text(">h1\nACGT\nGGGG\n>h2\nTTTT\n")
    headers, codes, lens = native.parse_fasta_file(str(p), max_len=50)
    assert headers == ["h1", "h2"]
    assert encoding.decode_dna(codes[0, : lens[0]]) == "ACGTGGGG"
    assert encoding.decode_dna(codes[1, : lens[1]]) == "TTTT"


def test_split_kmers_matches_python():
    tsv = b"12\tMNAKYDTDQGV\n34\tSHORT\n56\tKLMNPQRSTV\n"
    packed, tids = native.split_kmers_tsv(tsv, k=9)
    # python oracle
    expect = []
    for tid, seq in ((12, "MNAKYDTDQGV"), (34, "SHORT"), (56, "KLMNPQRSTV")):
        for p in kmers.pack_kmers_host(encoding.encode_aa(seq), 9):
            expect.append((int(p), tid))
    assert [(int(p), int(t)) for p, t in zip(packed, tids)] == expect


def test_multiline_fastq(tmp_path):
    p = tmp_path / "m.fq"
    p.write_text("@r1\nAC\nGT\n+\nII\nII\n@r2\nGGGG\n+\nIIII\n")
    headers, codes, lens = native.parse_fastq_file(str(p), max_len=50)
    assert headers == ["r1", "r2"]
    assert encoding.decode_dna(codes[0, : lens[0]]) == "ACGT"
    assert encoding.decode_dna(codes[1, : lens[1]]) == "GGGG"


def test_native_parser_fuzz_no_crash():
    """Adversarial bytes through the native parsers: never crash, never
    report more records than fit, headers always within the buffer."""
    rng = np.random.default_rng(59)
    corpus = []
    for _ in range(300):
        n = int(rng.integers(0, 400))
        corpus.append(bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))
    # structured-ish mutations too
    base = b"@r1\nACGT\n+\nIIII\n>f\nACGT\n"
    for _ in range(300):
        b = bytearray(base * int(rng.integers(1, 4)))
        for _ in range(int(rng.integers(0, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        corpus.append(bytes(b))
    for fn in ("umgap_parse_fastq", "umgap_parse_fasta"):
        for data in corpus:
            try:
                headers, codes, lens, tmax = native._parse(
                    fn, data, 64, 256)
            except ValueError:
                continue  # malformed: rejected, fine
            assert len(headers) <= 256
            assert (lens >= 0).all()
            assert tmax >= (lens.max() if len(lens) else 0)


def test_insert_bucketized_native_matches_numpy():
    """The native placement must be SLOT-IDENTICAL to the numpy oracle
    (artifact byte-parity depends on it): single-round with stash
    (bucket8s), 2-round distance-tagged (bucket16), unlimited-round
    dense, and the 3-payload peptide shape."""
    from umgap_tpu.index.table import _insert_bucketized

    rng = np.random.default_rng(61)
    cases = [
        # (n, cap, bucket, tag, max_round)
        (20000, 32768, 8, True, 0),      # bucket8s: 1 round + leftover
        (30000, 65536, 16, True, 1),     # bucket16: 2 rounds
        (20000, 24576, 8, True, None),   # dense: many rounds
        (15000, 32768, 8, False, 0),     # peptide-style, no tag
    ]
    for n, cap, bucket, tag, max_round in cases:
        nb = cap // bucket
        bucket0 = rng.integers(0, nb, size=n).astype(np.int64)
        p0 = rng.integers(0, 1 << 29, size=n).astype(np.int32)
        p1 = rng.integers(0, 1 << 30, size=n).astype(np.int32)
        p2 = rng.integers(0, 1 << 30, size=n).astype(np.int32)
        payloads = [p0, p1] if tag else [p0, p1, p2]
        a_outs, a_mp, a_left = _insert_bucketized(
            bucket0, payloads, cap, tag_distance=tag, bucket=bucket,
            max_round=max_round, use_native=False)
        b_outs, b_mp, b_left = _insert_bucketized(
            bucket0, payloads, cap, tag_distance=tag, bucket=bucket,
            max_round=max_round, use_native=True)
        assert a_mp == b_mp, (n, cap, bucket)
        assert list(a_left) == list(b_left)
        for ao, bo in zip(a_outs, b_outs):
            assert (ao == bo).all(), (n, cap, bucket, tag, max_round)


def test_insert_bucketized_capacity_exhausted_matches():
    from umgap_tpu.index.table import _insert_bucketized

    rng = np.random.default_rng(67)
    n, cap, bucket = 9000, 8192, 8  # > capacity: must raise in both
    bucket0 = rng.integers(0, cap // bucket, size=n).astype(np.int64)
    p0 = rng.integers(0, 1 << 29, size=n).astype(np.int32)
    for use_native in (False, True):
        with pytest.raises(RuntimeError):
            _insert_bucketized(bucket0, [p0], cap, bucket=bucket,
                               max_round=None, use_native=use_native)


def test_ensure_built_makes_only_the_library(monkeypatch):
    calls = []
    real_run = native.subprocess.run

    def run(argv, **kw):
        calls.append(argv)
        return real_run(argv, **kw)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", run)
    assert native.ensure_built()
    assert calls == [["make", "-C", native._NATIVE_DIR,
                      "libumgap_native.so"]]
