"""The persistent analyse service (--serve): hot compiled programs
across socket requests — the full-pipeline analogue of the reference's
socket index service."""

import io
import os
import socket
import threading
import time

import numpy as np
import pytest

from umgap_tpu.cli import main as cli_main
from umgap_tpu.index.table import KmerTable
from umgap_tpu.ops import encoding, kmers as kmerops

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "data")


@pytest.fixture
def world(tmp_path):
    taxfile = tmp_path / "taxons.tsv"
    taxfile.write_text(
        "1\troot\tno rank\t1\t\x01\n2\tBacteria\tsuperkingdom\t1\t\x01\n")
    with open(os.path.join(TESTDATA, "A1.fq")) as f:
        seq = f.read().splitlines()[1]
    from umgap_tpu.ops import translate as transmod

    pep = transmod.translate_sequence(seq, ["1"], encoding.get_table(1))[0]
    packed = np.unique(kmerops.pack_kmers_host(encoding.encode_aa(pep), 9))
    KmerTable.build(packed, np.full(len(packed), 2, np.int32),
                    k=9).save(tmp_path / "nine.npz")
    return str(taxfile), str(tmp_path / "nine.npz")


def _request(sock_path: str, line: str) -> str:
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            c = socket.socket(socket.AF_UNIX)
            c.connect(sock_path)
            break
        except (FileNotFoundError, ConnectionRefusedError):
            time.sleep(0.05)
    else:
        raise TimeoutError("service never came up")
    with c:
        c.sendall((line + "\n").encode())
        c.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = c.recv(65536)
            if not b:
                return b"".join(chunks).decode()
            chunks.append(b)


def test_analyse_service(world, tmp_path, monkeypatch):
    taxfile, idxfile = world
    sock = str(tmp_path / "svc.sock")

    import umgap_tpu.pipeline.runner as runner_mod

    calls = []
    orig = runner_mod.Analyser._make_step

    def counting(self, config, with_overflow):
        calls.append(config.name)
        return orig(self, config, with_overflow)

    monkeypatch.setattr(runner_mod.Analyser, "_make_step", counting)

    rc_box = {}

    def serve():
        rc_box["rc"] = cli_main(
            ["analyse", "--serve", sock,
             "--taxons", taxfile, "--index", idxfile,
             "--read-length", "150"],
            stdin=io.StringIO(""), stdout=io.StringIO())

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    # request 1: written to a file, reply 'ok <n>'
    out1 = tmp_path / "o1.fa"
    r = _request(sock, f"-t max-sensitivity -1 {TESTDATA}/A1.fq "
                       f"-2 {TESTDATA}/A2.fq -o {out1}")
    assert r.strip() == "ok 100", r
    assert out1.read_text().count(">") == 100

    # request 2 (same shape): served by the SAME compiled program
    out2 = tmp_path / "o2.fa"
    r = _request(sock, f"-t max-sensitivity -1 {TESTDATA}/A1.fq "
                       f"-2 {TESTDATA}/A2.fq -o {out2}")
    assert r.strip() == "ok 100", r
    assert out2.read_text() == out1.read_text()
    assert len(calls) == 1  # one trace/compile across both requests

    # request 3: no -o — the FASTA streams back over the socket
    r = _request(sock, f"-t max-sensitivity -1 {TESTDATA}/A1.fq "
                       f"-2 {TESTDATA}/A2.fq")
    assert r == out1.read_text()

    # a bad request reports an error but keeps the service alive
    r = _request(sock, "-t bogus-preset -1 nope.fq -o /dev/null")
    assert r.startswith("error") and "unknown preset" in r

    # a client that connects and closes without sending a line must
    # not wedge the single-threaded service
    c = socket.socket(socket.AF_UNIX)
    c.connect(sock)
    c.close()

    # a tryptic request against the pinned 9-mer index errors clearly
    # instead of silently emitting taxon 1 everywhere
    r = _request(sock, f"-t tryptic-sensitivity -1 {TESTDATA}/A1.fq "
                       f"-2 {TESTDATA}/A2.fq -o /dev/null")
    assert r.startswith("error") and "index" in r
    r = _request(sock, f"-t max-sensitivity -1 {TESTDATA}/A1.fq "
                       f"-2 {TESTDATA}/A2.fq -o {out2}")
    assert r.strip() == "ok 100"

    assert _request(sock, "quit").strip() == "bye"
    t.join(timeout=60)
    assert rc_box.get("rc") == 0
    assert not os.path.exists(sock)
