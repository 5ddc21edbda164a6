"""Golden-corpus generator for the parity harness.

Deterministically builds (seeded, no wall-clock or machine dependence):

* ``data/taxonomy.tsv``  — a ~2.5k-node synthetic NCBI-style taxonomy
  (ranked chains superkingdom..strain, "no rank" intermediates, ~8%
  invalid nodes, sparse ids).
* ``data/A1.fq`` + ``data/A2.fq`` — the paired read corpus: 100 pairs,
  each reading both ends of its own random fragment, 100-150 bp
  per end, a few ends short (< 60 bp) and a few holding ``N``. Records
  are single-line, so the corpus runs the native streaming ingest;
  multi-line FASTQ cases are written by the tests that exercise them.
* ``data/ninemer.tsv``   — a 9-mer -> taxid index derived from that
  corpus: each
  read pair is assigned a ground-truth species; ~60% of the 9-mers of
  one deterministic "coding frame" per read map to that species (or an
  ancestor, to exercise snapping), other frames contribute ~5% noise.
* ``data/tryptic.tsv``   — the same construction for tryptic peptides.
* ``expected/*.golden``  — byte-exact outputs of every reference
  command and all six preset pipelines (scripts/umgap-analyse.sh:276-311,
  with ``translate -a`` standing in for FGSpp on the tryptic configs, as
  the parity plan prescribes for an FGSpp-less environment), computed by
  the independent oracle in tests/oracle/refimpl.py.

Run from the repo root:  python tests/golden/gen.py
The outputs are committed; tests/test_golden.py never regenerates them.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from tests.oracle import refimpl as R  # noqa: E402

DATA = os.path.join(HERE, "data")
EXPECTED = os.path.join(HERE, "expected")

SEED = 20260820


# ---------------------------------------------------------------------- #
# synthetic taxonomy
# ---------------------------------------------------------------------- #

def build_taxonomy():
    rng = np.random.default_rng(SEED)
    chain = ["superkingdom", "phylum", "class", "order", "family",
             "genus", "species", "strain"]
    fanout = {"superkingdom": 3, "phylum": 3, "class": 2, "order": 2,
              "family": 2, "genus": 3, "species": 4, "strain": 0}

    used = {0, 1}

    def fresh_id():
        while True:
            i = int(rng.integers(2, 1_000_000))
            if i not in used:
                used.add(i)
                return i

    rows = [(1, "root", "no rank", 1, True)]

    def grow(parent: int, level: int):
        if level >= len(chain):
            return
        rank = chain[level]
        n = fanout[chain[level - 1]] if level > 0 else 3
        for _ in range(n):
            tid = fresh_id()
            valid = bool(rng.random() > 0.08)
            # ~10% of nodes get a "no rank" intermediate parent first
            attach = parent
            if rng.random() < 0.10:
                mid = fresh_id()
                rows.append((mid, f"clade {mid}", "no rank", parent,
                             bool(rng.random() > 0.2)))
                attach = mid
            rows.append((tid, f"{rank.capitalize()} {tid}", rank, attach, valid))
            if rank == "species" and rng.random() < 0.25:
                sid = fresh_id()
                rows.append((sid, f"Strain {sid}", "strain", tid, True))
            grow(tid, level + 1)

    grow(1, 0)
    rows.sort(key=lambda r: r[0])
    return rows


def taxonomy_tsv(rows) -> str:
    return "".join(
        f"{tid}\t{name}\t{rank}\t{parent}\t" + ("\x01" if valid else "\x00") + "\n"
        for tid, name, rank, parent, valid in rows
    )


# ---------------------------------------------------------------------- #
# index construction from the test corpus
# ---------------------------------------------------------------------- #

N_PAIRS = 100


def _fastq_record(rng, header: str, seq: str) -> str:
    qual = "".join("#" if c == "N" else chr(33 + int(q))
                   for c, q in zip(seq, rng.integers(2, 41, len(seq))))
    return f"@{header}\n{seq}\n+\n{qual}\n"


def build_reads():
    """The paired FASTQ corpus as (A1 text, A2 text)."""
    rng = np.random.default_rng(SEED + 3)
    a1, a2 = [], []
    for i in range(N_PAIRS):
        # each pair reads both ends of its own random fragment, so the
        # planted per-pair truth is not blurred by shared sequence
        frag_len = int(rng.integers(250, 450))
        frag = "".join("ACGT"[c] for c in rng.integers(0, 4, frag_len))
        ends = [frag, R.reverse_complement(frag)]
        if i == 0:
            lens = [100, 100]  # tests index this clean 100 bp first read
        else:
            lens = [int(rng.integers(100, 151)) for _ in ends]
            if i % 16 == 7:
                lens[int(rng.integers(0, 2))] = int(rng.integers(20, 60))
        seqs = [e[:n] for e, n in zip(ends, lens)]
        if i % 11 == 5:
            which = int(rng.integers(0, 2))
            seq = list(seqs[which])
            for pos in rng.integers(0, len(seq), int(rng.integers(1, 4))):
                seq[int(pos)] = "N"
            seqs[which] = "".join(seq)
        a1.append(_fastq_record(rng, f"sim{i + 1:03d}/1", seqs[0]))
        a2.append(_fastq_record(rng, f"sim{i + 1:03d}/2", seqs[1]))
    return "".join(a1), "".join(a2)


def read_fastq_file(path):
    with open(path) as f:
        return R.read_fastq(f.read())


def build_indexes(taxa_rows):
    rng = np.random.default_rng(SEED + 1)
    by_rank = {}
    for tid, _n, rank, _p, valid in taxa_rows:
        if valid:
            by_rank.setdefault(rank, []).append(tid)
    species = by_rank["species"]
    genera = by_rank["genus"]
    parent_of = {tid: p for tid, _n, _r, p, _v in taxa_rows}
    all_valid = [tid for tid, _n, _r, _p, v in taxa_rows if v and tid != 1]

    a1 = read_fastq_file(os.path.join(DATA, "A1.fq"))
    a2 = read_fastq_file(os.path.join(DATA, "A2.fq"))
    tt = R.TranslationTable(1)

    ninemer = {}
    tryptic = {}
    pat = __import__("re").compile("([KR])([^P])")

    def ancestors(tid):
        out = []
        cur = tid
        while parent_of.get(cur, cur) != cur:
            cur = parent_of[cur]
            out.append(cur)
        return out

    truth = []
    for pair_idx, (r1, r2) in enumerate(zip(a1, a2)):
        sp = int(species[int(rng.integers(0, len(species)))])
        anc = [a for a in ancestors(sp) if a != 1]
        # ~8% of pairs are "unknown": their k-mers map only to noise
        known = rng.random() > 0.08
        header = r1[0].split("/")[0]
        truth.append((header, sp if known else 0))
        for end_idx, (_h, seq, _q) in enumerate((r1, r2)):
            fwd = R.to_strand(seq)
            rev = R.reverse_complement(fwd)
            coding = int(rng.integers(0, 6))
            for frame_idx in range(6):
                strand = rev if frame_idx >= 3 else fwd
                off = frame_idx % 3
                prot = tt.translate_frame(False, strand[off:])
                is_coding = known and frame_idx == coding
                # 9-mers
                for i in range(max(0, len(prot) - 8)):
                    kmer = prot[i : i + 9]
                    if "*" in kmer or "-" in kmer:
                        continue
                    if is_coding:
                        if rng.random() < 0.60:
                            u = rng.random()
                            if u < 0.70 or not anc:
                                tid = sp
                            elif u < 0.90:
                                tid = anc[0]
                            else:
                                tid = int(anc[int(rng.integers(0, len(anc)))])
                            ninemer.setdefault(kmer, tid)
                    elif rng.random() < 0.05:
                        tid = int(all_valid[int(rng.integers(0, len(all_valid)))])
                        ninemer.setdefault(kmer, tid)
                # tryptic peptides
                for pep in R._tryp_digest(prot, pat):
                    if not (5 <= len(pep) <= 50) or "-" in pep:
                        continue
                    if is_coding:
                        if rng.random() < 0.80:
                            tryptic.setdefault(pep, sp)
                    elif rng.random() < 0.05:
                        tid = int(all_valid[int(rng.integers(0, len(all_valid)))])
                        tryptic.setdefault(pep, tid)

    return ninemer, tryptic, truth


def index_tsv(index) -> str:
    return "".join(f"{k}\t{v}\n" for k, v in sorted(index.items()))


# ---------------------------------------------------------------------- #
# golden outputs
# ---------------------------------------------------------------------- #

# the 9-mer presets of scripts/umgap-analyse.sh:276-288 as
# (seedextend -s, taxa2agg -l, -m, -a, -f)
NINEMER_PRESETS = {
    "max-sensitivity": (2, 1, "rmq", "mrtl", 0.25),
    "high-sensitivity": (3, 1, "tree", "hybrid", 0.25),
    "high-precision": (3, 2, "tree", "lca*", 0.25),
    "max-precision": (4, 5, "tree", "lca*", 0.25),
}


def ninemer_pipeline(translated: str, ninemer: dict, tax_tsv: str,
                     preset: str) -> str:
    """The oracle composition of a 9-mer preset over ``translate -a``
    output: prot2kmer2lca -o | seedextend -g 1 | uniq -d / | taxa2agg."""
    s, l, method, strategy, factor = NINEMER_PRESETS[preset]
    x = R.prot2kmer2lca(translated, ninemer, one_on_one=True)
    x = R.seedextend(x, min_seed_size=s, max_gap_size=1)
    x = R.uniq(x, delimiter="/")
    return R.taxa2agg(x, tax_tsv, lower_bound=l, method=method,
                      strategy=strategy, factor=factor)


def main():
    os.makedirs(DATA, exist_ok=True)
    os.makedirs(EXPECTED, exist_ok=True)

    a1_text, a2_text = build_reads()
    for name, text in (("A1.fq", a1_text), ("A2.fq", a2_text)):
        with open(os.path.join(DATA, name), "w") as f:
            f.write(text)

    taxa_rows = build_taxonomy()
    tax_tsv = taxonomy_tsv(taxa_rows)
    with open(os.path.join(DATA, "taxonomy.tsv"), "w") as f:
        f.write(tax_tsv)

    ninemer, tryptic, truth = build_indexes(taxa_rows)
    with open(os.path.join(DATA, "ninemer.tsv"), "w") as f:
        f.write(index_tsv(ninemer))
    with open(os.path.join(DATA, "tryptic.tsv"), "w") as f:
        f.write(index_tsv(tryptic))
    # planted ground truth per pair (0 = noise-only pair), for the
    # accuracy assertions in tests/test_analyse_cmd.py
    with open(os.path.join(DATA, "ground_truth.tsv"), "w") as f:
        f.write("".join(f"{h}\t{sp}\n" for h, sp in truth))
    print(f"taxonomy: {len(taxa_rows)} nodes; ninemer: {len(ninemer)} keys; "
          f"tryptic: {len(tryptic)} keys")

    golden = {}

    # ---- stream commands ------------------------------------------- #
    interleaved = R.fastq2fasta([a1_text, a2_text])
    golden["fastq2fasta"] = interleaved

    translated = R.translate(interleaved, all_frames=True)
    golden["translate_a"] = translated
    golden["translate_n_f1_f2R"] = R.translate(
        interleaved, frames=["1", "2R"], append_name=True, table="11",
        methionine=True)
    golden["translate_show_t11"] = R.translate("", table="11", show_table=True)

    golden["prot2kmer"] = R.prot2kmer(translated)
    golden["prot2tryp"] = R.prot2tryp(translated)
    golden["filter"] = R.filter_cmd(R.prot2tryp(translated))
    golden["filter_c_l"] = R.filter_cmd(R.prot2tryp(translated), min_length=6,
                                        max_length=40, contains="R", lacks="C")

    # ---- lookups ---------------------------------------------------- #
    p2k2lca_o = R.prot2kmer2lca(translated, ninemer, one_on_one=True)
    golden["prot2kmer2lca_o"] = p2k2lca_o
    golden["prot2kmer2lca"] = R.prot2kmer2lca(translated, ninemer)
    kmers_stream = R.prot2kmer(translated)
    golden["pept2lca_kmers_o"] = R.pept2lca(kmers_stream, ninemer, one_on_one=True)
    tryp_stream = R.filter_cmd(R.prot2tryp(translated), min_length=9, max_length=45)
    golden["filter_9_45"] = tryp_stream
    golden["pept2lca_tryptic"] = R.pept2lca(tryp_stream, tryptic)
    p2t2lca = R.prot2tryp2lca(translated, tryptic, min_length=9, max_length=45)
    golden["prot2tryp2lca"] = p2t2lca

    # ---- seedextend / uniq / bestof --------------------------------- #
    golden["seedextend_g1_s2"] = R.seedextend(p2k2lca_o, 2, 1)
    se3 = R.seedextend(p2k2lca_o, 3, 1)
    golden["seedextend_g1_s3"] = se3
    golden["seedextend_g1_s4"] = R.seedextend(p2k2lca_o, 4, 1)
    golden["seedextend_default"] = R.seedextend(p2k2lca_o)
    golden["seedextend_ranked"] = R.seedextend(p2k2lca_o, 2, 1, ranked=tax_tsv,
                                               penalty=5)
    uniq3 = R.uniq(se3, delimiter="/")
    golden["uniq_d"] = uniq3
    golden["uniq_sep_wrap"] = R.uniq(se3, separator=" ", wrap=True, delimiter="/")
    golden["bestof"] = R.bestof(p2k2lca_o)

    # ---- aggregation ------------------------------------------------ #
    for name, kw in [
        ("rmq_mrtl", dict(method="rmq", strategy="mrtl")),
        ("rmq_lca", dict(method="rmq", strategy="lca*")),
        ("rmq_hybrid", dict(method="rmq", strategy="hybrid", factor=0.25)),
        ("tree_lca", dict(method="tree", strategy="lca*")),
        ("tree_hybrid", dict(method="tree", strategy="hybrid", factor=0.25)),
    ]:
        golden[f"taxa2agg_{name}"] = R.taxa2agg(uniq3, tax_tsv, lower_bound=1,
                                                **kw)
    golden["taxa2agg_ranked_l2"] = R.taxa2agg(uniq3, tax_tsv, ranked_only=True,
                                              lower_bound=2, method="tree",
                                              strategy="lca*")
    # scored input variant
    scored_in = []
    for header, seq in R.read_fasta(uniq3, unwrap=False):
        items = [f"{t}=0.{(i % 9) + 1}" for i, t in enumerate(seq)]
        R.write_fasta_record(scored_in, header, items)
    scored_in = "".join(scored_in)
    with open(os.path.join(DATA, "taxa2agg_scored_input.fa"), "w") as f:
        f.write(scored_in)
    golden["taxa2agg_scored"] = R.taxa2agg(scored_in, tax_tsv,
                                           scored=True, lower_bound=0.5)

    # ---- pipelines (scripts/umgap-analyse.sh:276-311) --------------- #
    for preset in NINEMER_PRESETS:
        golden["pipeline_" + preset.replace("-", "_")] = ninemer_pipeline(
            translated, ninemer, tax_tsv, preset)

    def tryptic_pipeline(l):
        x = R.prot2tryp2lca(translated, tryptic, min_length=9, max_length=45)
        x = R.uniq(x, delimiter="/")
        return R.taxa2agg(x, tax_tsv, lower_bound=l, method="rmq",
                          strategy="mrtl")

    golden["pipeline_tryptic_sensitivity"] = tryptic_pipeline(1)
    golden["pipeline_tryptic_precision"] = tryptic_pipeline(5)

    # ---- reporting -------------------------------------------------- #
    hs = golden["pipeline_high_sensitivity"]
    taxa_lines = "".join(
        f"{seq[0]}\n" for _h, seq in R.read_fasta(hs, unwrap=False)
    )
    with open(os.path.join(DATA, "hs_taxa.txt"), "w") as f:
        f.write(taxa_lines)
    golden["taxa2freq_species"] = R.taxa2freq(tax_tsv, [("stdin", taxa_lines)])
    golden["taxa2freq_phylum_f0"] = R.taxa2freq(
        tax_tsv, [("stdin", taxa_lines)], rank="phylum", min_frequency=0)
    golden["taxa2freq_two_files"] = R.taxa2freq(
        tax_tsv, [("a.txt", taxa_lines), ("b.txt", taxa_lines)], rank="family")
    golden["snaptaxon_family"] = R.snaptaxon(taxa_lines, tax_tsv, rank="family")
    some_taxa = sorted({int(l) for l in taxa_lines.split() if l != "1"})[:3]
    golden["snaptaxon_taxa"] = R.snaptaxon(hs, tax_tsv, taxons=some_taxa,
                                           invalid=True)
    golden["taxonomy"] = R.taxonomy_cmd(taxa_lines, tax_tsv)
    golden["taxonomy_a_H"] = R.taxonomy_cmd(taxa_lines, tax_tsv,
                                            all_ranks=True, no_header=True)
    golden["taxa2tree_payload"] = json.dumps(
        R.taxa2tree_payload(hs), sort_keys=True) + "\n"

    # ---- index build ------------------------------------------------ #
    prot_tsv = []
    rng = np.random.default_rng(SEED + 2)
    species = [t for t, _n, r, _p, v in taxa_rows if r == "species" and v]
    for i in range(40):
        tid = int(species[int(rng.integers(0, len(species)))])
        ln = int(rng.integers(9, 60))
        prot = "".join("ARNDCEQGHILKMFPSTWYV"[int(rng.integers(0, 20))]
                       for _ in range(ln))
        prot_tsv.append(f"{tid}\t{prot}\n")
    prot_tsv = "".join(prot_tsv)
    with open(os.path.join(DATA, "proteins.tsv"), "w") as f:
        f.write(prot_tsv)

    split = R.splitkmers(prot_tsv)
    golden["splitkmers"] = split
    golden["splitkmers_p"] = R.splitkmers(prot_tsv, prefix="A")
    sorted_split = "".join(sorted(split.splitlines(keepends=True)))
    golden["joinkmers"] = R.joinkmers(sorted_split, tax_tsv)
    golden["printindex_roundtrip"] = R.printindex(R.buildindex(
        "".join(f"{k}\t{t}\n" for k, t, _r in
                (l.split("\t") for l in golden["joinkmers"].splitlines()))))

    for name, text in golden.items():
        with open(os.path.join(EXPECTED, name + ".golden"), "w") as f:
            f.write(text)
    print(f"wrote {len(golden)} golden files to {EXPECTED}")


if __name__ == "__main__":
    main()
