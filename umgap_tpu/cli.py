"""The ``umgap-tpu`` command line: all 20 reference subcommands.

Mirrors the reference CLI surface (/root/reference/src/main.rs:40-63)
with the same flags, stream formats, and realized output quirks, so the
shell pipelines of ``umgap-analyse.sh`` compose identically. Index files
are packed ``.npz`` tables instead of FSTs.

Output is written in input order (the reference's rayon chunk
interleaving makes its order unspecified; src/commands/pept2lca.rs:63-65).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from . import ranks
from .agg import host as agg_host
from .io import fasta, fastq
from .ops import encoding, kmers as kmerops, seedextend as seedmod, translate as transmod
from .taxonomy import NONE, Taxonomy, read_taxa_file


class CliError(Exception):
    pass


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #

def _load_taxonomy(path, with_unknown: bool = False) -> Taxonomy:
    return Taxonomy(read_taxa_file(path), with_unknown=with_unknown)


def _load_table(path, in_memory: bool = True):
    """``in_memory=False`` memory-maps the artifact (the reference's
    default FST mode; `-m` opts into a RAM load,
    src/commands/pept2lca.rs:74-79).  Compressed artifacts fall back to
    a full load."""
    from .index.table import load_table

    return load_table(path, mmap=not in_memory)


def _parse_rank(name: str) -> int:
    try:
        r = ranks.rank_index(name)
    except KeyError:
        raise CliError(f"Unknown rank: {name}")
    return r


# ---------------------------------------------------------------------- #
# stream commands
# ---------------------------------------------------------------------- #

def cmd_translate(args, stdin, stdout):
    try:
        table = encoding.get_table(int(args.table))
    except ValueError:
        raise CliError(f"Unknown table: {args.table}")
    frames = list(transmod.FRAME_NAMES) if args.all_frames else args.frame
    if args.show_table:
        print(table.show(), file=stdout)
        return
    writer = fasta.Writer(stdout, "", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        seq = rec.sequence[0] if rec.sequence else ""
        peptides = transmod.translate_sequence(seq, frames, table, args.methionine)
        for frame, pep in zip(frames, peptides):
            header = rec.header + "|" + frame if args.append_name else rec.header
            writer.write_record(fasta.Record(header, [pep]))


def cmd_fastq2fasta(args, stdin, stdout):
    writer = fasta.Writer(stdout, "", False)
    handles = [open(p) for p in args.input]
    try:
        readers = [fastq.read_records(h) for h in handles]
        for group in fastq.interleave(readers):
            for rec in group:
                writer.write_record(fasta.Record(rec.header, [rec.sequence]))
    finally:
        for h in handles:
            h.close()


def cmd_prot2kmer(args, stdin, stdout):
    k = args.length
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        seq = rec.sequence[0]
        if len(seq) < k:
            continue
        writer.write_record(
            fasta.Record(rec.header, [seq[i : i + k] for i in range(len(seq) - k + 1)])
        )


def cmd_prot2tryp(args, stdin, stdout):
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        writer.write_record(
            fasta.Record(rec.header, kmerops.tryptic_digest(rec.sequence[0], args.pattern))
        )


def cmd_filter(args, stdin, stdout):
    contains = set(args.contains)
    lacks = set(args.lacks)
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=False):
        kept = []
        for seq in rec.sequence:
            if not (args.minlen <= len(seq) <= args.maxlen):
                continue
            chars = set(seq)
            if contains <= chars and not (lacks & chars):
                kept.append(seq)
        writer.write_record(fasta.Record(rec.header, kept))


def cmd_uniq(args, stdin, stdout):
    sep = args.separator.replace("\\n", "\n")
    writer = fasta.Writer(stdout, sep, args.wrap)
    last: Optional[fasta.Record] = None
    for rec in fasta.read_records(stdin, unwrap=False):
        if args.delimiter is not None:
            idx = rec.header.find(args.delimiter)
            if idx != -1:
                rec.header = rec.header[:idx]
        if last is not None and last.header == rec.header:
            last.sequence.extend(rec.sequence)
        else:
            if last is not None:
                writer.write_record(last)
            last = rec
    if last is not None:
        writer.write_record(last)


def cmd_bestof(args, stdin, stdout):
    writer = fasta.Writer(stdout, "\n", False)

    def score(rec: fasta.Record) -> int:
        n = 0
        for item in rec.sequence:
            try:
                t = int(item)
            except ValueError:
                t = 0
            if t not in (0, 1):
                n += 1
        return n

    chunk: List[fasta.Record] = []
    for rec in fasta.read_records(stdin, unwrap=False):
        if len(chunk) < args.frames - 1:
            chunk.append(rec)
        else:
            # the frames-th record triggers processing and is dropped
            # (reference quirk, src/commands/bestof.rs:57-76)
            best = None
            best_score = -1
            for r in chunk:
                s = score(r)
                if s >= best_score:  # Rust max_by_key keeps the last max
                    best, best_score = r, s
            if best is not None:
                writer.write_record(best)
            chunk = []


def cmd_seedextend(args, stdin, stdout):
    tax = None
    if args.ranked is not None:
        tax = _load_taxonomy(args.ranked, with_unknown=True)
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=False):
        try:
            taxa = [int(s) for s in rec.sequence]
        except ValueError as e:
            raise CliError(str(e))
        kept = seedmod.apply_seedextend(
            taxa, args.min_seed_size, args.max_gap_size, tax, args.penalty
        )
        writer.write_record(fasta.Record(rec.header, [str(t) for t in kept]))


# ---------------------------------------------------------------------- #
# lookup commands
# ---------------------------------------------------------------------- #

def _lookup_peptides(table, peptides: List[str], default_zero: bool):
    """Look up full peptides in either table kind. Returns list of
    Optional[int] (None = miss to be dropped)."""
    from .index.table import CuckooKmerTable, KmerTable

    if isinstance(table, (KmerTable, CuckooKmerTable)):
        # one batched probe over every right-length peptide (no
        # per-peptide interpreter dispatch on the hot path)
        k = table.k
        right_len = np.array([len(p) == k for p in peptides], dtype=bool)
        packed = np.zeros(len(peptides), dtype=np.uint64)
        if right_len.any():
            idx = np.flatnonzero(right_len)
            blob = "".join(peptides[i] for i in idx)
            codes = encoding.encode_aa(blob).reshape(len(idx), k)
            pk = np.zeros(len(idx), dtype=np.uint64)
            for j in range(k):
                pk |= codes[:, j].astype(np.uint64) << np.uint64(5 * (k - 1 - j))
            packed[idx] = pk
        hi, lo = kmerops.split_packed(packed)
        vals, found = table.probe_host(hi, lo)
        found = found & right_len
        return [
            int(v) if f else (0 if default_zero else None)
            for v, f in zip(vals, found)
        ]
    vals, found = table.lookup_peptides_host(peptides)
    return [
        int(v) if f else (0 if default_zero else None)
        for v, f in zip(vals, found)
    ]


def cmd_pept2lca(args, stdin, stdout):
    table = _load_table(args.fst_file, in_memory=args.in_memory)
    for rec in fasta.read_records(stdin, unwrap=False):
        res = _lookup_peptides(table, rec.sequence, args.one_on_one)
        stdout.write(f">{rec.header}\n")
        for r in res:
            if r is not None:
                stdout.write(f"{r}\n")


def _stream_prot2kmer2lca(table, k: int, default_zero: bool, stdin, stdout):
    from .index.table import CuckooKmerTable, KmerTable

    if not isinstance(table, (KmerTable, CuckooKmerTable)):
        raise CliError("prot2kmer2lca requires a k-mer index")
    for rec in fasta.read_records(stdin, unwrap=True):
        prot = rec.sequence[0] if rec.sequence else ""
        if len(prot) < k:
            continue  # header not printed (prot2kmer2lca.rs:170-172)
        stdout.write(f">{rec.header}\n")
        packed = kmerops.pack_kmers_host(encoding.encode_aa(prot), k)
        hi, lo = kmerops.split_packed(packed)
        vals, found = table.probe_host(hi, lo)
        for v, f in zip(vals, found):
            if f:
                stdout.write(f"{int(v)}\n")
            elif default_zero:
                stdout.write("0\n")


def cmd_prot2kmer2lca(args, stdin, stdout):
    table = _load_table(args.fst_file, in_memory=args.in_memory)
    k = args.length
    if args.socket:
        import socket as socketlib

        server = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        server.bind(args.socket)
        server.listen()
        print("Socket created, listening for connections.", flush=True)
        while True:
            conn, _ = server.accept()
            print("Connection accepted. Processing...", flush=True)
            try:
                with conn.makefile("r") as rf, conn.makefile("w") as wf:
                    _stream_prot2kmer2lca(table, k, args.one_on_one, rf, wf)
                print("Connection finished succesfully.", flush=True)
            except Exception as e:  # keep serving (prot2kmer2lca.rs:133-136)
                print(f"Connection died with an error: {e}", flush=True)
            finally:
                conn.close()
    else:
        _stream_prot2kmer2lca(table, k, args.one_on_one, stdin, stdout)


def cmd_prot2tryp2lca(args, stdin, stdout):
    table = _load_table(args.fst_file, in_memory=args.in_memory)
    contains = set(args.keep)
    lacks = set(args.drop)
    for rec in fasta.read_records(stdin, unwrap=False):
        stdout.write(f">{rec.header}\n")
        for seq in rec.sequence:
            peptides = [
                p
                for p in kmerops.tryptic_digest(seq, args.pattern)
                if args.minlen <= len(p) <= args.maxlen
                and (
                    (not contains and not lacks)
                    or (contains <= set(p) and not (lacks & set(p)))
                )
            ]
            for r in _lookup_peptides(table, peptides, args.one_on_one):
                if r is not None:
                    stdout.write(f"{r}\n")


# ---------------------------------------------------------------------- #
# taxonomy commands
# ---------------------------------------------------------------------- #

def cmd_taxa2agg(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    snapping = tax.snapping(args.ranked)
    aggregator = agg_host.make_aggregator(tax, args.method, args.aggregate, args.factor)
    if args.method == "rmq" and args.aggregate == "hybrid":
        print("Warning: this is a hybrid between LCA/MRTL, not LCA*/MRTL",
              file=sys.stderr)

    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=False):
        pairs = []
        for item in rec.sequence:
            if args.scored:
                parts = item.split("=")
                if len(parts) != 2:
                    raise CliError("Taxon without score")
                pairs.append((int(parts[0]), float(parts[1])))
            else:
                pairs.append((int(item), 1.0))
        counts = agg_host.count(p for p in pairs if p[0] != 0)
        counts = agg_host.filter_counts(counts, args.lower_bound)
        if not counts:
            out = "1"
        else:
            aggregate = aggregator.aggregate(counts)
            snapped = snapping[aggregate]
            if snapped == NONE:
                raise CliError(f"Unsnappable taxon: {aggregate}")
            out = str(int(snapped))
        writer.write_record(fasta.Record(rec.header, [out]))


def format_freq_csv(tax, counts, col_names, min_frequency: int) -> str:
    """The taxa2freq CSV body (src/commands/taxa2freq.rs:104-149):
    header row, then rows with sum strictly > min_frequency, ordered by
    descending total (ties pinned to ascending taxon id — the Rust sort
    over HashMap order is nondeterministic on ties). Shared by the host
    command and the sharded device path so both are byte-identical."""
    out = ["taxon id,taxon name" + "".join("," + n for n in col_names) + "\n"]
    rows = sorted(counts.items(), key=lambda p: (-sum(p[1]), p[0]))
    for tid, row in rows:
        taxon = tax.get(tid)
        if taxon is None:
            raise CliError(
                "LCA taxon id not in taxon list. Check compatibility with index."
            )
        if sum(row) > min_frequency:
            out.append(f"{taxon.id},{taxon.name},"
                       + ",".join(str(c) for c in row) + "\n")
    return "".join(out)


def cmd_taxa2freq(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    rank = _parse_rank(args.rank)
    if rank == ranks.NO_RANK:
        raise CliError("Snap to an actual rank.")
    snapping = tax.rank_snapping(rank)

    numfiles = len(args.input_files)

    counts: dict[int, List[int]] = {}

    def count_stream(stream, index: int, width: int):
        for line in stream:
            line = line.rstrip("\n")
            try:
                t = int(line)
            except ValueError:
                continue  # silently skipped (taxa2freq.rs:160)
            if t < 0:
                continue
            snapped = int(snapping[t]) if t < tax.size and snapping[t] != NONE else 0
            counts.setdefault(snapped, [0] * width)[index] += 1

    if numfiles == 0:
        count_stream(stdin, 0, 1)
    else:
        for i, path in enumerate(args.input_files):
            with open(path) as f:
                count_stream(f, i, numfiles)

    col_names = args.input_files if numfiles else ["stdin"]
    stdout.write(format_freq_csv(tax, counts, col_names, args.frequency))


def cmd_snaptaxon(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    rank = _parse_rank(args.rank) if args.rank is not None else None
    if rank == ranks.NO_RANK:
        raise CliError("Snap to an actual rank.")
    snapping = tax.rank_snapping(rank, taxa=args.taxons,
                                 require_valid=not args.invalid)
    for line in stdin:
        line = line.rstrip("\n")
        if line.startswith(">"):
            stdout.write(line + "\n")
        else:
            try:
                t = int(line)
            except ValueError:
                raise CliError(f"Invalid taxon ID: {line}")
            if t < 0:
                raise CliError(f"Invalid taxon ID: {line}")
            snapped = snapping[t] if t < tax.size else NONE
            stdout.write(f"{0 if snapped == NONE else int(snapped)}\n")


def cmd_taxonomy(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    if not args.no_header:
        stdout.write("taxon_id\ttaxon_name\ttaxon_rank")
        if args.all:
            for rname in ranks.NAMED_RANKS:
                rn = rname.replace(" ", "_")
                stdout.write(f"\t{rn}_id\t{rn}_name")
        stdout.write("\n")
    for line in stdin:
        line = line.rstrip("\n")
        if line.startswith(">"):
            stdout.write(line + "\n")
            continue
        tid = int(line)
        taxon = tax.get(tid)
        if taxon is None:
            raise CliError(f"Unknown Taxon ID: {tid}")
        stdout.write(f"{taxon.id}\t{taxon.name}\t{ranks.rank_name(taxon.rank)}")
        if args.all:
            lineage = tax.lineage(tid)
            for r in range(1, ranks.RANK_COUNT):
                lt = lineage[r]
                if lt != NONE:
                    t2 = tax.get(int(lt))
                    stdout.write(f"\t{t2.id}\t{t2.name}")
                else:
                    stdout.write("\t\t")
        stdout.write("\n")


def cmd_taxa2tree(args, stdin, stdout):
    taxa: dict[int, int] = {}
    for rec in fasta.read_records(stdin, unwrap=False):
        t = int(rec.sequence[0])
        taxa[t] = taxa.get(t, 0) + 1
    import json
    from urllib import request

    payload = json.dumps(
        {"counts": {str(k): v for k, v in taxa.items()}, "link": str(args.url).lower()}
    ).encode()
    req = request.Request(
        "http://api.unipept.ugent.be/api/v1/taxa2tree",
        data=payload,
        headers={"Content-Type": "application/json"},
    )
    try:
        with request.urlopen(req, timeout=30) as res:
            body = res.read().decode()
    except Exception as e:
        raise CliError(f"taxa2tree request failed: {e}")
    if args.url:
        import json as jsonlib

        gist = jsonlib.loads(body).get("gist", "")
        stdout.write(
            gist.replace("https://gist.github.com/", "https://bl.ocks.org/") + "\n"
        )
    else:
        stdout.write(body)


# ---------------------------------------------------------------------- #
# index commands
# ---------------------------------------------------------------------- #

def cmd_splitkmers(args, stdin, stdout):
    from .index.build import split_kmers

    def rows():
        for line in stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                raise CliError(f"Invalid TSV row: {line!r}")
            yield int(parts[0]), parts[1]

    for kmer, tid in split_kmers(rows(), args.length, args.prefix):
        stdout.write(f"{kmer}\t{tid}\n")


def cmd_joinkmers(args, stdin, stdout):
    from .index.build import join_kmers

    tax = _load_taxonomy(args.taxon_file)

    def rows():
        for line in stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                raise CliError(f"Invalid TSV row: {line!r}")
            yield parts[0], int(parts[1])

    for kmer, taxon, rank in join_kmers(rows(), tax):
        stdout.write(f"{kmer}\t{taxon}\t{rank}\n")


def cmd_buildindex(args, stdin, stdout):
    import io as iomod

    from .index.build import build_table

    def rows():
        for line in stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                raise CliError(f"Invalid TSV row: {line!r}")
            yield parts[0], int(parts[1])

    table = build_table(rows(), kind=args.kind)
    buf = iomod.BytesIO()
    table.save(buf)
    data = buf.getvalue()
    out = getattr(stdout, "buffer", stdout)
    out.write(data)


def cmd_buildindex_dist(args, stdin, stdout):
    """Distributed multi-process index build with checkpoint/resume —
    the runnable counterpart of the reference's cluster job
    (/root/reference/scripts/build-index-phanpy.hpc.sh:1-10). Re-running
    the same command resumes after any killed worker or driver."""
    import json

    from .index import distbuild

    if args.task:
        distbuild.worker_main(args.workdir, args.task, args.index,
                              join_threads=args.join_threads)
        return
    if args.repack:
        n = distbuild.repack_shards(
            args.workdir, log=lambda s: print(s, file=sys.stderr))
        stdout.write(json.dumps({"repacked": n}) + "\n")
        return
    if args.densify:
        n = distbuild.densify_shards(
            args.workdir, log=lambda s: print(s, file=sys.stderr))
        stdout.write(json.dumps({"densified": n}) + "\n")
        return
    if args.synthetic is None and (args.tsv is None or args.taxons is None):
        raise CliError("need --tsv and --taxons (or --synthetic N)")
    manifest = distbuild.drive(
        args.workdir, args.tsv, args.taxons, n_shards=args.shards,
        workers=args.workers, k=args.k,
        synthetic_rows=(int(float(args.synthetic))
                        if args.synthetic is not None else None),
        seed=args.seed, layout=args.layout, reclaim=args.reclaim,
        reclaim_input=args.reclaim_input)
    stdout.write(json.dumps({
        "n_keys": manifest["n_keys"],
        "n_shards": manifest["n_shards"],
        "capacity": manifest["capacity"],
        "timings_s": manifest["timings"],
        "shards_dir": os.path.join(args.workdir, "shards"),
    }) + "\n")


def cmd_printindex(args, stdin, stdout):
    from .index.table import CuckooKmerTable, KmerTable

    if os.path.isdir(args.fst_file):
        # a buildindex-dist workdir: merge the shard artifacts into one
        # key-sorted stream (the FST prints sorted; so do we)
        from .index import distbuild

        shards = distbuild.load_shards(args.fst_file)
        packed = []
        values = []
        k = shards[0].k if shards else 9
        for t in shards:
            p, v = t.items()
            packed.append(p)
            values.append(v)
        packed = np.concatenate(packed) if packed else np.zeros(0, np.uint64)
        values = np.concatenate(values) if values else np.zeros(0, np.int32)
        order = np.argsort(packed)
        for p, v in zip(packed[order], values[order]):
            stdout.write(f"{kmerops.unpack_kmer(int(p), k)}\t{int(v)}\n")
        return

    table = _load_table(args.fst_file)
    if isinstance(table, (KmerTable, CuckooKmerTable)):
        packed, values = table.items()
        order = np.argsort(packed)
        for p, v in zip(packed[order], values[order]):
            stdout.write(f"{kmerops.unpack_kmer(int(p), table.k)}\t{int(v)}\n")
    else:
        if table.raw_keys is None:
            raise CliError("index was built without stored keys")
        pairs = sorted(zip(table.raw_keys, table.raw_values))
        for key, v in pairs:
            stdout.write(f"{key}\t{int(v)}\n")


# ---------------------------------------------------------------------- #
# argument parsing
# ---------------------------------------------------------------------- #

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="umgap-tpu",
        description="UMGAP on JAX accelerators: metagenomics analysis "
                    "pipeline tools",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("translate", help="Translate DNA into amino acid sequences")
    sp.add_argument("-m", "--methionine", action="store_true")
    sp.add_argument("-a", "--all-frames", action="store_true")
    sp.add_argument("-f", "--frame", action="append", default=[],
                    choices=list(transmod.FRAME_NAMES))
    sp.add_argument("-n", "--append-name", action="store_true")
    sp.add_argument("-t", "--table", default="1")
    sp.add_argument("-s", "--show-table", action="store_true")
    sp.set_defaults(func=cmd_translate)

    sp = sub.add_parser("fastq2fasta", help="Interleave FASTQ files into FASTA")
    sp.add_argument("input", nargs="+")
    sp.set_defaults(func=cmd_fastq2fasta)

    sp = sub.add_parser("prot2kmer", help="Split peptides into k-mers")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.set_defaults(func=cmd_prot2kmer)

    sp = sub.add_parser("prot2tryp", help="Split peptides at tryptic cleavage sites")
    sp.add_argument("-p", "--pattern", default=kmerops.TRYPTIC_PATTERN)
    sp.set_defaults(func=cmd_prot2tryp)

    sp = sub.add_parser("filter", help="Filter peptides by length and content")
    sp.add_argument("-m", "--minlen", type=int, default=5)
    sp.add_argument("-M", "--maxlen", type=int, default=50)
    sp.add_argument("-c", "--contains", default="")
    sp.add_argument("-l", "--lacks", default="")
    sp.set_defaults(func=cmd_filter)

    sp = sub.add_parser("uniq", help="Join consecutive records with equal headers")
    sp.add_argument("-s", "--separator", default="\n")
    sp.add_argument("-w", "--wrap", action="store_true")
    sp.add_argument("-d", "--delimiter", default=None)
    sp.set_defaults(func=cmd_uniq)

    sp = sub.add_parser("bestof", help="Select the best frame of each group")
    sp.add_argument("-f", "--frames", type=int, default=6)
    sp.set_defaults(func=cmd_bestof)

    sp = sub.add_parser("seedextend", help="Select promising taxon regions")
    sp.add_argument("-s", "--min-seed-size", type=int, default=2)
    sp.add_argument("-g", "--max-gap-size", type=int, default=0)
    sp.add_argument("-r", "--ranked", default=None)
    sp.add_argument("-p", "--penalty", type=int, default=5)
    sp.set_defaults(func=cmd_seedextend)

    sp = sub.add_parser("pept2lca", help="Look up peptides in an index")
    sp.add_argument("-o", "--one-on-one", action="store_true")
    # -m/-c mirror the reference's mmap-vs-RAM and thread-chunking knobs
    # (src/commands/pept2lca.rs:58-69); mmap is the default load mode
    # here too, -c is a no-op (lookups are batched wholesale)
    sp.add_argument("-m", "--in-memory", action="store_true",
                    help="load the index into RAM instead of "
                         "memory-mapping it")
    sp.add_argument("-c", "--chunksize", type=int, default=240,
                    help="compatibility no-op (lookups are batched)")
    sp.add_argument("fst_file")
    sp.set_defaults(func=cmd_pept2lca)

    sp = sub.add_parser("prot2kmer2lca", help="Look up all peptide k-mers")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.add_argument("-o", "--one-on-one", action="store_true")
    sp.add_argument("-m", "--in-memory", action="store_true")
    sp.add_argument("-c", "--chunksize", type=int, default=240)
    sp.add_argument("-s", "--socket", default=None)
    sp.add_argument("fst_file")
    sp.set_defaults(func=cmd_prot2kmer2lca)

    sp = sub.add_parser("prot2tryp2lca", help="Digest and look up tryptic peptides")
    sp.add_argument("-o", "--one-on-one", action="store_true")
    sp.add_argument("-m", "--in-memory", action="store_true")
    sp.add_argument("-c", "--chunksize", type=int, default=240)
    sp.add_argument("-p", "--pattern", default=kmerops.TRYPTIC_PATTERN)
    sp.add_argument("-l", "--minlen", type=int, default=5)
    sp.add_argument("-L", "--maxlen", type=int, default=50)
    sp.add_argument("-k", "--keep", default="")
    sp.add_argument("-d", "--drop", default="")
    sp.add_argument("fst_file")
    sp.set_defaults(func=cmd_prot2tryp2lca)

    sp = sub.add_parser("taxa2agg", help="Aggregate taxon lists per read")
    sp.add_argument("-s", "--scored", action="store_true")
    sp.add_argument("-r", "--ranked", action="store_true")
    sp.add_argument("-m", "--method", default="tree", choices=["tree", "rmq"])
    sp.add_argument("-a", "--aggregate", default="hybrid",
                    choices=["lca*", "hybrid", "mrtl"])
    sp.add_argument("-f", "--factor", type=float, default=0.25)
    sp.add_argument("-l", "--lower-bound", type=float, default=0)
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_taxa2agg)

    sp = sub.add_parser("taxa2freq", help="Frequency table at a target rank")
    sp.add_argument("-r", "--rank", default="species", choices=list(ranks.NAMED_RANKS))
    sp.add_argument("-f", "--frequency", type=int, default=1)
    sp.add_argument("taxon_file")
    sp.add_argument("input_files", nargs="*")
    sp.set_defaults(func=cmd_taxa2freq)

    sp = sub.add_parser("taxa2tree", help="Visualize taxa via the Unipept API")
    sp.add_argument("-u", "--url", action="store_true")
    sp.set_defaults(func=cmd_taxa2tree)

    sp = sub.add_parser("snaptaxon", help="Snap taxa to a rank or taxon set")
    sp.add_argument("-r", "--rank", default=None, choices=list(ranks.NAMED_RANKS))
    sp.add_argument("-t", "--taxons", type=int, action="append", default=[])
    sp.add_argument("-i", "--invalid", action="store_true")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_snaptaxon)

    sp = sub.add_parser("taxonomy", help="Annotate taxon IDs with name and rank")
    sp.add_argument("-a", "--all", action="store_true")
    sp.add_argument("-H", "--no-header", action="store_true")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_taxonomy)

    sp = sub.add_parser("splitkmers", help="Split proteins into (kmer, taxid) rows")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.add_argument("-p", "--prefix", default="")
    sp.set_defaults(func=cmd_splitkmers)

    sp = sub.add_parser("joinkmers", help="Aggregate sorted (kmer, taxid) rows")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_joinkmers)

    sp = sub.add_parser("buildindex", help="Build a packed index from sorted TSV")
    sp.add_argument("--kind", default="auto", choices=["auto", "kmer", "peptide"])
    sp.set_defaults(func=cmd_buildindex)

    sp = sub.add_parser(
        "buildindex-dist",
        help="Distributed multi-process index build with checkpoint/"
             "resume (build-index-phanpy.hpc.sh equivalent)")
    sp.add_argument("--workdir", required=True,
                    help="shared work directory (checkpoints + artifacts)")
    sp.add_argument("--tsv", default=None,
                    help="(taxid TAB protein) input TSV")
    sp.add_argument("--taxons", default=None)
    sp.add_argument("--shards", type=int, default=16,
                    help="hash-range shards (= serving-mesh shard count)")
    sp.add_argument("--workers", type=int, default=2,
                    help="parallel worker processes")
    sp.add_argument("-k", type=int, default=9)
    sp.add_argument("--synthetic", default=None,
                    help="generate N synthetic input rows instead of "
                         "--tsv (benchmark / scale-test mode)")
    sp.add_argument("--layout", default="bucket64s",
                    choices=["bucket64s", "bucket64d", "bucket16",
                             "bucket8s"],
                    help="shard table geometry: bucket64s (default) = "
                         "ONE full-tile 512B row gather per query, the "
                         "measured at-scale optimum (~16-32 B/key); "
                         "bucket64d = same rows conveyor-placed at up "
                         "to ~0.9 load (~9-10 B/key, denser than the "
                         "reference's FST) at a 2-row probe (2x the "
                         "bucket64s per-query gather cost); "
                         "bucket16 = <=2 gathers at up to 0.9 load "
                         "(memory-lean); bucket8s = the cache-regime "
                         "layout for small chip-resident tables")
    sp.add_argument("--seed", type=int, default=7)
    sp.add_argument("--reclaim", action="store_true",
                    help="disk-bounded build: delete each stage's "
                         "consumed inputs once its outputs are "
                         "checkpointed (spills after join, joined "
                         "arrays after table build) — peak disk drops "
                         "from ~3.5x to ~1.6x the final artifact size")
    sp.add_argument("--reclaim-input", action="store_true",
                    help="treat the input --tsv as scratch: punch holes "
                         "in each consumed chunk's byte range as it is "
                         "partitioned (the file's CONTENT is destroyed; "
                         "offsets stay valid for resume).  For "
                         "regenerable inputs only — at 10^10-row scale "
                         "peak disk is the TSV plus all spills, and "
                         "this removes the TSV term")
    sp.add_argument("--densify", action="store_true",
                    help="relayout an EXISTING workdir's bucket64s "
                         "shards into the dense bucket64d geometry in "
                         "place (atomic per shard, re-runnable) — "
                         "typically halves artifact bytes (~9.2 B/key) "
                         "at the cost of a 2-row probe")
    sp.add_argument("--repack", action="store_true",
                    help="relayout an EXISTING workdir's shards into "
                         "the packed device-wire format in place "
                         "(atomic per shard, re-runnable); packed "
                         "shards mmap straight into the device "
                         "transfer at serve time — no host repack")
    # internal: worker re-invocation
    sp.add_argument("--task", default=None,
                    choices=["partition", "join", "build"],
                    help=argparse.SUPPRESS)
    sp.add_argument("--index", default="0", help=argparse.SUPPRESS)
    sp.add_argument("--join-threads", type=int, default=1,
                    help=argparse.SUPPRESS)
    sp.set_defaults(func=cmd_buildindex_dist)

    sp = sub.add_parser("printindex", help="Print the key/value pairs in an index")
    sp.add_argument("fst_file")
    sp.set_defaults(func=cmd_printindex)

    sp = sub.add_parser(
        "setup",
        help="Install/verify taxonomy + index data (umgap-setup.sh equivalent)",
    )
    sp.add_argument("-c", "--configdir", default=None,
                    help="config directory (XDG discovery by default)")
    sp.add_argument("-d", "--datadir", default=None,
                    help="data directory (XDG discovery by default)")
    sp.add_argument("-v", "--version", default=None,
                    help="data version (default: ask the data server)")
    sp.add_argument("-s", "--server", default=None,
                    help="data server base URL")
    sp.add_argument("--taxons", default=None,
                    help="local taxons.tsv to install (offline setup)")
    sp.add_argument("--tryptic", default=None,
                    help="local tryptic .npz index to install")
    sp.add_argument("--ninemer", default=None,
                    help="local 9-mer .npz index to install")
    sp.add_argument("-y", "--yes", action="store_true",
                    help="non-interactive: install everything requested")
    sp.set_defaults(func=cmd_setup)

    sp = sub.add_parser(
        "visualize",
        help="Visualize analysis results (umgap-visualize.sh equivalent)",
    )
    grp = sp.add_mutually_exclusive_group(required=True)
    grp.add_argument("-t", "--taxa-rank", default=None,
                     help="CSV frequency table at this rank")
    grp.add_argument("-w", "--web", action="store_true",
                     help="HTML visualization via the Unipept API")
    grp.add_argument("-u", "--url", action="store_true",
                     help="print a shareable URL via the Unipept API")
    sp.add_argument("-c", "--configdir", default=None)
    sp.add_argument("--taxons", default=None,
                    help="taxonomy TSV (default: config-dir discovery)")
    sp.add_argument("input_files", nargs="+")
    sp.set_defaults(func=cmd_visualize)

    sp = sub.add_parser(
        "analyse",
        help="Run a preset pipeline end-to-end (umgap-analyse.sh equivalent)",
    )
    sp.add_argument("-t", "--type", action=_SampleAction,
                    default="high-precision",
                    choices=["max-sensitivity", "high-sensitivity",
                             "high-precision", "max-precision",
                             "tryptic-sensitivity", "tryptic-precision"])
    sp.add_argument("-1", "--first", action=_SampleAction,
                    help="FASTA (single-end) or FASTQ end-1 file; may be "
                         "gzipped; repeatable per sample")
    sp.add_argument("-2", "--second", action=_SampleAction, default=None,
                    help="FASTQ end 2")
    sp.add_argument("-o", "--output", action=_SampleAction, default=None,
                    help="output file ('-' = stdout); closes a sample "
                         "group, repeatable (umgap-analyse.sh multi-sample "
                         "mode: loaded indexes are shared between samples)")
    sp.add_argument("-z", "--compress", action=_SampleAction, nargs=0,
                    help="gzip-compress the next output file")
    sp.add_argument("--taxons", default=None,
                    help="taxon TSV file (default: config-dir discovery, "
                         "umgap-analyse.sh:233-241)")
    sp.add_argument("--index", default=None,
                    help="9-mer or tryptic index .npz (default: config-dir "
                         "discovery)")
    sp.add_argument("-c", "--configdir", default=None,
                    help="config directory for data discovery")
    # 16384 was tuned on an earlier accelerator, not yet measured on
    # this card
    sp.add_argument("--batch-size", type=int, default=16384,
                    help="max reads per device batch (small samples use "
                         "smaller power-of-two buckets automatically)")
    sp.add_argument("--read-length", type=int, default=160)
    sp.add_argument("--trace-dir", default=None,
                    help="write a JAX profiler (xprof) trace here")
    sp.add_argument("--serve", default=None, metavar="SOCKET",
                    help="after any initial samples, keep serving: each "
                         "Unix-socket connection sends one request line "
                         "(-t TYPE -1 R1 [-2 R2] [-z] [-o OUT], "
                         "repeatable) and gets 'ok <n>' per written "
                         "output (or the FASTA streamed back without "
                         "-o); compiled programs + device state stay "
                         "hot across requests — the full-pipeline "
                         "analogue of the reference's socket index "
                         "service ('quit' stops it)")
    sp.add_argument("--fgspp", choices=["auto", "never", "require"],
                    default="auto",
                    help="FragGeneScan++ gene-prediction front end for "
                         "the precision presets (umgap-analyse.sh:248-"
                         "251): 'auto' uses <configdir>/FGSpp when "
                         "installed, else 6-frame translation")
    sp.add_argument("--mesh", nargs="?", const="auto", default=None,
                    metavar="N",
                    help="run sharded over an N-device mesh (default "
                         "all visible devices): reads data-parallel, "
                         "the index hash-range-sharded across device "
                         "memories with all-to-all probe routing — the "
                         "multi-device form of umgap-analyse.sh's shared "
                         "socket index; on one device this degrades to "
                         "1 shard")
    sp.add_argument("--shards", default=None, metavar="DIR",
                    help="serve a buildindex-dist artifact: DIR is the "
                         "build workdir (or its shards/ directory); "
                         "the shard count must be a multiple of the "
                         "mesh size (each device holds several "
                         "sub-shards). Implies --mesh auto. 9-mer "
                         "presets only")
    sp.set_defaults(func=cmd_analyse)

    return p


def cmd_setup(args, stdin, stdout):
    """umgap-setup.sh equivalent: create config/data dirs, negotiate a
    data version, install artifacts (from the data server, or from local
    files for offline setups), symlink into the config dir."""
    from . import configdir as cfg

    conf = args.configdir or cfg.default_config_dir()
    data = args.datadir or cfg.default_data_dir()
    server = args.server or cfg.DATASERVER

    local = {}
    if args.taxons:
        local["taxons.tsv"] = args.taxons
    if args.tryptic:
        local["tryptic.npz"] = args.tryptic
    if args.ninemer:
        local["ninemer.npz"] = args.ninemer

    version = args.version
    if version is None:
        if local:
            raise CliError(
                "Installing local files requires an explicit --version")
        stdout.write("Checking the latest version on the server.\n")
        try:
            version = cfg.latest_server_version(server)
        except Exception as e:
            raise CliError(f"Could not retrieve version from server: {e}")
        stdout.write(f"Latest version is {version}.\n")

    if local:
        cfg.install(conf, data, version, local,
                    log=lambda m: stdout.write(m + "\n"))
    elif args.yes:
        sources = {}
        for name, remote in (("taxons.tsv", "taxons.tsv"),
                             ("tryptic.npz", "tryptic.fst"),
                             ("ninemer.npz", "ninemer.fst")):
            if not os.path.islink(os.path.join(conf, version, name)):
                sources[name] = f"{server}/{version}/{remote}"
        if sources:
            cfg.install(conf, data, version, sources,
                        log=lambda m: stdout.write(m + "\n"))
    for name in cfg.FILES:
        link = os.path.join(conf, version, name)
        state = "available" if os.path.islink(link) else "missing"
        stdout.write(f"{name} ({version}): {state}\n")


def cmd_visualize(args, stdin, stdout):
    """umgap-visualize.sh:122-154 equivalent: -t CSV frequency table,
    -w HTML via taxa2tree, -u URL via taxa2tree. Gzipped inputs are
    sniffed and decompressed; the CSV header strips directory names
    (the reference's `sed '1s_,[^,]*/_,_g'`)."""
    import re as _re

    from . import configdir as cfg

    def read_input(path: str) -> str:
        with cfg.sniff_open(path) as f:
            return f.read()

    if args.taxa_rank is not None:
        taxons = args.taxons
        if taxons is None:
            conf = args.configdir or cfg.default_config_dir()
            version = cfg.discover_version(conf)
            if version is None:
                raise CliError("No taxon table found for frequency counting. "
                               "Please run umgap-tpu setup.")
            taxons = cfg.resolve(conf, version, "taxons.tsv")
        import io as iomod
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            # decompress into tmp files named like the reference's FIFOs
            # (basename with non-alnum chars -> '_', umgap-visualize.sh:141)
            paths = []
            for p in args.input_files:
                name = _re.sub(r"[^0-9A-Za-z.-]", "_", os.path.basename(p))
                dst = os.path.join(tmp, name)
                with cfg.sniff_open(p) as fsrc, open(dst, "w") as fdst:
                    fdst.write(fsrc.read())
                paths.append(dst)
            out = iomod.StringIO()
            ns = argparse.Namespace(rank=args.taxa_rank, frequency=1,
                                    taxon_file=taxons, input_files=paths)
            cmd_taxa2freq(ns, stdin, out)
        text = out.getvalue()
        lines = text.split("\n")
        if lines:
            lines[0] = _re.sub(r",[^,]*/", ",", lines[0])
        stdout.write("\n".join(lines))
        return

    ns = argparse.Namespace(url=bool(args.url))
    for path in args.input_files:
        import io as iomod

        cmd_taxa2tree(ns, iomod.StringIO(read_input(path)), stdout)


class _SampleAction(argparse.Action):
    """Records option order so `analyse` can reconstruct per-sample
    groups (umgap-analyse.sh's repeated -1/-2/-t/-z/-o series)."""

    def __call__(self, parser, namespace, values, option_string=None):
        seq = getattr(namespace, "_sequence", None)
        if seq is None:
            seq = []
            setattr(namespace, "_sequence", seq)
        seq.append((self.dest, values))
        if self.dest != "compress":
            setattr(namespace, self.dest, values)


def _analyse_samples(args, allow_empty: bool = False):
    """Per-sample groups from the recorded option order. Each `-o`
    closes a sample and resets type/inputs/compress to defaults
    (umgap-analyse.sh:208-213). Without any `-o`, the whole invocation
    is one stdout sample (back-compat)."""
    seq = getattr(args, "_sequence", []) or []
    return _samples_from_seq(seq, allow_empty=allow_empty)


def _samples_from_seq(seq, allow_empty: bool = False):
    samples = []
    fresh = dict(type="high-precision", first=None, second=None,
                 compress=False, output=None)
    cur = dict(fresh)
    for key, val in seq:
        if key == "compress":
            cur["compress"] = True
        elif key == "output":
            if cur["first"] is None:
                raise CliError(
                    "Encountered an output file without input files.")
            cur["output"] = val
            samples.append(cur)
            cur = dict(fresh)
        else:
            cur[key] = val
    if cur["first"] is not None and cur["output"] is None and not samples:
        samples.append(cur)  # single sample, stdout
    elif cur["first"] is not None and samples:
        raise CliError("Trailing input files without an output file.")
    if not samples and not allow_empty:
        raise CliError("No samples given (need at least -1 <reads>).")
    return samples


def _read_groups_fasta(path: str, delimiter: str = "/"):
    """Single-end FASTA ingest (analyse.sh's one-file form), gzip
    sniffed; one group per record."""
    from .configdir import sniff_open

    with sniff_open(path) as f:
        for rec in fasta.read_records(f, unwrap=True):
            header = rec.header
            idx = header.find(delimiter)
            if idx != -1:
                header = header[:idx]
            yield header, [rec.sequence[0] if rec.sequence else ""]


# Top device width bucket (covers full Illumina / long-read amplicon
# ranges).  Records beyond it are NOT clipped: the sample re-routes
# through the fallback reader, which sends oversized records through an
# exact host path (the reference is exact at any record length,
# src/io/fasta.rs:62-64) and everything else through the device
# programs.  The tryptic presets re-route through the host-digest path
# the same way.
ANALYSE_WIDTH_CAP = 4096


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n within [lo, hi] (each compiled batch
    geometry is one program; buckets keep the compile count tiny).  The
    cap ``hi`` is rounded DOWN to a power of two first so the result is
    always a power of two."""
    hi = max(lo, 1 << (max(hi, 1).bit_length() - 1))
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _device_memory_limit(device) -> Optional[int]:
    """Bytes one device can hold: ``UMGAP_HBM_BYTES`` when set (how
    tests drive the refusal path on CPU devices, which report no
    limit), else the device's own ``memory_stats()["bytes_limit"]``,
    else None."""
    env_limit = os.environ.get("UMGAP_HBM_BYTES")
    if env_limit:
        return int(float(env_limit))
    return (device.memory_stats() or {}).get("bytes_limit")


def _analyse_width_ladder(read_length: int):
    ladder = [read_length]
    w = 256
    while w <= ANALYSE_WIDTH_CAP:
        if w > ladder[-1]:
            ladder.append(w)
        w *= 2
    return ladder


class _SampleReroute(Exception):
    """The native streaming path met a record it cannot handle exactly;
    the sample restarts through the fallback reader (emitted-prefix
    skip keeps already-written reads intact)."""


class _LongTrypticSample(_SampleReroute):
    """Tryptic sample holds records beyond read_length: the device
    digest's compile cost scales with width, so re-route the sample
    through the host-digest + device-probe path."""


class _LongNinemerSample(_SampleReroute):
    """9-mer sample holds records beyond the top width bucket: re-route
    so oversized records run the exact host path instead of clipping."""


def _analyse_long_group_host(seqs, config, ends: int, stax, stable_,
                             aux_cache: dict) -> int:
    """Consensus taxon for ONE read group containing records beyond the
    device width cap: host 6-frame translation + vectorized host table
    probe + host seedextend + host taxa2agg — the exact composition of
    the reference pipeline (translate -a | prot2kmer2lca -o |
    seedextend | uniq | taxa2agg) at unbounded record length."""
    table = encoding.get_table(config.table_number)
    hits: List[int] = []
    for seq in seqs[:ends]:
        for pep in transmod.translate_sequence(
                seq, transmod.FRAME_NAMES, table):
            if len(pep) < config.k:
                continue  # prot2kmer2lca skips records shorter than k
            packed = kmerops.pack_kmers_host(
                encoding.encode_aa(pep), config.k)
            hi, lo = kmerops.split_packed(packed)
            vals, found = stable_.probe_host(hi, lo)
            taxa = [int(v) if f else 0 for v, f in zip(vals, found)]
            hits.extend(seedmod.apply_seedextend(
                taxa, config.min_seed_size, config.max_gap_size,
                None, config.penalty))
    counts = agg_host.count((t, 1.0) for t in hits if t != 0)
    counts = agg_host.filter_counts(counts, config.lower_bound)
    if not counts:
        return 1
    key = ("host_agg", config.method, config.strategy, config.factor)
    aggregator = aux_cache.get(key)
    if aggregator is None:
        aggregator = agg_host.make_aggregator(
            stax, config.method, config.strategy, config.factor)
        aux_cache[key] = aggregator
    skey = ("host_snap",)
    snapping = aux_cache.get(skey)
    if snapping is None:
        snapping = stax.snapping(False)
        aux_cache[skey] = snapping
    snapped = snapping[aggregator.aggregate(counts)]
    if snapped == NONE:
        raise CliError("Unsnappable taxon in long-record path")
    return int(snapped)


def cmd_analyse(args, stdin, stdout):
    """The six preset pipelines, fused on device
    (scripts/umgap-analyse.sh:276-311; the precision presets run
    FragGeneScan++ when installed under the config dir, --fgspp, and
    the self-contained 6-frame translation otherwise). Supports the
    script's
    multi-sample mode: repeated -1/-2/-t/-z/-o groups share the loaded
    taxonomy, the device-resident indexes AND the compiled programs
    across samples (the analogue of its socket index service).

    Ingestion streams: the native parser feeds padded code arrays
    chunk-by-chunk (O(chunk) host memory on multi-GB inputs), batch
    sizes are bucketed powers of two up to ``--batch-size`` so small
    samples compile small programs and large samples run the full
    benched batch, and read-length buckets grow along a ladder when a
    sample holds records longer than ``--read-length`` (instead of
    silently clipping them)."""
    import itertools

    from .agg import device as devagg
    from .ops import lookup
    from .pipeline import PRESETS, TRYPTIC_PRESETS
    from .pipeline.runner import (
        Analyser,
        read_groups_fastq,
        stream_paired_chunks,
        stream_single_chunks,
    )
    from .pipeline.tryptic import TrypticAnalyser, analyse_tryptic_groups
    from .utils import device_trace, enable_compile_cache, log, verbose

    enable_compile_cache()
    samples = _analyse_samples(
        args, allow_empty=bool(getattr(args, "serve", None)))

    tax = None
    tables: dict = {}
    stables: dict = {}  # sharded mode: tryptic -> ShardedTable
    mesh = None
    mesh_axis = "x"
    if getattr(args, "shards", None) is not None and args.mesh is None:
        args.mesh = "auto"
    sharded = getattr(args, "mesh", None) is not None
    if sharded:
        import jax

        # honor JAX_PLATFORMS when it was set after jax was imported
        # (e.g. `JAX_PLATFORMS=cpu umgap-tpu analyse --mesh 8` with
        # xla_force_host_platform_device_count for an emulated mesh); a
        # no-op when the env var already took effect, and not an error
        # once a backend is live — the device-count check below reports
        # the real geometry either way
        plat = os.environ.get("JAX_PLATFORMS")
        if plat:
            try:
                jax.config.update("jax_platforms", plat)
            except Exception:
                pass

        from .parallel import make_mesh

        n_dev = (len(jax.devices()) if args.mesh == "auto"
                 else int(args.mesh))
        mesh = make_mesh(n_dev)

    def _build_stable(tryptic: bool, table):
        """Split a single loaded index across the mesh (graceful 1-shard
        degradation on a single chip)."""
        from .parallel import (
            ShardedTable,
            build_sharded_peptide_tables,
            build_sharded_tables,
        )

        n_dev = int(mesh.devices.size)
        if tryptic:
            if table.raw_keys is None:
                raise CliError(
                    "--mesh tryptic serving needs an index built with "
                    "stored keys (the default buildindex output)")
            shards = build_sharded_peptide_tables(
                table.raw_keys, table.raw_values, n_shards=n_dev)
        else:
            packed, values = table.items()
            shards = build_sharded_tables(packed, values, k=table.k,
                                          n_shards=n_dev)
        return ShardedTable.from_shards(shards, mesh, axis=mesh_axis)

    def _load_shards_dir():
        """A buildindex-dist workdir as the serving index: shards load
        unchanged (they were built with the serving owner function) and
        group onto the mesh devices; taxons default from the build
        manifest."""
        import json

        from .index import distbuild
        from .parallel import ShardedTable

        workdir = os.path.normpath(args.shards)
        if os.path.basename(workdir) == "shards":
            workdir = os.path.dirname(workdir)
        man_path = os.path.join(workdir, "manifest.json")
        if not os.path.exists(man_path):
            raise CliError(
                f"no manifest.json under {workdir}; --shards takes a "
                "buildindex-dist workdir (or its shards/ directory)")
        with open(man_path) as f:
            manifest = json.load(f)
        n_dev = int(mesh.devices.size)
        if manifest["n_shards"] % n_dev:
            raise CliError(
                f"{manifest['n_shards']} shards cannot be grouped onto "
                f"the {n_dev}-device mesh (must divide evenly)")
        # capacity pre-check: fail with sizing advice instead of an
        # opaque device OOM mid-transfer
        per_dev_bytes = (manifest.get("capacity", 0) * 8
                         * (manifest["n_shards"] // n_dev))
        limit = _device_memory_limit(mesh.devices.flat[0])
        if limit is None:
            log("no device memory limit known (the device reports none "
                "and UMGAP_HBM_BYTES is unset): shard sizes are not "
                "checked against device memory")
        elif per_dev_bytes > 0.95 * limit:
            S = manifest["n_shards"]
            need = -(-S * manifest.get("capacity", 0)
                     * 8 // int(0.95 * limit))
            # the advice must be actionable: a valid mesh holds whole
            # shards, so round up to the next divisor of n_shards
            feasible = [d for d in range(need, S + 1) if S % d == 0]
            if feasible:
                advice = (f"serve this artifact on a mesh of "
                          f">= {feasible[0]} devices")
            else:
                advice = (f"even one shard per device exceeds it — "
                          f"rebuild with more shards (>= {need}) via "
                          f"buildindex-dist --shards")
            raise CliError(
                f"each device would hold {per_dev_bytes / 1e9:.1f} GB of "
                f"shard rows but has ~{limit / 1e9:.1f} GB; {advice}")
        # mmap: pages stream disk -> packed rows -> HBM, so cold-start
        # is bounded by the transfer, not an upfront artifact read
        try:
            shards = distbuild.load_shards(workdir, mmap=True)
            stables[False] = ShardedTable.from_shards(shards, mesh,
                                                      axis=mesh_axis)
        except (FileNotFoundError, RuntimeError, ValueError) as e:
            raise CliError(str(e))
        return manifest.get("taxons")

    def load_world(tryptic: bool):
        nonlocal tax
        taxons_path, index_path = args.taxons, args.index
        if not tryptic and sharded and args.shards is not None:
            if False not in stables:
                man_taxons = _load_shards_dir()
                if taxons_path is None and man_taxons and \
                        os.path.exists(man_taxons):
                    taxons_path = man_taxons
            if tax is None:
                if taxons_path is None:
                    from . import configdir as cfg

                    conf = args.configdir or cfg.default_config_dir()
                    version = cfg.discover_version(conf)
                    if version is None:
                        raise CliError(
                            "No taxonomy found: pass --taxons (the "
                            "shards manifest has no usable path)")
                    taxons_path = cfg.resolve(conf, version, "taxons.tsv")
                tax = _load_taxonomy(taxons_path)
            return tax, None
        if taxons_path is None or index_path is None:
            # data-version discovery (umgap-analyse.sh:233-241)
            from . import configdir as cfg

            conf = args.configdir or cfg.default_config_dir()
            version = cfg.discover_version(conf, tryptic=tryptic,
                                           ninemer=not tryptic)
            if version is None:
                raise CliError("No data version found valid for all "
                               "samples. Please run umgap-tpu setup.")
            if taxons_path is None:
                taxons_path = cfg.resolve(conf, version, "taxons.tsv")
            if index_path is None:
                index_path = cfg.resolve(
                    conf, version, "tryptic.npz" if tryptic else "ninemer.npz")
        if tax is None:
            tax = _load_taxonomy(taxons_path)
        if tryptic not in tables:
            table = _load_table(index_path, in_memory=False)
            if (table.kind == "peptide") != tryptic:
                # a pinned --index of the wrong family would otherwise
                # probe garbage and silently emit taxon 1 everywhere
                need = "peptide (tryptic)" if tryptic else "9-mer"
                raise CliError(
                    f"index {index_path} is a {table.kind} index but "
                    f"the preset needs a {need} index")
            tables[tryptic] = table
        if sharded and tryptic not in stables:
            t0 = _time.perf_counter()
            stables[tryptic] = _build_stable(tryptic, tables[tryptic])
            verbose(f"index split over {int(mesh.devices.size)} devices "
                    f"in {_time.perf_counter() - t0:.3f}s (host build and "
                    "transfer issued)")
        return tax, tables[tryptic]

    # Device state and compiled analysers shared across samples: a
    # two-sample run traces/compiles each (preset, batch, length)
    # program once (compiles dominate multi-sample wall time here).
    dev: dict = {}
    analysers: dict = {}
    aux_cache: dict = {}  # jitted steps/analysers of the host-digest and
    #                       FGSpp paths, hot across samples/requests

    def get_analyser(preset: str, tryptic: bool, B: int, L: int, ends: int,
                     stax, stable_):
        if sharded:
            n_dev = int(mesh.devices.size)
            B = -(-B // n_dev) * n_dev  # batches split over the mesh
        key = (preset, B, L, ends)
        a = analysers.get(key)
        if a is None:
            if "dtax" not in dev:
                dev["dtax"] = devagg.DeviceTaxonomy.from_host(stax)
            config = (TRYPTIC_PRESETS if tryptic else PRESETS)[preset]
            if sharded:
                from .parallel import make_sharded_stream_analyser

                a = make_sharded_stream_analyser(
                    stax, stables[tryptic], config, mesh, axis=mesh_axis,
                    tryptic=tryptic, batch_size=B, read_length=L,
                    ends=ends, dtax=dev["dtax"])
            else:
                dk = ("dtable", tryptic)
                if dk not in dev:
                    dev[dk] = lookup.DeviceTable.from_host(stable_)
                cls = TrypticAnalyser if tryptic else Analyser
                a = cls(stax, stable_, config, batch_size=B, read_length=L,
                        ends=ends, dtax=dev["dtax"], dtable=dev[dk])
            analysers[key] = a
        else:
            a.reset()
        return a

    def batch_cap(L: int) -> int:
        # shrink batches as length buckets grow (bounded device batch)
        return max(64, (args.batch_size * args.read_length) // L)

    def run_sample_ring(sample, preset, tryptic, stax, stable_):
        """Fastest ingest: the C++ producer thread parses + encodes +
        4-bit-packs reads into ready device batches (GIL-free); this
        loop only dispatches and drains.  Yields ((hdr_blob, offsets),
        taxa) batches — formatted natively on the output side.  Records
        beyond --read-length re-route to the ladder/chunk path."""
        from .io import native
        from .io.native import NativeBatchStream, StreamUnsupported

        if not native.available() or not hasattr(
                native._lib, "umgap_stream_open"):
            raise StreamUnsupported("native stream unavailable")
        paired = bool(sample["second"])
        ends = 2 if paired else 1
        fmt = "fastq" if paired else "fasta"
        L = args.read_length
        B = max(64, args.batch_size)
        stream = NativeBatchStream(sample["first"], sample["second"],
                                   fmt, L, B)
        try:
            first = stream.next()
            if first is None:
                return
            second = stream.next()  # is the sample one batch long?
            if second is None and first[0] < B:
                B_an = _pow2_bucket(first[0], 64, B)
            else:
                B_an = B
            analyser = get_analyser(preset, tryptic, B_an, L, ends,
                                    stax, stable_)
            B_an = analyser.batch_size  # sharded meshes may round up

            def fit(dna4, lens):
                if B_an <= dna4.shape[0]:
                    return dna4[:B_an], lens[:B_an]
                pad = B_an - dna4.shape[0]
                return (np.pad(dna4, ((0, pad), (0, 0), (0, 0)),
                               constant_values=0x44),
                        np.pad(lens, ((0, pad), (0, 0))))

            batches = itertools.chain(
                [first] if second is None else [first, second],
                iter(stream.next, None))
            for n, dna4, lens, blob, offs, tmax in batches:
                if tmax > L:
                    if tryptic:
                        raise _LongTrypticSample
                    raise _LongNinemerSample
                d4, ln = fit(dna4, lens)
                yield from analyser.feed_packed((blob, offs), d4, ln, n)
            yield from analyser.finish_batches()
        finally:
            stream.close()

    def run_sample_stream(sample, preset, tryptic, stax, stable_):
        """Native streaming path; yields (headers, taxa) batches in
        input order."""
        paired = bool(sample["second"])
        ends = 2 if paired else 1
        ladder = _analyse_width_ladder(args.read_length)
        if tryptic:
            # device digest compile cost scales with width: no ladder —
            # longer records re-route to the host-digest path
            ladder = [args.read_length]
        if paired:
            chunks = iter(stream_paired_chunks(
                sample["first"], sample["second"], args.read_length,
                width_ladder=ladder))
        else:
            chunks = iter(stream_single_chunks(
                sample["first"], args.read_length, "fasta",
                width_ladder=ladder))

        # Pre-buffer up to one full batch to size the batch bucket.
        buffered = []
        total = 0
        exhausted = False
        while total < args.batch_size:
            try:
                ch = next(chunks)
            except StopIteration:
                exhausted = True
                break
            buffered.append(ch)
            total += len(ch[0])
        n_hint = total if exhausted else 1 << 60

        analyser = None
        for headers, dna, lens, tmax in itertools.chain(buffered, chunks):
            Lw = dna.shape[-1]
            if tryptic and tmax > args.read_length:
                raise _LongTrypticSample
            if tmax > ladder[-1]:
                # beyond the top device width bucket: re-route so the
                # oversized records run the exact host path (never clip)
                raise _LongNinemerSample
            if analyser is None or Lw > analyser.read_length:
                if analyser is not None:
                    verbose(f"read-length bucket {analyser.read_length} -> "
                            f"{Lw}: draining and recompiling")
                    yield from analyser.finish_batches()
                B = _pow2_bucket(n_hint, 64, batch_cap(Lw))
                analyser = get_analyser(preset, tryptic, B, Lw, ends,
                                        stax, stable_)
            yield from analyser.feed_batches(headers, dna, lens)
        if analyser is not None:
            yield from analyser.finish_batches()

    def _batchify(records, n: int = 8192):
        hs: list = []
        ts: list = []
        for h, t in records:
            hs.append(h)
            ts.append(t)
            if len(hs) == n:
                yield hs, ts
                hs, ts = [], []
        if hs:
            yield hs, ts

    def run_sample_fallback(sample, preset, tryptic, stax, stable_):
        """Python-reader path (native parser unavailable, exotic record
        shapes, or long tryptic records)."""
        if sample["second"]:
            groups = list(read_groups_fastq(
                [sample["first"], sample["second"]]))
            ends = 2
        else:
            groups = list(_read_groups_fasta(sample["first"]))
            ends = 1
        if tryptic:
            maxlen = max((len(s) for _h, ss in groups for s in ss),
                         default=0)
            if maxlen > args.read_length:
                verbose("tryptic sample has records beyond --read-length; "
                        "using the host-digest path (full-length digest)")
                if "dtax" not in dev:
                    dev["dtax"] = devagg.DeviceTaxonomy.from_host(stax)
                if ("dtable", True) not in dev:
                    dev[("dtable", True)] = \
                        lookup.DeviceTable.from_host(stable_)
                yield from _batchify(analyse_tryptic_groups(
                    groups, stax, stable_, TRYPTIC_PRESETS[preset],
                    batch_size=min(args.batch_size, 1024),
                    dtax=dev["dtax"], dtable=dev[("dtable", True)],
                    step_cache=aux_cache))
                return
        ladder = _analyse_width_ladder(args.read_length)
        cap = ladder[-1]
        long_idx = [i for i, (_h, ss) in enumerate(groups)
                    if max((len(s) for s in ss), default=0) > cap]
        long_results: dict = {}
        if long_idx:
            if stable_ is None:
                raise CliError(
                    "records beyond the device width cap need the host "
                    "table for the exact long-read path; --shards mode "
                    "cannot serve them (pass --index instead)")
            verbose(f"{len(long_idx)} record group(s) beyond {cap} bp: "
                    "exact host path")
            config = (TRYPTIC_PRESETS if tryptic else PRESETS)[preset]
            for i in long_idx:
                long_results[i] = _analyse_long_group_host(
                    groups[i][1], config, ends, stax, stable_, aux_cache)
        short = [g for i, g in enumerate(groups) if i not in long_results]
        maxlen = max((len(s) for _h, ss in short for s in ss), default=0)
        L = next((w for w in ladder if w >= maxlen), ladder[-1])
        B = _pow2_bucket(len(short), 64, batch_cap(L))
        analyser = get_analyser(preset, tryptic, B, L, ends, stax, stable_)
        if not long_results:
            yield from _batchify(analyser.analyse_groups(short))
            return
        # merge host-path results back in input order
        short_res = iter(analyser.analyse_groups(short))

        def merged():
            for i, (header, _seqs) in enumerate(groups):
                if i in long_results:
                    yield header, long_results[i]
                else:
                    yield next(short_res)

        yield from _batchify(merged())

    def raw_read_records(sample):
        """(full header, dna) records for the FGSpp front end — headers
        keep their /1 /2 end markers so uniq -d / merges gene records
        of both ends downstream."""
        from .configdir import sniff_open
        from .io import fastq as fastq_io

        if sample["second"]:
            handles = [sniff_open(p) for p in (sample["first"],
                                               sample["second"])]
            try:
                for group in fastq_io.interleave(
                        [fastq_io.read_records(h) for h in handles]):
                    for rec in group:
                        yield rec.header, rec.sequence
            finally:
                for h in handles:
                    h.close()
        else:
            with sniff_open(sample["first"]) as f:
                for rec in fasta.read_records(f, unwrap=True):
                    yield rec.header, (rec.sequence[0]
                                       if rec.sequence else "")

    def run_sample_fgspp(sample, preset, tryptic, stax, stable_, fg):
        """Gene-prediction front end: reads -> FGSpp subprocess ->
        protein records -> prot2kmer2lca / prot2tryp2lca pipelines
        (umgap-analyse.sh:299-311). Reads FGSpp emits no genes for
        produce no output records, as in the reference."""
        from . import fgspp as fgspp_mod
        from .pipeline.proteins import (
            analyse_protein_groups,
            analyse_tryptic_protein_groups,
        )

        genes = fgspp_mod.predict_genes(fg[0], fg[1],
                                        raw_read_records(sample))
        pgroups = fgspp_mod.group_genes(genes)
        if "dtax" not in dev:
            dev["dtax"] = devagg.DeviceTaxonomy.from_host(stax)
        dk = ("dtable", tryptic)
        if dk not in dev:
            dev[dk] = lookup.DeviceTable.from_host(stable_)
        config = (TRYPTIC_PRESETS if tryptic else PRESETS)[preset]
        if tryptic:
            yield from _batchify(analyse_tryptic_protein_groups(
                pgroups, stax, stable_, config,
                batch_size=min(args.batch_size, 1024),
                dtax=dev["dtax"], dtable=dev[dk], step_cache=aux_cache))
        else:
            yield from _batchify(analyse_protein_groups(
                pgroups, stax, stable_, config,
                batch_size=min(args.batch_size, 1024),
                dtax=dev["dtax"], dtable=dev[dk],
                analyser_cache=aux_cache))

    def run_sample(sample, preset, tryptic, stax, stable_):
        from . import fgspp as fgspp_mod
        from .io import native

        if preset in fgspp_mod.FGSPP_PRESETS and args.fgspp != "never":
            if sharded:
                # the FGSpp protein path probes the single-device table;
                # sharded serving uses the self-contained translation
                # front end (as the reference does without FGSpp)
                if args.fgspp == "require":
                    raise CliError(
                        "--fgspp require is not supported with --mesh; "
                        "run without --mesh or with --fgspp auto")
            else:
                from . import configdir as cfg

                conf = args.configdir or cfg.default_config_dir()
                fg = fgspp_mod.find_fgspp(conf)
                if fg is None and args.fgspp == "require":
                    raise CliError(
                        "FGSpp requested but not installed under the "
                        "config dir (expected FGSpp/FGSpp + FGSpp/train).")
                if fg is not None:
                    verbose(f"gene prediction via FGSpp at {fg[0]}")
                    yield from run_sample_fgspp(sample, preset, tryptic,
                                                stax, stable_, fg)
                    return

        native_ok = False
        try:
            native_ok = native.ensure_built()
        except (OSError, RuntimeError):
            native_ok = False
        from .io.native import StreamUnsupported

        # Tiered ingest: ring stream (C++ producer thread, packed wire)
        # -> chunked native stream (width ladders) -> Python reader.  A
        # tier that meets input it cannot handle exactly re-raises and
        # the next tier restarts the sample; reads already emitted were
        # parsed and analysed correctly (the trigger sits strictly
        # after them in the stream), and all tiers are order-preserving
        # and per-read deterministic — so the rerun skips that prefix.
        tiers = ([run_sample_ring, run_sample_stream] if native_ok
                 else []) + [run_sample_fallback]
        emitted = 0
        for tier_i, tier in enumerate(tiers):
            last = tier_i == len(tiers) - 1
            skip = emitted
            try:
                for hs, ts in tier(sample, preset, tryptic, stax, stable_):
                    n = len(ts) if isinstance(hs, tuple) else len(hs)
                    if skip >= n:
                        skip -= n
                        continue
                    if skip:
                        # blob-header batches are never re-emitted with
                        # a partial skip (the ring tier runs first), so
                        # slicing lists here is always well-defined
                        hs, ts = hs[skip:], ts[skip:]
                        skip = 0
                        n = len(ts) if isinstance(hs, tuple) else len(hs)
                    emitted += n
                    yield hs, ts
                return
            except (StreamUnsupported, _SampleReroute):
                if last:
                    raise
                for a in analysers.values():
                    a.reset()

    import time as _time

    def process_sample(sample, label: str, default_out) -> int:
        """Run one sample end-to-end and write its output (to its -o
        path, or ``default_out``); returns the record count."""
        t_sample = _time.perf_counter()
        preset = sample["type"]
        tryptic = preset in TRYPTIC_PRESETS
        stax, stable = load_world(tryptic)
        results = run_sample(sample, preset, tryptic, stax, stable)

        def write_all(handle):
            # one join per result batch (identical bytes to
            # fasta.Writer's ">hdr\ntaxon\n" records, without the
            # per-record call overhead); ring-stream batches arrive as
            # (header blob, offsets) and format natively in one call
            n = 0
            for hs, ts in results:
                if isinstance(hs, tuple):
                    from .io import native as native_io

                    blob, offs = hs
                    handle.write(
                        native_io.format_output(blob, offs, ts).decode())
                    n += len(ts)
                    continue
                if hasattr(ts, "tolist"):
                    ts = ts.tolist()
                handle.write("".join(
                    f">{h}\n{t}\n" for h, t in zip(hs, ts)))
                n += len(hs)
            return n

        out_path = sample["output"]
        if out_path is None or out_path == "-":
            n_out = write_all(default_out)
        else:
            if sample["compress"]:
                import gzip as gzipmod

                handle = gzipmod.open(out_path, "wt")
            else:
                handle = open(out_path, "w")
            with handle:
                n_out = write_all(handle)
        dt = _time.perf_counter() - t_sample
        verbose(f"analyse sample {label}: {n_out} records in "
                f"{dt:.3f}s ({n_out / max(dt, 1e-9):.0f} records/s)")
        return n_out

    with device_trace(getattr(args, "trace_dir", None)):
        for i, sample in enumerate(samples):
            process_sample(sample, str(i + 1), stdout)
        if getattr(args, "serve", None):
            _serve_analyse(args.serve, process_sample)


def _serve_analyse(socket_path: str, process_sample) -> None:
    """Persistent sample service on a Unix socket — the full-pipeline
    analogue of the reference's socket index service
    (/root/reference/src/commands/prot2kmer2lca.rs:116-137): compiled
    programs and device-resident state stay hot across requests, so
    every sample after the first skips the trace/compile entirely.

    Protocol: one request line per connection, shell-style tokens
    ``-t TYPE -1 R1 [-2 R2] [-z] [-o OUT]`` (repeatable per sample,
    exactly like the CLI). With ``-o`` the reply is ``ok <n>`` per
    sample after the file is written; without it the FASTA streams back
    over the connection. ``quit`` stops the server; per-request errors
    are reported as ``error <msg>`` without killing the service (the
    in-band error line is unambiguous even mid-stream: FASTA replies
    only contain '>'-headers and digit lines)."""
    import shlex
    import socket as socketmod

    from .utils import log

    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    srv = socketmod.socket(socketmod.AF_UNIX)
    srv.bind(socket_path)
    srv.listen(8)
    log(f"analyse service listening on {socket_path}")
    count = 0
    try:
        while True:
            conn, _addr = srv.accept()
            # makefile() wrappers keep the socket alive past `conn`'s
            # close — close them explicitly so the peer sees EOF
            conn.settimeout(30)  # a silent client must not wedge the
            #                      service (request line only; cleared
            #                      before the long-running pipeline)
            rfile = conn.makefile("r")
            wfile = conn.makefile("w")
            stop = False
            try:
                line = rfile.readline()
                conn.settimeout(None)
                if line and line.strip() == "quit":
                    wfile.write("bye\n")
                    wfile.flush()
                    stop = True
                elif line:
                    try:
                        req = _parse_analyse_request(shlex.split(line))
                        for sample in req:
                            count += 1
                            n = process_sample(sample, f"srv-{count}",
                                               wfile)
                            if sample["output"] not in (None, "-"):
                                wfile.write(f"ok {n}\n")
                        wfile.flush()
                    except BrokenPipeError:
                        pass
                    except Exception as e:  # noqa: BLE001 — keep serving
                        try:
                            wfile.write(f"error {e}\n")
                            wfile.flush()
                        except OSError:
                            pass
            except OSError:
                pass  # client vanished mid-handshake: keep serving
            finally:
                for h in (wfile, rfile):
                    try:
                        h.close()
                    except OSError:
                        pass
                conn.close()
            if stop:
                break
    finally:
        srv.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def _parse_analyse_request(tokens):
    """Request tokens -> sample dicts (the socket-service mirror of the
    CLI's repeated -1/-2/-t/-z/-o groups; keep the flag table in sync
    with the per-sample _SampleAction options in build_parser)."""
    from .pipeline import PRESETS, TRYPTIC_PRESETS

    seq = []
    i = 0
    flags = {"-t": "type", "--type": "type", "-1": "first",
             "--first": "first", "-2": "second", "--second": "second",
             "-o": "output", "--output": "output"}
    presets = set(PRESETS) | set(TRYPTIC_PRESETS)
    while i < len(tokens):
        tok = tokens[i]
        if tok in ("-z", "--compress"):
            seq.append(("compress", None))
            i += 1
        elif tok in flags:
            if i + 1 >= len(tokens):
                raise CliError(f"missing value for {tok}")
            val = tokens[i + 1]
            if flags[tok] == "type" and val not in presets:
                raise CliError(
                    f"unknown preset {val!r} (choose from "
                    f"{', '.join(sorted(presets))})")
            seq.append((flags[tok], val))
            i += 2
        else:
            raise CliError(f"unknown request token {tok!r}")
    return _samples_from_seq(seq)


def main(argv=None, stdin=None, stdout=None) -> int:
    args = build_parser().parse_args(argv)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    try:
        args.func(args, stdin, stdout)
    except BrokenPipeError:
        return 0
    except (CliError, agg_host.AggError, ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
