"""Benchmark: fused 9-mer pipeline throughput on one GPU.

Measures read-pairs/second of the high-sensitivity preset
(translate -a | prot2kmer2lca -o | seedextend -g1 -s3 | uniq |
taxa2agg hybrid f=0.25) as one fused jitted program, over the shared
workload produced by scripts/gen_bench_workload.py: 32768 100bp read
pairs with realistic index hit rates (coding-frame k-mers planted in a
2M-key index) and a 20k-node taxonomy.

Reported: end-to-end pairs/s (host wire -> device -> result on host,
depth-2 dispatch as in the production runner) as the headline `value`,
the median of three windows; the `analyse` CLI's steady-state rate;
device-resident throughput and a per-stage breakdown in `extra`. Every
timed region ends in ``jax.block_until_ready``.

The CLI leg runs first, in a child process, before this process touches
the card: a JAX process reserves most of the card's memory at first
use, so a child started later would fail for want of it.

Prints ONE JSON line: {"metric", "value", "unit", "extra": {"device"...}}.
Exits non-zero when JAX finds no GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".bench_data")

# tuned on an earlier accelerator, not yet measured on this card
BATCH = 16384


def ensure_workload():
    if not os.path.exists(os.path.join(DATA, "manifest.json")):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "gen_bench_workload.py")],
                       check=True)
    with open(os.path.join(DATA, "manifest.json")) as f:
        return json.load(f)


def load(name, dtype):
    return np.fromfile(os.path.join(DATA, name), dtype=dtype)


def write_taxons_tsv(path, parent, snap, n_tax):
    """The workload taxonomy as a taxon TSV (written once)."""
    from umgap_tpu import ranks

    if os.path.exists(path):
        return
    with open(path + ".tmp", "w") as f:
        f.write("1\troot\tno rank\t1\t\x01\n")
        for i in range(2, n_tax + 1):
            rank = "no rank" if i % 3 else ranks.rank_name(14)
            valid = "\x01" if snap[i] == i else "\x00"
            f.write(f"{i}\tt{i}\t{rank}\t{int(parent[i])}\t{valid}\n")
    os.replace(path + ".tmp", path)


def write_fastq_pairs(paths, reads, reps: int = 1):
    """(P, 2, L) DNA codes as paired FASTQ files ``paths`` (one per end),
    the pairs repeated ``reps`` times; existing files are kept."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    L = reads.shape[-1]
    qual = b"I" * L
    for end, path in enumerate(paths):
        if os.path.exists(path):
            continue
        seqs = lut[np.minimum(reads[:, end], 4)]  # (P, L) ascii
        with open(path + ".tmp", "wb") as f:
            for rep in range(reps):
                for i in range(len(seqs)):
                    f.write(b"@x%dr%d/%d\n" % (rep, i, end + 1))
                    f.write(seqs[i].tobytes())
                    f.write(b"\n+\n")
                    f.write(qual)
                    f.write(b"\n")
        os.replace(path + ".tmp", path)


def run_cli_leg(L):
    """The workload through `python -m umgap_tpu analyse` (native parse ->
    streamed 16k batches -> depth-2 dispatch). Four identical samples in
    one invocation, each 4x the pairs so a sample spans 8 full batches:
    sample 1 pays the trace/compile, samples 2+ run the cached program —
    the steady-state rate a long-running analyse job sees. Returns the
    per-sample records/s."""
    argv = [sys.executable, "-m", "umgap_tpu", "analyse"]
    for _ in range(4):
        argv += ["-t", "high-sensitivity",
                 "-1", os.path.join(DATA, "A1x4.fq"),
                 "-2", os.path.join(DATA, "A2x4.fq"),
                 "-o", os.devnull]
    argv += ["--taxons", os.path.join(DATA, "taxons.tsv"),
             "--index", os.path.join(DATA, "nine.npz"),
             "--read-length", str(L)]
    r = subprocess.run(argv, env=dict(os.environ, VERBOSE="1"), cwd=REPO,
                       capture_output=True, text=True, timeout=3600)
    rates = [float(line.rsplit("(", 1)[1].split(" ")[0])
             for line in r.stderr.splitlines()
             if "analyse sample" in line and "records/s" in line]
    if r.returncode != 0 or len(rates) != 4:
        raise RuntimeError(f"CLI leg failed (rc={r.returncode}, "
                           f"rates={rates}): {r.stderr[-2000:]}")
    return rates


def main():
    t_start = time.perf_counter()

    def eprint(msg):
        print(f"[bench +{time.perf_counter() - t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    manifest = ensure_workload()
    from umgap_tpu import ranks
    from umgap_tpu.index.table import build_kmer_table
    from umgap_tpu.taxonomy import Taxon, Taxonomy
    from umgap_tpu.utils import enable_compile_cache

    P = manifest["n_pairs"]
    L = manifest["read_len"]
    n_tax = manifest["n_tax"]

    # --- host-side world: taxonomy, index, CLI inputs ------------------ #
    parent = load("parent.bin", np.int32)
    snap = load("snap.bin", np.int32)
    taxa = [Taxon(i, f"t{i}", ranks.NO_RANK if i % 3 else 14,
                  int(parent[i]), bool(snap[i] == i))
            for i in range(1, n_tax + 1)]
    tax = Taxonomy(taxa)
    keys = load("index_keys.bin", np.uint64)
    vals = load("index_vals.bin", np.int32)
    t0 = time.perf_counter()
    table = build_kmer_table(keys, vals, k=9)
    build_s = time.perf_counter() - t0
    reads = load("reads.bin", np.uint8).reshape(P, 2, L)

    nine = os.path.join(DATA, "nine.npz")
    if not os.path.exists(nine):
        table.save(nine)
    write_taxons_tsv(os.path.join(DATA, "taxons.tsv"), parent, snap, n_tax)
    write_fastq_pairs([os.path.join(DATA, "A1x4.fq"),
                       os.path.join(DATA, "A2x4.fq")], reads, reps=4)

    # --- CLI leg, before this process opens the card -------------------- #
    cli_rates = None
    if not os.environ.get("SKIP_CLI_BENCH"):
        eprint("running CLI bench (4 samples, 1 compile)...")
        cli_rates = run_cli_leg(L)
        eprint(f"CLI per-sample rates: {cli_rates}")

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from umgap_tpu.agg import device as devagg
    from umgap_tpu.ops import encoding as enc
    from umgap_tpu.ops import kmers as kmerops
    from umgap_tpu.ops import lookup, translate
    from umgap_tpu.pipeline import PRESETS
    from umgap_tpu.pipeline.fused import pipeline_step

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    dtax = devagg.DeviceTaxonomy.from_host(tax)
    dtable = lookup.DeviceTable.from_host(table)
    n_batches = P // BATCH
    lengths_np = np.full((BATCH, 2), L, dtype=np.int32)
    batches_p4 = [enc.pack_dna4(reads[i * BATCH:(i + 1) * BATCH])
                  for i in range(n_batches)]

    # The production k_max (64): reads with more distinct hit taxa are
    # detected on device and re-routed through a wide program by the
    # runner; the workload's overflow count is reported below.
    config = PRESETS["high-sensitivity"]
    tt = enc.get_table(config.table_number)

    # --- device-resident stage timings ---------------------------------- #
    ddna = [jax.device_put(reads[i * BATCH:(i + 1) * BATCH])
            for i in range(n_batches)]
    dlen = jax.device_put(lengths_np)

    def stage_translate(dna, lengths, dtable, dtax):
        B, E, l = dna.shape
        aa, plens = translate.translate6_batch(
            dna.reshape(B * E, l), lengths.reshape(B * E), tt)
        return aa.astype(jnp.int32).sum() + plens.sum()

    def stage_probe(dna, lengths, dtable, dtax):
        B, E, l = dna.shape
        aa, plens = translate.translate6_batch(
            dna.reshape(B * E, l), lengths.reshape(B * E), tt)
        hi, lo, wvalid = kmerops.pack_windows_batch(aa, plens, config.k)
        taxa_, found = lookup.probe(dtable, hi, lo, valid=wvalid, default=0)
        return taxa_.sum() + found.sum()

    def stage_full(dna, lengths, dtable, dtax):
        # one program yields both the timing and the k_max-overflow
        # count: a 2-vector [checksum, overflows]
        taxon, ov = pipeline_step(dna, lengths, dtax, dtable, config,
                                  with_overflow=True)
        return jnp.stack([taxon.sum(), ov.sum().astype(jnp.int32)])

    stages = {"translate": stage_translate, "probe": stage_probe,
              "full": stage_full}
    stage_times = {}
    n_overflow = 0
    for name, fn in stages.items():
        jfn = jax.jit(fn)
        eprint(f"compiling {name}...")
        jax.block_until_ready(jfn(ddna[0], dlen, dtable, dtax))
        reps = 20
        t0 = time.perf_counter()
        for i in range(reps):
            acc = jfn(ddna[i % n_batches], dlen, dtable, dtax)
        jax.block_until_ready(acc)
        stage_times[name] = (time.perf_counter() - t0) / reps
        if name == "full":
            n_overflow = int(acc[1])
    device_pairs_per_s = BATCH / stage_times["full"]

    # --- end-to-end over the 4-bit wire with depth-2 dispatch ----------- #
    @jax.jit
    def step_wire(dna4, lengths, dtable, dtax):
        dna = enc.unpack_dna4_device(dna4, L)
        return pipeline_step(dna, lengths, dtax, dtable, config)

    eprint("compiling wire step...")
    jax.block_until_ready(step_wire(batches_p4[0], lengths_np, dtable, dtax))

    def window(n_steps):
        t0 = time.perf_counter()
        inflight = []
        for i in range(n_steps):
            inflight.append(step_wire(batches_p4[i % n_batches],
                                      lengths_np, dtable, dtax))
            if len(inflight) > 2:
                np.asarray(inflight.pop(0))
        for x in inflight:
            np.asarray(x)
        return n_steps * BATCH / (time.perf_counter() - t0)

    wire_samples = [window(16 * n_batches) for _ in range(3)]
    e2e_pairs_per_s = float(np.median(wire_samples))

    result = {
        "metric": "high_sensitivity_pairs_per_s",
        "value": e2e_pairs_per_s,
        "unit": "read pairs/s",
        "extra": {
            "device": device,
            "wire_e2e_windows": wire_samples,
            "device_resident_pairs_per_s": device_pairs_per_s,
            "cli_per_sample_rates": cli_rates,
            "cli_steady_state_median": (float(np.median(cli_rates[1:]))
                                        if cli_rates else None),
            f"stage_ms_per_{BATCH}_pairs": {
                k: v * 1e3 for k, v in stage_times.items()},
            "k_max": config.k_max,
            "k_max_overflow_reads": n_overflow,
            "table_layout": f"bucket{dtable.bucket}"
                            f"(stash={int(dtable.stash.shape[0])})",
            "table_build_s": build_s,
            "n_keys": manifest["n_keys"],
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
