"""umgap_tpu — a metagenomics analysis framework on JAX accelerators.

A ground-up reimplementation of the capabilities of UMGAP (Unipept
MetaGenomics Analysis Pipeline) for an accelerator (an NVIDIA H100):
JAX/XLA compute over dense integer tensors, a sharded device-resident
k-mer index instead of an mmap'd FST, and fused single-program
pipelines instead of 20 processes glued with Unix pipes.

Layout:

- ``ranks`` / ``taxonomy``: the NCBI taxonomy as dense arrays.
- ``agg``: per-read consensus aggregators (LCA*, MRTL, hybrids) — exact
  host oracles in ``agg.host`` and batched device versions in
  ``agg.device``.
- ``io``: FASTA/FASTQ readers/writers with reference-equivalent record
  semantics.
- ``ops``: device ops — 6-frame translation, k-mer packing, seed-extend,
  lookup probes.
- ``index``: offline index build (splitkmers/joinkmers/buildindex
  equivalents) and the packed hash-table index format.
- ``pipeline``: the six preset analysis pipelines, fused.
- ``parallel``: mesh/sharding utilities for multi-device runs.
- ``cli``: the ``umgap-tpu`` command-line surface mirroring all 20
  reference subcommands.
"""

__version__ = "0.1.0"
