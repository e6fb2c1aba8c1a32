"""nimble_tpu — a JAX pseudoalignment-and-counting engine.

A from-scratch reimplementation of the capabilities of BimberLab/nimble-aligner
(the reference is a Rust CLI) designed accelerator-first:

* The hot inner loop (k-mer anchored, mismatch-tolerant read↔library matching,
  reference `src/align.rs:945` `pseudoalign` + the external `debruijn_mapping`
  crate's `map_read_with_mismatch`) runs as batched XLA kernels over
  2-bit-packed reads against a device-resident k-mer hash index.
* Host code (Python + C++ native ops) handles IO (FASTQ/BAM), UMI group-by,
  config, and the tiny string-shaped tail of the pipeline (orientation /
  chemistry filtering, group rollup, TSV output) for exact output parity.
* Scaling is data-parallel over reads via `jax.sharding.Mesh` + `shard_map`,
  with per-feature count vectors merged by `jax.lax.psum`.

Package layout:
  config       — aligner configuration (reference `src/align.rs:79-103`)
  library      — reference library JSON loader (reference `src/reference_library.rs`)
  index        — k-mer index build: host tables + device arrays
  core         — alignment semantics: walk oracle, filters, orientation, calls
  ops          — device compute: packing, XLA engine, Pallas kernels
  models       — the end-to-end "aligner model": batched device pipeline
  parallel     — mesh / sharded execution / collective count merge
  io           — FASTQ, BGZF/BAM readers and TSV writers
  pipeline     — FASTQ and BAM workload orchestration (reference `src/process/`)
  cli          — command line interface (reference `src/bin/cli.yml`)
"""

__version__ = "0.1.0"

from nimble_tpu.config import (  # noqa: F401
    AlignFilterConfig,
    FilterReason,
    IntersectLevel,
    LibraryChemistry,
    PairState,
    AlignmentOrientation,
)
from nimble_tpu.library import Reference, load_reference_library  # noqa: F401
