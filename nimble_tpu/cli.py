"""Command line interface.

Parity with the reference CLI surface (`src/bin/cli.yml:5-50`,
`src/bin/main.rs:12-162`):

  nimble-tpu -r lib.json [-r lib2.json ...] -i reads.fastq[.gz] [-i mates.fastq]
             -o out.tsv [-o out2.tsv ...] [-c CORES] [-f STRAND_FILTER]
             [-t LEN:STRICT,...] [-p]

Input classification by extension: .fastq/.fastq.gz -> FASTQ pipeline,
.bam -> BAM pipeline.  The --trim option overrides each library's trim
settings (`main.rs:77-92,108-114`).  Engine selection is device-first: the
batched device engine by default, ``--engine host`` for the NumPy oracle,
``--engine mesh`` for every local device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from nimble_tpu.config import LibraryChemistry
from nimble_tpu.core.calls import HostAlignEngine
from nimble_tpu.index.build import build_index
from nimble_tpu.library import get_reference_sequence_data, load_reference_library
from nimble_tpu.pipeline import bam_pipeline, fastq_pipeline
from nimble_tpu.utils import compile_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nimble-tpu",
        description=(
            "Fast, configurable sequence alignment tool on arbitrary "
            "reference libraries (JAX/XLA)"
        ),
    )
    p.add_argument("-r", "--reference", action="append", required=True,
                   help="Reference library .json file(s)")
    p.add_argument("-o", "--output", action="append", required=True,
                   help="Output TSV file name(s)")
    p.add_argument("-i", "--input", action="append", required=True,
                   help=".fastq.gz/.fastq file(s), or a single .bam file")
    p.add_argument("-c", "--cores", type=int, default=1, dest="num_cores",
                   help="Number of cores to use during alignment")
    p.add_argument("-f", "--strand_filter", default="unstranded",
                   help='One of "unstranded" (default), "fiveprime", '
                        '"threeprime", "none"')
    p.add_argument("-t", "--trim", default=None,
                   help="TARGET_LENGTH:STRICTNESS per library, comma-separated")
    p.add_argument("-p", "--force_bam_paired", action="store_true",
                   help="Skip alignment of unpaired reads in a .bam")
    p.add_argument("--engine", choices=("device", "host", "mesh"), default="device",
                   help="Alignment engine: batched single-device XLA (default), "
                        "NumPy host oracle, or multi-device sharded mesh")
    p.add_argument("--no-parity-quirks", action="store_true",
                   help="Disable reproduction of reference output quirks "
                        "(e.g. dropping the final UMI group of a BAM)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process mode: total jax processes; run one "
                        "CLI per host (or per device, each launched with "
                        "CUDA_VISIBLE_DEVICES=<its device>) with matching "
                        "--process-id")
    p.add_argument("--process-id", type=int, default=None,
                   help="This host's process index (multi-host mode)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for jax.distributed "
                        "(multi-host mode)")
    return p


def main(argv: List[str] | None = None) -> int:
    # persistent XLA compilation cache: the kernel shapes are fixed per
    # (library, bucket), so executables are reused across runs
    compile_cache.enable()

    args = build_parser().parse_args(argv)

    strand_filter = LibraryChemistry.from_cli(args.strand_filter)
    reference_json_paths = args.reference
    output_paths = args.output
    input_files = args.input

    trim_pairs = []
    if args.trim:
        for part in args.trim.split(","):
            length_s, strict_s = part.split(":")
            trim_pairs.append((int(length_s), float(strict_s)))
        if len(trim_pairs) != len(reference_json_paths):
            raise SystemExit(
                "The number of trim options does not match the number of "
                "reference libraries"
            )

    first = input_files[0].lower()
    is_fastq = first.endswith(".fastq") or first.endswith(".fastq.gz")
    is_bam = first.endswith(".bam")

    distributed = args.num_processes is not None and args.num_processes > 1
    if distributed:
        if not (is_fastq or is_bam):
            raise SystemExit(
                "--num-processes applies to FASTQ and BAM inputs only"
            )
        from nimble_tpu.parallel import multihost

        multihost.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    engines = []
    references = []
    aligner_configs = []
    for i, path in enumerate(reference_json_paths):
        print(f"Loading and preprocessing reference data for {path}")
        aligner_config, reference = load_reference_library(path, strand_filter)
        if i < len(trim_pairs):
            length, strictness = trim_pairs[i]
            aligner_config.trim_target_length = length
            aligner_config.trim_strictness = strictness
            print(
                f"Manually setting trim settings for library {path} | "
                f"target length: {length}, strictness: {strictness}"
            )
        seqs, _names = get_reference_sequence_data(reference)
        index = build_index(seqs, num_threads=args.num_cores)
        if args.engine == "device":
            from nimble_tpu.models.aligner import DeviceAlignEngine

            engines.append(DeviceAlignEngine(index, aligner_config))
        elif args.engine == "mesh":
            from nimble_tpu.models.mesh_aligner import MeshAlignEngine

            engines.append(MeshAlignEngine(index, aligner_config))
        else:
            engines.append(HostAlignEngine(index, aligner_config))
        references.append(reference)
        aligner_configs.append(aligner_config)

    print("Loading read sequences and aligning")
    if distributed and is_bam:
        print("Processing as BAM file (multi-host)")
        from nimble_tpu import native
        from nimble_tpu.parallel import multihost

        if not (native.available()
                and all(hasattr(e, "full_dispatch") for e in engines)):
            raise SystemExit(
                "multi-host BAM mode requires the native library and a "
                "device/mesh engine (got --engine host or no native build)"
            )
        multihost.process_bam_multihost(
            input_files[0], engines, references, aligner_configs,
            output_paths, args.force_bam_paired,
            n_hosts=args.num_processes, host_id=args.process_id,
            parity_quirks=not args.no_parity_quirks,
        )
    elif distributed:
        print("Processing as FASTQ file (multi-host)")
        from nimble_tpu.parallel import multihost

        mate = input_files[1] if len(input_files) > 1 else None
        for engine, reference, cfg, out in zip(
            engines, references, aligner_configs, output_paths
        ):
            multihost.process_fastq_multihost(
                input_files[0], engine, reference, cfg, out,
                mate_path=mate,
                n_hosts=args.num_processes, host_id=args.process_id,
            )
    elif is_fastq:
        print("Processing as FASTQ file")
        fastq_pipeline.process(
            input_files, engines, references, aligner_configs, output_paths
        )
    elif is_bam:
        print("Processing as BAM file")
        from nimble_tpu import native

        use_fast = native.available() and all(
            hasattr(e, "full_dispatch") for e in engines
        )
        if use_fast:
            # columnar fast path: byte-identical output (tests/test_bam_fast)
            from nimble_tpu.pipeline.bam_fast import process_fast

            process_fast(
                input_files, engines, references, aligner_configs,
                output_paths, args.num_cores, args.force_bam_paired,
                parity_quirks=not args.no_parity_quirks,
            )
        else:
            bam_pipeline.process(
                input_files, engines, references, aligner_configs,
                output_paths, args.num_cores, args.force_bam_paired,
                parity_quirks=not args.no_parity_quirks,
            )
    else:
        ext = first.rsplit(".", 1)[-1] if "." in first else ""
        raise SystemExit(f"Unsupported file format: {ext}")

    print("Alignment successful, terminating.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
