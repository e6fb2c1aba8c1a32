"""BAM workload orchestration: 3-stage threaded pipeline.

Parity port of `bam::process` (`src/process/bam.rs:45-243`):

  * PRODUCER thread streams UMI×CB groups (UMIReader) into a bounded queue
    of 50 groups (`MAX_UMIS_IN_CHANNEL`, `:20,149`);
  * ``num_cores - 1`` CONSUMER threads align each group against every
    library (`align_umi_to_libraries`, `:305-405`) — with the device engine
    a "consumer" dispatches device batches, so one consumer usually
    saturates a device and extra consumers overlap host prep with device
    compute;
  * a LOGGER thread writes one gzipped TSV per library and validates the
    gzip by full re-decompression at the end (`validate_gzip`, `:425-435`).

Reproduced reference quirks (all observable in output, kept for parity —
disable with ``parity_quirks=False``):
  * the r1/r2 metadata column blocks are SWAPPED and the r1/r2 filter
    columns cross over (`:103-120`: the "r1 bam data" block is written from
    the mate metadata and r1_filter_forward from the R2 filter record);
  * the FINAL UMI group of a multi-group BAM is never sent to the aligner
    (`:163-179`: the producer breaks on the exhausted read before sending
    the group buffered by that call);
  * a read-pair whose callset was also called by a later pair in the same
    UMI group gets an extra zero-score row (scored_qnames only remembers
    the LAST pair's qname per distinct callset, `:332-353`).
"""

from __future__ import annotations

import gzip
import queue
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from nimble_tpu.config import (
    AlignFilterConfig,
    AlignmentOrientation,
    FilterReason,
)
from nimble_tpu.core.calls import (
    AlignEngine,
    PrecomputedEngine,
    call,
    prepare_trimmed,
)
from nimble_tpu.io.umi import BAM_FIELDS_TO_REPORT, UMIReader
from nimble_tpu.library import Reference
from nimble_tpu.utils.dna import encode_bases, revcomp

MAX_UMIS_IN_CHANNEL = 50  # `src/process/bam.rs:20`

_NONE_REC = (FilterReason.NONE, 0)


def bam_data_values(bam_data: List[str]) -> str:
    """Metadata row minus QUAL (1) and SEQ (15), tab-joined (`:22-31`)."""
    return "\t".join(
        v for i, v in enumerate(bam_data) if i != 1 and i != 15
    )


def bam_data_header(prefix: str) -> str:
    """Header for a metadata block (`:33-42`)."""
    return "\t".join(
        f"{prefix}_{f}"
        for i, f in enumerate(BAM_FIELDS_TO_REPORT)
        if i != 1 and i != 15
    )


FILTER_HEADER = (
    "r1_filter_forward\tr1_forward_score\tr1_filter_reverse\tr1_reverse_score\t"
    "r2_filter_forward\tr2_forward_score\tr2_filter_reverse\tr2_reverse_score\t"
    "triage_reason\taligndirection"
)


def parse_str_as_bool(v: str) -> bool:
    """`src/process/bam.rs:417-423`."""
    if v == "true":
        return True
    if v == "false":
        return False
    raise ValueError(f'Could not parse revcomp field "{v}" as boolean')


def reverse_comp_if_needed(seq: str, rev: bool) -> str:
    """`src/process/bam.rs:407-415`."""
    return revcomp(seq) if rev else seq


def align_umi_to_libraries(
    umi_seqs: List[str],
    umi_metadata: List[List[str]],
    engines: Sequence[AlignEngine],
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
):
    """Score one UMI group against every library (`src/process/bam.rs:305-405`).

    Returns, per library, a list of
    (features, (count, r1_meta, r2_meta, v0, v1, v2, v3, triage, orientation)).
    """
    results = []
    reverse_flags = [parse_str_as_bool(m[2]) for m in umi_metadata]
    oriented = [
        encode_bases(reverse_comp_if_needed(s, r))
        for s, r in zip(umi_seqs, reverse_flags)
    ]
    r1_reads = oriented[0::2]
    r2_reads = oriented[1::2]

    for i, engine in enumerate(engines):
        s, _, filter_reasons = call(
            r1_reads, r2_reads, umi_metadata, engine, references[i],
            aligner_configs[i],
        )

        if len(s) == 0:
            results.append([])
            continue

        # qname of each distinct callset's LAST-written pair (`:335-338`)
        scored_qnames = [entry[1][0] for _, entry in s]

        non_matching = []
        for j in range(0, len(umi_metadata), 2):
            if j + 1 < len(umi_metadata):
                pair = (umi_metadata[j], umi_metadata[j + 1])
                qname = pair[1][0]
                if qname in scored_qnames:
                    continue
                non_matching.append(([], (0, pair[0], pair[1])))
        s = list(s) + non_matching

        transformed = []
        for features, entry in s:
            count, m1, m2 = entry[0], entry[1], entry[2]
            r1_key = reverse_comp_if_needed(m1[15], parse_str_as_bool(m1[2]))
            r2_key = reverse_comp_if_needed(m2[15], parse_str_as_bool(m2[2]))
            v = filter_reasons.get(r1_key + r2_key)
            if v is not None:
                rec = (count, m1, m2, v[0], v[1], v[2], v[3], v[4], v[5])
            else:
                rec = (
                    count, m1, m2,
                    _NONE_REC, _NONE_REC, _NONE_REC, _NONE_REC,
                    FilterReason.NONE, AlignmentOrientation.NONE,
                )
            transformed.append((features, rec))
        results.append(transformed)

    return results


def _oriented_reads(umi_seqs, umi_metadata):
    """Orientation-corrected coded R1/R2 lists (`src/process/bam.rs:260-292`)."""
    reverse_flags = [parse_str_as_bool(m[2]) for m in umi_metadata]
    oriented = [
        encode_bases(reverse_comp_if_needed(s, r))
        for s, r in zip(umi_seqs, reverse_flags)
    ]
    return oriented[0::2], oriented[1::2]


def align_groups_batched(
    groups: List[Tuple[List[str], List[List[str]]]],
    engines: Sequence[AlignEngine],
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
):
    """Align many UMI groups with ONE bulk engine call per library+mate.

    Per-group device dispatch is prohibitively latency-bound (a UMI group is
    a handful of reads); this batches the trimmed reads of all ``groups``
    into single align_batch calls and replays the per-group slices through
    `PrecomputedEngine`, so the per-group logic (pairing, forensics, output
    quirks) is byte-identical to the unbatched path.

    Returns a list over groups of align_umi_to_libraries results.
    """
    prepared = [_oriented_reads(s, m) for s, m in groups]
    # concatenate all groups' reads+metadata so trimming (one vectorized
    # MAXINFO pass) and alignment (one device batch) run once per batch
    cat_r1, cat_r2, cat_meta, splits = [], [], [], []
    for (r1, r2), (_, meta) in zip(prepared, groups):
        if len(r2) < len(r1):
            # SortedBamReader guarantees paired interleaving; a short mate
            # list would corrupt the concatenation
            raise ValueError(
                "Error -- read and reverse read files do not have matching lengths: "
            )
        splits.append(len(r1))
        cat_r1.extend(r1)
        cat_r2.extend(r2)
        cat_meta.extend(meta)

    per_lib_slices = []
    for i, engine in enumerate(engines):
        cfg = aligner_configs[i]
        all_t1, all_t2 = prepare_trimmed(cat_r1, cat_r2, cat_meta, cfg)
        res1 = engine.align_batch(all_t1)
        res2 = engine.align_batch(all_t2)
        slices = []
        o = 0
        for m in splits:
            slices.append((res1[o : o + m], res2[o : o + m]))
            o += m
        per_lib_slices.append(slices)

    out = []
    for g, (umi_seqs, umi_metadata) in enumerate(groups):
        group_engines = [
            PrecomputedEngine(per_lib_slices[i][g][0], per_lib_slices[i][g][1])
            for i in range(len(engines))
        ]
        out.append(
            align_umi_to_libraries(
                umi_seqs, umi_metadata, group_engines, references, aligner_configs
            )
        )
    return out


def format_log_row(features: List[str], rec) -> str:
    """One forensic TSV row, incl. the r1/r2 swap quirk (`:103-120`)."""
    count, m1, m2, v0, v1, v2, v3, triage, orientation = rec
    return "\t".join(
        [
            ",".join(features),
            str(count),
            bam_data_values(m2),   # "r1 bam data" block <- mate metadata (quirk)
            bam_data_values(m1),   # "r2 bam data" block <- r1 metadata (quirk)
            str(v1[0]), str(v1[1]),  # r1_filter_forward <- R2 filter record (quirk)
            str(v3[0]), str(v3[1]),  # r1_filter_reverse <- placeholder
            str(v0[0]), str(v0[1]),  # r2_filter_forward <- R1 filter record (quirk)
            str(v2[0]), str(v2[1]),  # r2_filter_reverse <- placeholder
            str(triage),
            str(orientation),
        ]
    )


def log_header() -> str:
    return (
        "nimble_features\tnimble_score\t"
        + bam_data_header("r1")
        + "\t"
        + bam_data_header("r2")
        + "\t"
        + FILTER_HEADER
    )


def validate_gzip(path: str) -> None:
    """Full re-decompression check (`src/process/bam.rs:425-435`)."""
    with gzip.open(path, "rb") as f:
        while f.read(1 << 20):
            pass
    print(f"Validation successful for {path}")


def process(
    input_files: Sequence[str],
    engines: Sequence[AlignEngine],
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
    output_paths: Sequence[str],
    num_cores: int,
    force_bam_paired: bool,
    parity_quirks: bool = True,
    group_batch: int = 32,
) -> None:
    log_queue: "queue.Queue" = queue.Queue()
    work_queue: "queue.Queue" = queue.Queue(maxsize=MAX_UMIS_IN_CHANNEL)

    def logger() -> None:
        print("Spawning logging thread.")
        # compresslevel 6 = flate2's Compression::default() in the reference
        # (`src/process/bam.rs:73`); Python's default 9 is ~5x slower
        files = [gzip.open(p, "wt", compresslevel=6) for p in output_paths]
        first_write = [True] * len(files)
        while True:
            msg = log_queue.get()
            if msg is None:
                break
            (features, rec), index = msg
            if first_write[index]:
                print(f"Writing header for file {index}")
                files[index].write(log_header() + "\n")
                first_write[index] = False
            files[index].write(format_log_row(features, rec) + "\n")
        for i, f in enumerate(files):
            f.close()
            print(f"Successfully flushed and closed file {i}")
        for p in output_paths:
            print(f"Validating GZIP file: {p}")
            validate_gzip(p)
        print("Logging thread terminating.")

    def producer() -> None:
        print("Spawning reader thread.")
        reader = UMIReader(input_files[0], False, force_bam_paired)
        has_aligned = False
        while True:
            final_umi = reader.next()
            if final_umi and has_aligned:
                if not parity_quirks and reader.current_umi_group:
                    # correctness mode: don't drop the final UMI group
                    work_queue.put(
                        (list(reader.current_umi_group),
                         list(reader.current_metadata_group))
                    )
                print("Finished reading UMIs from input file.")
                break
            work_queue.put(
                (list(reader.current_umi_group), list(reader.current_metadata_group))
            )
            has_aligned = True

    def consumer(thread_num: int) -> None:
        while True:
            data = work_queue.get()
            if data is None:
                break
            # drain additional queued groups so the device aligns them in one
            # bulk call (per-group dispatch is latency-bound)
            groups = [data]
            while len(groups) < group_batch:
                try:
                    more = work_queue.get_nowait()
                except queue.Empty:
                    break
                if more is None:
                    work_queue.put(None)  # preserve shutdown signal
                    break
                groups.append(more)

            from nimble_tpu.utils.metrics import METRICS

            n_records = sum(len(g[0]) for g in groups)
            with METRICS.meter("bam_align").measure(n_records):
                batch_results = align_groups_batched(
                    groups, engines, references, aligner_configs
                )
            for results in batch_results:
                for i, library_scores in enumerate(results):
                    for score in library_scores:
                        log_queue.put((score, i))

    # worker exceptions are captured and re-raised from the main thread —
    # a dying thread must fail the run (the reference panics), not silently
    # truncate the output
    errors: list = []

    def guarded(fn, *fn_args):
        try:
            fn(*fn_args)
        except BaseException as e:  # noqa: BLE001 — re-raised in main
            errors.append(e)

    def consumer_guarded(tn: int) -> None:
        try:
            consumer(tn)
        except BaseException as e:  # noqa: BLE001 — re-raised in main
            errors.append(e)
            # keep the shutdown protocol alive: drain work until this
            # consumer's own None sentinel (main puts one per consumer)
            while True:
                msg = work_queue.get()
                if msg is None:
                    break

    log_thread = threading.Thread(target=guarded, args=(logger,))
    log_thread.start()

    producer_thread = threading.Thread(target=guarded, args=(producer,))
    producer_thread.start()

    num_consumers = num_cores - 1 if num_cores > 1 else num_cores
    consumers = []
    for t in range(num_consumers):
        print(f"Spawning consumer thread {t}")
        th = threading.Thread(target=consumer_guarded, args=(t,))
        th.start()
        consumers.append(th)

    from nimble_tpu.utils.metrics import METRICS

    producer_thread.join()
    print("Joined on producer.")
    for _ in consumers:
        work_queue.put(None)
    for th in consumers:
        th.join()
        print("Joined on consumer.")
    log_queue.put(None)
    log_thread.join()
    if errors:
        raise errors[0]
    meter = METRICS.meter("bam_align")
    if meter.items:
        print(meter.summary())
    print("Joined on logging; terminating.")
