"""The core call-generation pipeline: score reads, pair them, coerce calls.

Parity ports of:
  * `score_sequences` — `src/align.rs:475-729`
  * `filter_pair`     — `src/align.rs:732-760`
  * `get_calls`       — `src/align.rs:392-467`
  * `score::call` / `sort_score_vector` — `src/score.rs:14-46`, `src/utils.rs:54-59`

Design difference from the reference (same results, batch-shaped): alignment of
the reads happens through a batched ``AlignEngine`` interface instead of one
`pseudoalign` call per read inside the loop, so the device engine can run the
whole batch in fused kernels.  The host engine (`HostAlignEngine`) is the
per-read oracle used for tests and as the rescue path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from nimble_tpu.config import (
    MIN_READ_LENGTH,
    AlignFilterConfig,
    AlignmentOrientation,
    FilterReason,
    PairState,
)
from nimble_tpu.core.features import process_equivalence_class_to_feature_list
from nimble_tpu.core.filters import AlignmentScore, FilterRec, pseudoalign
from nimble_tpu.core.orientation import (
    ResultsMap,
    SequenceCall,
    TriageMap,
    filter_and_coerce_sequence_call_orientations,
)
from nimble_tpu.core.trim import maxinfo_batch, trim_codes
from nimble_tpu.index.build import KmerIndex
from nimble_tpu.library import Reference
from nimble_tpu.utils.dna import decode_bases

# filter_reasons value: ((reason, score), (mate_reason, mate_score))
FilterReasons = Dict[str, Tuple[Tuple[FilterReason, int], Tuple[FilterReason, int]]]
# final merged forensic record (get_calls 3rd return, `src/align.rs:408`)
FinalFilterReasons = Dict[
    str,
    Tuple[
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        FilterReason,
        AlignmentOrientation,
    ],
]
# read_matches entry: (feature_list, read_str, norm_score, score, read_key)
ReadMatch = Tuple[List[str], str, float, int, str]


class AlignEngine(Protocol):
    """Batched alignment interface: trimmed coded reads -> per-read results.

    Entries may be None (skipped reads); their result must be (None, None).
    Each result mirrors `pseudoalign`'s (AlignmentScore?, Filter?) pair.
    """

    def align_batch(
        self, seqs: Sequence[Optional[np.ndarray]]
    ) -> List[Tuple[Optional[AlignmentScore], Optional[FilterRec]]]: ...


class HostAlignEngine:
    """Per-read oracle engine (NumPy walk, exact reference semantics)."""

    def __init__(self, index: KmerIndex, config: AlignFilterConfig):
        self.index = index
        self.config = config

    def align_batch(self, seqs):
        return [
            (None, None) if s is None
            else pseudoalign(s, self.index, self.config, MIN_READ_LENGTH)
            for s in seqs
        ]


def prepare_trimmed(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    metadata: Sequence[List[str]],
    config: AlignFilterConfig,
) -> Tuple[List[Optional[np.ndarray]], List[Optional[np.ndarray]]]:
    """Stage 1 of score_sequences: quality trim + dummy-skip flags
    (`src/align.rs:514-558`).  Skipped (dummy) reads become None entries.

    Factored out so batching callers (e.g. the BAM consumer) can pre-align
    many groups' reads in one engine call with identical inputs.
    """

    def meta_at(i: int) -> List[str]:
        return metadata[i] if i < len(metadata) else []

    # batch the MAXINFO trims (one vectorized pass instead of per-read)
    quals: List[str] = []
    qual_slots: List[Tuple[int, int]] = []  # (read index, mate side)
    for i in range(len(reads)):
        if meta_at(2 * i):
            quals.append(meta_at(2 * i)[1])
            qual_slots.append((i, 0))
        if mate_reads is not None and meta_at(2 * i + 1):
            quals.append(meta_at(2 * i + 1)[1])
            qual_slots.append((i, 1))
    trim_lens: dict = {}
    if quals:
        lengths = maxinfo_batch(
            quals, config.trim_target_length, config.trim_strictness
        )
        for (slot, L) in zip(qual_slots, lengths):
            trim_lens[slot] = int(L)

    trimmed_r1: List[Optional[np.ndarray]] = []
    trimmed_r2: List[Optional[np.ndarray]] = []
    for i in range(len(reads)):
        m1, m2 = meta_at(2 * i), meta_at(2 * i + 1)
        r1 = reads[i]
        t1 = r1[: trim_lens[(i, 0)]] if m1 else r1
        trimmed_r1.append(None if (m1 and m1[37] == "TRUE") else t1)
        if mate_reads is not None:
            r2 = mate_reads[i]
            t2 = r2[: trim_lens[(i, 1)]] if m2 else r2
            trimmed_r2.append(None if (m2 and m2[37] == "TRUE") else t2)
    return trimmed_r1, trimmed_r2


class PrecomputedEngine:
    """Serves pre-aligned results in align_batch call order.

    Used by batching callers that aligned several groups' reads in one bulk
    engine call: per group, score_sequences issues exactly one align_batch
    for R1 and (for paired data) one for R2 — this engine replays the
    precomputed slices in that order.
    """

    def __init__(self, *result_slices):
        self._slices = list(result_slices)

    def align_batch(self, seqs):
        results = self._slices.pop(0)
        assert len(results) == len(seqs)
        return results


def filter_pair(
    sequence_equivalence_class: List[int],
    mate_sequence_equivalence_class: List[int],
) -> bool:
    """True => the pair is invalid (eq classes differ), `src/align.rs:732-760`."""
    if sequence_equivalence_class and mate_sequence_equivalence_class:
        return sorted(sequence_equivalence_class) != sorted(
            mate_sequence_equivalence_class
        )
    return True


def score_sequences(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
    filter_reasons: FilterReasons,
) -> Tuple[Dict[str, SequenceCall], List[ReadMatch]]:
    """Score all reads/pairs and build the score map (`src/align.rs:475-729`).

    ``reads`` / ``mate_reads`` are coded, already orientation-corrected
    sequences; ``sequence_metadata`` holds two rows per read pair (BAM path)
    or is empty (FASTQ path).  Metadata row layout follows
    `BAM_FIELDS_TO_REPORT` (`src/parse/bam.rs:9-49`): [1]=QUAL, [37]=SKIP_ALIGN.
    """
    if mate_reads is not None and len(mate_reads) < len(reads):
        raise ValueError(
            "Error -- read and reverse read files do not have matching lengths: "
        )

    n = len(reads)
    meta = list(sequence_metadata)

    def meta_at(i: int) -> List[str]:
        return meta[i] if i < len(meta) else []

    trimmed_r1, trimmed_r2 = prepare_trimmed(reads, mate_reads, meta, config)
    results_r1 = engine.align_batch(trimmed_r1)
    results_r2 = engine.align_batch(trimmed_r2) if mate_reads is not None else None

    score_map: Dict[str, SequenceCall] = {}
    read_matches: List[ReadMatch] = []

    # Stage 2: per-pair packaging (`src/align.rs:560-726`).
    for i in range(n):
        m1, m2 = meta_at(2 * i), meta_at(2 * i + 1)
        skip1 = bool(m1) and m1[37] == "TRUE"
        seq_alignment, seq_filter = results_r1[i]
        if skip1:
            seq_filter = (FilterReason.SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY, 0.0, 0)

        mate_alignment: Optional[AlignmentScore] = None
        mate_filter: Optional[FilterRec] = None
        read_rev: Optional[np.ndarray] = None
        if mate_reads is not None:
            read_rev = mate_reads[i]
            skip2 = bool(m2) and m2[37] == "TRUE"
            mate_alignment, mate_filter = results_r2[i]
            if skip2:
                mate_filter = (FilterReason.SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY, 0.0, 0)

        if seq_alignment is not None:
            seq_eq, seq_norm, seq_score = seq_alignment
        else:
            seq_eq, seq_norm, seq_score = [], 0.0, 0
        if mate_alignment is not None:
            mate_eq, mate_norm, mate_score = mate_alignment
        else:
            mate_eq, mate_norm, mate_score = [], 0.0, 0

        read_str = decode_bases(reads[i])
        read_key = read_str + decode_bases(read_rev) if read_rev is not None else read_str

        if (
            mate_reads is not None
            and config.require_valid_pair
            and filter_pair(seq_eq, mate_eq)
        ):
            filter_reasons[read_key] = (
                (FilterReason.NOT_MATCHING_PAIR, seq_score),
                (FilterReason.NOT_MATCHING_PAIR, mate_score),
            )
            continue

        filter_reasons[read_key] = (
            (seq_filter[0] if seq_filter is not None else FilterReason.SUCCESSFUL_MATCH,
             seq_score),
            (mate_filter[0] if mate_filter is not None else FilterReason.SUCCESSFUL_MATCH,
             mate_score),
        )

        if seq_eq or mate_eq:
            if seq_eq:
                feature_list = process_equivalence_class_to_feature_list(
                    seq_eq, reference, config, False
                )
            elif mate_eq:
                feature_list = process_equivalence_class_to_feature_list(
                    mate_eq, reference, config, False
                )
            else:
                feature_list = []

            if seq_eq and mate_eq:
                pair_score: SequenceCall = (
                    PairState.BOTH,
                    (seq_eq, seq_norm),
                    (mate_eq, mate_norm),
                    m1,
                    m2,
                )
                rm_norm, rm_score = seq_norm, seq_score
            elif seq_eq:
                pair_score = (PairState.FIRST, (seq_eq, seq_norm), None, m1, m2)
                rm_norm, rm_score = seq_norm, seq_score
            else:
                pair_score = (PairState.SECOND, None, (mate_eq, mate_norm), m1, m2)
                rm_norm, rm_score = mate_norm, mate_score

            if pair_score[0] in (PairState.FIRST, PairState.BOTH):
                read_matches.append(
                    (list(feature_list), read_str, rm_norm, rm_score, read_key)
                )
            elif pair_score[0] == PairState.SECOND and read_rev is not None:
                read_matches.append(
                    (list(feature_list), decode_bases(read_rev), rm_norm, rm_score, read_key)
                )

            score_map[read_key] = pair_score
        else:
            # Both empty: report the failed alignment (`src/align.rs:687-725`).
            if mate_reads is not None:
                if seq_filter is not None and mate_filter is not None:
                    _, s, ns = seq_filter
                    _, r, nr = mate_filter
                    # all arms reduce to picking the larger normalized score
                    # (`src/align.rs:690-705`)
                    if seq_filter[0] == mate_filter[0]:
                        failed_score, failed_raw = s, ns
                    else:
                        failed_score, failed_raw = (s, ns) if s > r else (r, nr)
                elif mate_filter is not None:
                    failed_score, failed_raw = mate_filter[1], mate_filter[2]
                elif seq_filter is not None:
                    failed_score, failed_raw = seq_filter[1], seq_filter[2]
                else:
                    failed_score, failed_raw = 0.0, 0
            else:
                if seq_filter is not None:
                    failed_score, failed_raw = seq_filter[1], seq_filter[2]
                else:
                    failed_score, failed_raw = 0.0, 0

            read_matches.append(([], read_str, failed_score, failed_raw, ""))

    return score_map, read_matches


def get_calls(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
) -> Tuple[
    List[Tuple[List[str], Tuple[int, List[str], List[str]]]],
    List[ReadMatch],
    FinalFilterReasons,
]:
    """Full call pipeline for a batch of reads (`src/align.rs:392-467`)."""
    filter_reasons: FilterReasons = {}
    post_triaged_keys: TriageMap = {}

    score_map, read_matches = score_sequences(
        reads, mate_reads, sequence_metadata, engine, reference, config, filter_reasons
    )

    results: ResultsMap = {}
    for read_pair_key, call in score_map.items():
        filter_and_coerce_sequence_call_orientations(
            call, results, reference, config, read_pair_key, post_triaged_keys
        )

    final_filter_reasons: FinalFilterReasons = {}
    none_rec = (FilterReason.NONE, 0)
    for key, value in filter_reasons.items():
        triage = post_triaged_keys.get(key)
        if triage is not None:
            final_filter_reasons[key] = (
                value[0], value[1], none_rec, none_rec, triage[0], triage[1]
            )
        else:
            final_filter_reasons[key] = (
                value[0], value[1], none_rec, none_rec,
                FilterReason.NONE, AlignmentOrientation.NONE,
            )

    ret = [
        (list(callset), (entry[0], entry[1], entry[2]))
        for callset, entry in results.items()
    ]
    return ret, read_matches, final_filter_reasons


def sort_score_vector(scores):
    """Sort results by feature-callset (`src/utils.rs:54-59`): Vec<String> order
    == Python list-of-str lexicographic order."""
    return sorted(scores, key=lambda x: x[0])


def call(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    per_sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
):
    """Scoring facade (`src/score.rs:14-46`): get_calls + name-sort."""
    reference_scores, alignment_metadata, filter_reasons = get_calls(
        reads, mate_reads, per_sequence_metadata, engine, reference, config
    )
    return sort_score_vector(reference_scores), alignment_metadata, filter_reasons
