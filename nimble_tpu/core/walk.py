"""Host oracle for the mismatch-tolerant pseudoalignment walk.

The reference's innermost hot loop is
``Pseudoaligner::map_read_with_mismatch(seq, num_mismatches)
-> Option<(Vec<u32> eq_class, usize score, usize mismatches)>``
from the external `debruijn_mapping` fork (`src/align.rs:21,965`), a colored
de-Bruijn-graph walk.  Its semantics were pinned from the in-repo oracles:

  * a 32 bp read exactly matching one 32 bp reference row yields
    eq_class=[row], score=32, normalized=1.0 (`src/align.rs:1089-1097`)
    => score counts MATCHED BASES (k-mer anchor k=30 + per-base extension);
  * `tests/basic-cases.rs` seq3 (clean 100 bp prefix + 14 bp junk tail) is
    called at num_mismatches=2 but NOT at 0 or 1
    => every mismatching base along the walk is counted, and reads whose
       mismatch count exceeds the allowance are rejected downstream by
       `filter_alignment_by_metrics`'s `mismatches > num_mismatches` arm
       (`src/filter/align.rs:27`) — which is also why that filter arm exists;
  * `tests/basic-cases.rs` seq2 at num_mismatches>=1 still calls only A02-1
    => at branch points where the read matches SOME candidate row, rows that
       do not match drop out (mismatch tolerance applies only where NO live
       row matches the read base, i.e. where the graph has no matching edge).

The formulation here (equivalent to the graph walk on linear paths, and the
shape actually run on the device — see `nimble_tpu.ops`):

  1. ANCHOR: scan the read left→right for the first k-mer (k=30) present in
     the library index.  No anchor -> no match.
  2. CANDIDATES: all (row, offset) occurrences of the anchor k-mer.  The
     anchor contributes k matched bases.
  3. FORWARD WALK from the anchor's end, one base per step, in lockstep over
     all candidate rows:
       - rows whose bases are exhausted leave the live set (a row survives
         only if it spans the entire walked region — matching the final
         color-set intersection of the graph walk);
       - if at least one live row matches the read base: live set := the
         matching rows, score += 1;
       - otherwise (graph has no matching edge): mismatches += 1, live set
         := rows that still have bases (the walk substitutes the reference
         base and continues);
       - the walk ends when no live row has bases left (graph exhausted) or
         the read ends.
  4. LEFT WALK from the anchor's start, mirrored, continuing with the same
     live set and counters.
  5. RESULT: eq_class = sorted distinct row ids of the final live set;
     score = matched bases; mismatches = substituted bases.

The returned mismatch count is NOT clamped by the allowance; enforcement is
the downstream filter's job (model pinned by the oracles above).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from nimble_tpu.index.build import KmerIndex, pack_kmer_keys

# eq_class (sorted row ids), score (matched bases), mismatches
WalkResult = Tuple[List[int], int, int]


def map_read_with_mismatch(
    codes: np.ndarray, index: KmerIndex
) -> Optional[WalkResult]:
    """Mismatch-tolerant anchored walk of one read against the library.

    ``codes`` are int8 base codes (A=0 C=1 G=2 T=3).  Returns None when no
    k-mer of the read occurs in the index (FilterReason::NoMatch upstream).
    """
    k = index.k
    L = len(codes)
    if L < k:
        return None

    ks = index.keys_sorted
    if len(ks) == 0:
        return None
    # ANCHOR: one vectorized membership test over every k-mer position
    # (semantically identical to the left-to-right first-hit scan)
    keys = pack_kmer_keys(codes, k)
    pos = np.searchsorted(ks, keys)
    found = (pos < len(ks)) & (ks[np.minimum(pos, len(ks) - 1)] == keys)
    if not found.any():
        return None
    anchor = int(np.argmax(found))
    s0 = int(index.post_starts[pos[anchor]])
    e0 = int(index.post_starts[pos[anchor] + 1])

    # small candidate sets: plain-Python index lists beat numpy's per-op
    # overhead by ~20x here, and the set logic stays byte-readable
    rows = index.postings_rows[s0:e0].tolist()
    offs = index.postings_offs[s0:e0].tolist()
    row_codes = [index.row_codes[r] for r in rows]
    row_lens = [len(c) for c in row_codes]
    read = codes.tolist()

    live = list(range(len(rows)))
    score = k
    mismatches = 0

    # Forward walk: read position anchor+k+t vs row position off+k+t.
    for t in range(L - anchor - k):
        read_base = read[anchor + k + t]
        has_base = [ci for ci in live if offs[ci] + k + t < row_lens[ci]]
        if not has_base:
            break
        match = [
            ci for ci in has_base
            if row_codes[ci][offs[ci] + k + t] == read_base
        ]
        if match:
            live = match
            score += 1
        else:
            live = has_base
            mismatches += 1

    # Left walk: read position anchor-j vs row position off-j (j>=1).
    for j in range(1, anchor + 1):
        read_base = read[anchor - j]
        has_base = [ci for ci in live if offs[ci] - j >= 0]
        if not has_base:
            break
        match = [
            ci for ci in has_base if row_codes[ci][offs[ci] - j] == read_base
        ]
        if match:
            live = match
            score += 1
        else:
            live = has_base
            mismatches += 1

    eq_class = sorted(set(rows[ci] for ci in live))
    return eq_class, score, mismatches
