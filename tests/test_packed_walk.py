"""Packed-domain span walk (engine_fast._span_walk_abs_packed) parity.

The packed walk must be bit-identical to the legacy unpacked
absolute-coordinate walk (`_span_walk_abs`) for every (anchor, candidate,
length) shape — adversarial corpora plus a randomized sweep.
"""

import numpy as np
import pytest

from nimble_tpu.index.build import build_index
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.ops.device_index import build_bucketed_index
from nimble_tpu.utils.dna import encode_bases
from nimble_tpu.config import AlignFilterConfig


def _run(engine, mat, lens, mode):
    old = engine.walk
    engine.walk = mode
    try:
        seqs = [mat[i, : lens[i]] for i in range(mat.shape[0])]
        full = engine.align_batch(seqs)
        compact = engine.align_raw_compact_from_matrix(mat, lens)
        return full, compact
    finally:
        engine.walk = old


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_packed_walk_matches_abs_walk(seed):
    rng = np.random.default_rng(seed)
    feats = ["".join(rng.choice(list("ACGT"), size=rng.integers(60, 400)))
             for _ in range(12)]
    # collinear family: shared 60 bp prefix (multi-candidate anchors)
    stem = "".join(rng.choice(list("ACGT"), size=60))
    feats += [stem + "".join(rng.choice(list("ACGT"), size=40))
              for _ in range(4)]
    index = build_index(feats)
    cfg = AlignFilterConfig(
        reference_genome_size=len(feats), score_percent=0.1,
        score_threshold=30, num_mismatches=2, max_hits_to_report=20,
    )
    engine = DeviceAlignEngine(index, cfg)

    reads, lens = [], []
    L = 96
    for _ in range(200):
        f = int(rng.integers(0, len(feats)))
        codes = encode_bases(feats[f])
        ln = int(rng.integers(31, min(L, len(codes)) + 1))
        start = int(rng.integers(0, len(codes) - ln + 1))
        read = np.zeros(L, dtype=np.int8)
        read[:ln] = codes[start : start + ln]
        # salt mismatches, including ones that break/move the anchor
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, ln))
            read[p] = (read[p] + rng.integers(1, 4)) % 4
        reads.append(read)
        lens.append(ln)
    for _ in range(20):  # junk
        reads.append(rng.integers(0, 4, L).astype(np.int8))
        lens.append(L)
    mat = np.stack(reads)
    lens = np.asarray(lens, dtype=np.int32)

    got_full, got_c = _run(engine, mat, lens, "packed")
    want_full, want_c = _run(engine, mat, lens, "abs")
    assert len(got_full) == len(want_full)
    for i, (g, w) in enumerate(zip(got_full, want_full)):
        assert g == w, f"row {i}: {g} != {w}"
    for key in want_c:
        np.testing.assert_array_equal(got_c[key], want_c[key], err_msg=key)
