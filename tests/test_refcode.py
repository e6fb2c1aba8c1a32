"""CRAM-style reference-coded upload: parity and encoder correctness.

Exact-match reads ship as (row, off, len) in 8 wire bytes; the kernel
reconstructs them from the device-resident reference.  The encoder
VERIFIES byte-equality before coding, so results must be bit-identical to
the raw packed path for every read — matching and not.

The feature is OPT-IN (NIMBLE_REFCODE=1; see models/aligner._REFCODE),
so these tests force the module flag on explicitly.
"""

import numpy as np
import pytest

import nimble_tpu.models.aligner as al


@pytest.fixture(autouse=True)
def _force_refcode_on():
    old = al._REFCODE
    al._REFCODE = True
    yield
    al._REFCODE = old

from nimble_tpu.config import AlignFilterConfig
from nimble_tpu.index.build import build_index
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.utils.dna import encode_bases, revcomp


def _problem(seed=0, n_feats=8, feat_len=260):
    rng = np.random.default_rng(seed)
    feats = ["".join(rng.choice(list("ACGT"), size=feat_len))
             for _ in range(n_feats)]
    doubled = [x for f in feats for x in (f, revcomp(f))]
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled), score_percent=0.25,
        score_threshold=40, num_mismatches=1, max_hits_to_report=10,
    )
    return build_index(doubled), cfg, feats


def _reads(feats, seed=1, n=600):
    rng = np.random.default_rng(seed)
    W = 90
    mat = np.zeros((n, W), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    for i in range(n):
        f = feats[i % len(feats)]
        kind = i % 5
        if kind <= 1:  # clean fragment (exact window -> ref-codable)
            s = int(rng.integers(0, len(f) - 80))
            seq = encode_bases(f[s : s + 80])
        elif kind == 2:  # mutated (first k-mer clean, later mismatch)
            s = int(rng.integers(0, len(f) - 80))
            seq = encode_bases(f[s : s + 80]).copy()
            seq[60] = (seq[60] + 1) % 4
        elif kind == 3:  # revcomp fragment (matches the doubled row)
            s = int(rng.integers(0, len(f) - 70))
            seq = encode_bases(revcomp(f[s : s + 70]))
        else:  # junk
            seq = rng.integers(0, 4, 75).astype(np.int8)
        mat[i, : len(seq)] = seq
        lens[i] = len(seq)
    return mat, lens


def test_refcode_encoder_verifies_exact_windows():
    index, cfg, feats = _problem()
    eng = DeviceAlignEngine(index, cfg)
    mat, lens = _reads(feats)
    is_ref, row, off = eng._refcode_rows(mat, lens)
    # every flagged read must equal its claimed window byte-for-byte
    for i in np.flatnonzero(is_ref):
        codes = index.row_codes[row[i]]
        np.testing.assert_array_equal(
            codes[off[i] : off[i] + lens[i]], mat[i, : lens[i]]
        )
    # clean fragments are codable; the mid-read mutants must NOT be coded
    # at all: their clean first k-mer points at the clean window, whose
    # byte-verification fails at the mutated position, and the encoder
    # tries only that one candidate
    kinds = np.arange(len(lens)) % 5
    assert is_ref[kinds <= 1].mean() > 0.9
    assert not is_ref[kinds == 2].any()


def test_refcode_long_feature_offset_guard():
    """Windows past the uint16 offset range must take the raw path.

    The wire format carries the offset in 16 bits; a read matching at
    offset >= 65536 of a long feature would reconstruct a DIFFERENT
    window if coded (round-4 review finding, confirmed by repro) — the
    encoder must refuse it, and results must stay bit-identical to the
    raw path."""
    rng = np.random.default_rng(21)
    feat = "".join(rng.choice(list("ACGT"), size=70_000))
    doubled = [feat, revcomp(feat)]
    cfg = AlignFilterConfig(
        reference_genome_size=2, score_percent=0.25,
        score_threshold=40, num_mismatches=1, max_hits_to_report=10,
    )
    index = build_index(doubled)
    n, W = 64, 90
    mat = np.zeros((n, W), dtype=np.int8)
    lens = np.full(n, 80, dtype=np.int32)
    offs = []
    for i in range(n):
        s = int(rng.integers(60_000, 69_900))  # straddles the u16 line
        offs.append(s)
        mat[i, :80] = encode_bases(feat[s : s + 80])
    eng = DeviceAlignEngine(index, cfg)
    is_ref, row, off = eng._refcode_rows(mat, lens)
    offs = np.asarray(offs)
    # every flagged read's offset fits the wire format (reads whose only
    # candidate window sits past the line are refused -> raw path)
    assert (off[is_ref] <= 0xFFFF).all()
    assert not is_ref.all()  # the straddling corpus must exercise refusal
    got = eng.align_raw_compact_from_matrix(mat, lens)
    al._REFCODE = False
    try:
        want = al.DeviceAlignEngine(
            index, cfg
        ).align_raw_compact_from_matrix(mat, lens)
    finally:
        al._REFCODE = True
    for key in ("astart", "mask", "passed", "needs_host"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_refcode_bit_parity_with_raw_path():
    index, cfg, feats = _problem(seed=3)
    mat, lens = _reads(feats, seed=4)
    eng_on = DeviceAlignEngine(index, cfg)
    got = eng_on.align_raw_compact_from_matrix(mat, lens)
    al._REFCODE = False
    try:
        eng_off = al.DeviceAlignEngine(index, cfg)
        want = eng_off.align_raw_compact_from_matrix(mat, lens)
    finally:
        al._REFCODE = True
    for key in ("astart", "mask", "passed", "needs_host"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_refcode_full_chunk_all_exact():
    """The sel=None fast path splits correctly when EVERY read ref-codes."""
    index, cfg, feats = _problem(seed=7)
    rng = np.random.default_rng(8)
    n, W = 256, 80
    mat = np.zeros((n, W), dtype=np.int8)
    lens = np.full(n, W, dtype=np.int32)
    for i in range(n):
        f = feats[i % len(feats)]
        s = int(rng.integers(0, len(f) - W))
        mat[i] = encode_bases(f[s : s + W])
    eng = DeviceAlignEngine(index, cfg)
    is_ref, _, _ = eng._refcode_rows(mat, lens)
    assert is_ref.all()
    got = eng.align_raw_compact_from_matrix(mat, lens)
    assert got["passed"].all()
    # decode one combo to prove end-to-end integrity
    rows = eng.decode_combo(int(got["astart"][0]), int(got["mask"][0]))
    assert len(rows) >= 1
