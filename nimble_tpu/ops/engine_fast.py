"""Fast alignment kernel: bucketized probe + span walk + on-device filters.

This is the production single-device kernel behind the compact engine
interface.  It computes the same function as `engine_xla.probe_and_walk_compact`
(equivalence-tested) but is shaped around contiguous gathers and
elementwise integer work:

  * HASH PROBE — the table is bucketized (`device_index.build_bucketed_index`):
    one gather fetches a whole 8-lane bucket row (contiguous bytes) and the
    lane compare is elementwise, instead of `max_probe` scalar-ish gathers
    per position.  Bucket-level probing almost always terminates in 1 hop.
  * ANCHOR SEARCH is two-phase (driven by the engine): a cheap pass over the
    first few k-mer positions resolves the overwhelming majority of reads
    (real reads anchor at position 0); only unresolved reads rerun with the
    full position range.
  * WALK — instead of per-base random gathers, each candidate's reference
    span is fetched as ONE contiguous row of 2-bit packed words aligned to
    the read's coordinates; match bits come from a word XOR, and the walk
    recurrence consumes 16 positions per scan step
    (`_span_walk_abs_packed`).
  * FILTERS — full `pseudoalign` chain on device with exact integer
    thresholds (see `engine_xla.probe_and_walk_compact` for the exactness
    argument); ~6 bytes/read leave the chip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nimble_tpu.ops.engine_xla import (
    _fmix32,
    _hash_kmer,
    _rolling_keys,
)
from nimble_tpu.ops.device_index import FP_SALT


def _kmer_fp(lo, hi):
    """jnp twin of device_index.kmer_fp (bit-identical)."""
    lo = lo.astype(jnp.uint32)
    hi = hi.astype(jnp.uint32)
    rot = (hi << jnp.uint32(16)) | (hi >> jnp.uint32(16))
    return _fmix32(rot ^ _fmix32(lo ^ jnp.uint32(FP_SALT)))


# two-phase probe shape: phase A probes the first PROBE_PHASE_A k-mer
# positions for every read; only reads still unresolved re-probe the tail
# positions, compacted into PROBE_GROUP-read trips of a while_loop.  Real
# reads anchor at position ~0, so phase B usually runs 0-2 trips and the
# dominant (B, P, W) table gather shrinks to (B, S, W).
# NIMBLE_PROBE_PHASE_A overrides the boundary (0 = single-phase probe);
# read at import time, like the other kernel-shape knobs.
import os as _os

# default 8: real reads anchor within the first few positions, so a short
# phase A leaves phase B almost no work (A/B: scripts/ab_kernel_knobs.py)
PROBE_PHASE_A = int(_os.environ.get("NIMBLE_PROBE_PHASE_A", "8")) or (1 << 30)
PROBE_GROUP = 1024

# NIMBLE_FENCES=0 drops the optimization_barrier stage fences (A/B knob:
# the fences keep the probe, walk and filter stages as separate fusion
# regions, which bounds compile time; whether they cost run time is
# measurable without code edits).
_FENCES = _os.environ.get("NIMBLE_FENCES", "1") != "0"

# walk-scan unroll factor (A/B knob): each lax.scan iteration is a loop
# trip with its own overhead; the packed walk runs 2 scans x NWr word
# steps, so unrolling may recover straight-line speed at some
# compile-time cost.  1 = rolled.
SCAN_UNROLL = int(_os.environ.get("NIMBLE_SCAN_UNROLL", "1"))

# lane-transposed probe gather (A/B knob, see _probe_encoded.enc_block)
_PROBE_LANE_T = _os.environ.get("NIMBLE_PROBE_LANE_T", "0") == "1"

# TRANSPOSED-LAYOUT kernel middle.  Without it the kernel's middle ops
# live on arrays whose MINOR dims are the small candidate/lane/word axes
# (W=8, C=8, NWr=6), stitched by dozens of layout transposes.  With it,
# every GATHER stays row-major (one contiguous 32 B row per index), is
# transposed ONCE right after the gather, and all downstream elementwise
# work runs with the BATCH axis minor, feeding the (C, B)-layout walk scan
# directly with no further transposes.  NIMBLE_LAYOUT_T=0 restores the
# row-major layout for A/B.
_LAYOUT_T = _os.environ.get("NIMBLE_LAYOUT_T", "1") != "0"


def _fence(x):
    return jax.lax.optimization_barrier(x) if _FENCES else x


def _probe_encoded(
    reads_i32, read_lens, bkey_fp,
    *, k: int, max_probe: int, bucket_mask: int, p_limit: int,
    phase_a: int = 0,
):
    """Encoded anchor probe: the shared core of `_probe_bucketed`.

    Returns (m, h, lo, hi, hop_sel):
      m       (B,) uint32 — encoded ((P - anchor) << 8) | (W - lane), 0 when
              no k-mer position hits the fingerprint table;
      h       (B, P) uint32 — per-position bucket hashes;
      lo, hi  (B, P) uint32 — per-position key halves (for verification);
      hop_sel (B, P) uint32 or None — probe hop per position (max_probe > 1).

    The encoding makes the probe COMPOSABLE: a max over encoded values from
    different position blocks (the two-phase split below) or from different
    table shards (the mesh kernel's `lax.pmax` over the model axis) selects
    the global first-position anchor without materializing per-position hit
    masks.
    """
    B, Lmax = reads_i32.shape
    P_full = Lmax - k + 1
    P = min(P_full, p_limit)
    W = bkey_fp.shape[1]
    assert W < 256, "lane encoding carries the lane index in 8 bits"

    lo, hi = _rolling_keys(reads_i32[:, : P + k - 1], k)  # (B, P)
    h = _hash_kmer(lo, hi) & jnp.uint32(bucket_mask)
    fp = _kmer_fp(lo, hi)                                 # (B, P)

    pos_valid = (
        jnp.arange(P, dtype=jnp.int32)[None, :] + k <= read_lens[:, None]
    )
    # Lane/position selection runs as ONE max-reduction over an encoded
    # value instead of any+argmax+where chains: the (B, P, W) arrays put
    # the small W=8 axis minor, and every extra reduction over it is paid
    # at that narrow width.
    lane_prio = jnp.uint32(W) - jnp.arange(W, dtype=jnp.uint32)[None, None, :]
    # global position priorities: first valid position, then first lane —
    # one flat max over the encoded (position, lane) value
    pos_prio = jnp.uint32(P) - jnp.arange(P, dtype=jnp.uint32)  # (P,)

    # NIMBLE_PROBE_LANE_T=1 (A/B): gather the fp table LANE-TRANSPOSED —
    # W flat element-gathers + flat compares instead of one (N, S, W)
    # row-gather whose minor dim W=8 narrows every downstream op.  Same
    # probe function, different layout.
    bkey_fp_t = bkey_fp.T if _PROBE_LANE_T else None

    def enc_block(h_blk, fp_blk, pv_blk, prio_blk):
        """Encoded (position, lane) max over one position block."""
        if _PROBE_LANE_T:
            hf = h_blk.astype(jnp.int32).reshape(-1)
            fpf = fp_blk.reshape(-1)
            lm = jnp.zeros(hf.shape, dtype=jnp.uint32)
            for w in range(W):
                hit = bkey_fp_t[w][hf] == fpf
                lm = jnp.maximum(
                    lm, jnp.where(hit, jnp.uint32(W - w), jnp.uint32(0))
                )
            lane_m = lm.reshape(h_blk.shape)
        elif _LAYOUT_T:
            # keep the contiguous (N, S, W) 32 B row-gather, then ONE
            # transpose to (W, N*S) so the fp compare and the lane max
            # run with N*S minor (full lanes) instead of W=8 minor — the
            # lane max becomes W-1 elementwise maxima over the MAJOR axis
            Nb, S_blk = h_blk.shape
            bfps = bkey_fp[h_blk.astype(jnp.int32)]      # (N, S, W) gather
            bf_t = bfps.reshape(Nb * S_blk, W).T          # (W, N*S)
            fpf = fp_blk.reshape(-1)
            lane_prio_w = (
                jnp.uint32(W) - jnp.arange(W, dtype=jnp.uint32)
            )[:, None]
            lane_m_flat = jnp.where(
                bf_t == fpf[None, :], lane_prio_w, 0
            ).max(axis=0)                                 # (N*S,)
            # position max in (S, N) — batch minor again
            lane_m_t = lane_m_flat.reshape(Nb, S_blk).T
            enc_t = jnp.where(
                (lane_m_t > 0) & pv_blk.T,
                (prio_blk[:, None] << jnp.uint32(8)) | lane_m_t,
                0,
            )
            return enc_t.max(axis=0)
        else:
            bfps = bkey_fp[h_blk.astype(jnp.int32)]      # (N, S, W) gather
            lane_m = jnp.where(
                bfps == fp_blk[:, :, None], lane_prio, 0
            ).max(axis=2)
        enc = jnp.where(
            (lane_m > 0) & pv_blk,
            (prio_blk[None, :] << jnp.uint32(8)) | lane_m,
            0,
        )
        return enc.max(axis=1)

    # per-engine override (0 = the NIMBLE_PROBE_PHASE_A module default):
    # a STATIC arg at every jit boundary, so two engines with different
    # phase_a values compile distinct executables in one process
    S = phase_a or PROBE_PHASE_A
    G = min(PROBE_GROUP, B)
    hop_sel = None
    if max_probe == 1 and P > S:
        m_a = enc_block(h[:, :S], fp[:, :S], pos_valid[:, :S], pos_prio[:S])
        # phase B: reads with no phase-A hit AND a valid position >= S
        needs_b = (m_a == 0) & (read_lens - k >= S)
        n_u = needs_b.sum().astype(jnp.int32)
        # compact unresolved read ids to the front (order-preserving)
        b_pad = ((B + G - 1) // G) * G
        csum_b = jnp.cumsum(needs_b.astype(jnp.int32))
        dest = jnp.where(
            needs_b, csum_b - 1,
            n_u + jnp.cumsum((~needs_b).astype(jnp.int32)) - 1,
        )
        perm = (
            jnp.zeros(b_pad, dtype=jnp.int32)
            .at[dest].set(jnp.arange(B, dtype=jnp.int32))
        )
        h_tail, fp_tail = h[:, S:], fp[:, S:]
        pv_tail, prio_tail = pos_valid[:, S:], pos_prio[S:]

        def cond(carry):
            g, _ = carry
            return g * G < n_u

        def body(carry):
            g, m_b = carry
            ids = jax.lax.dynamic_slice(perm, (g * G,), (G,))
            m_g = enc_block(h_tail[ids], fp_tail[ids], pv_tail[ids], prio_tail)
            valid = (jnp.arange(G, dtype=jnp.int32) + g * G) < n_u
            # each unresolved read appears in exactly one trip; padding
            # lanes scatter 0 (a no-op for the max)
            return g + 1, m_b.at[ids].max(jnp.where(valid, m_g, 0))

        _, m_b = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros(B, dtype=jnp.uint32))
        )
        m = jnp.where(m_a > 0, m_a, m_b)
    elif max_probe == 1:
        m = enc_block(h, fp, pos_valid, pos_prio)
    else:
        lane_m = jnp.zeros((B, P), dtype=jnp.uint32)  # 0 = miss, else W-lane
        hop_rec = jnp.zeros((B, P), dtype=jnp.uint32)
        for p in range(max_probe):
            bidx = (h + jnp.uint32(p)) & jnp.uint32(bucket_mask)
            bfps = bkey_fp[bidx.astype(jnp.int32)]  # (B, P, W) row-gather
            enc = jnp.where(bfps == fp[:, :, None], lane_prio, 0).max(axis=2)
            new = (lane_m == 0) & (enc > 0)         # first matching hop wins
            lane_m = jnp.where(new, enc, lane_m)
            hop_rec = jnp.where(new, jnp.uint32(p), hop_rec)
        enc_pos = jnp.where(
            (lane_m > 0) & pos_valid,
            (pos_prio[None, :] << jnp.uint32(8)) | lane_m,
            0,
        )
        m = enc_pos.max(axis=1)
        hop_sel = hop_rec
    return m, h, lo, hi, hop_sel


def _probe_bucketed(
    reads_i32, read_lens, bkey_lo, bkey_hi, bkey_fp,
    *, k: int, max_probe: int, bucket_mask: int, p_limit: int,
    phase_a: int = 0,
):
    """Find each read's anchor (first k-mer position present in the table).

    The probe compares one uint32 FINGERPRINT word per lane
    (`device_index.kmer_fp`) instead of the lo|hi key pair — the table
    gathers are random-access memory traffic, and the fingerprint halves
    the gathered bytes.
    Fingerprints can collide (~2^-32 per lane compare), so the SELECTED
    lane's full lo/hi key is verified afterward (two (B,) element gathers);
    a mismatch sets ``fp_bad`` and the caller routes the read to the exact
    host-rescue path — device results stay exact.

    When ``max_probe == 1`` (tables are grown until this holds) the probe
    is TWO-PHASE: positions [0, PROBE_PHASE_A) for every read, then the
    tail positions only for reads the first phase left unresolved,
    compacted to the front and processed in PROBE_GROUP-read while_loop
    trips (`_probe_encoded`).  Anchors sit at position ~0 for real matching
    reads, so the expensive (B, P, W) fingerprint gather shrinks to its
    first S columns plus a data-dependent number of small trips; worst case
    (every read junk) gathers the same rows as the single-phase probe.

    Returns (has_anchor, anchor, bucket_sel, lane_sel, fp_bad); bucket/lane
    locate the anchor key's postings span without a per-position gather.
    Only positions [0, p_limit) are probed.
    """
    B, Lmax = reads_i32.shape
    P = min(Lmax - k + 1, p_limit)
    W = bkey_fp.shape[1]
    m, h, lo, hi, hop_sel = _probe_encoded(
        reads_i32, read_lens, bkey_fp,
        k=k, max_probe=max_probe, bucket_mask=bucket_mask, p_limit=p_limit,
        phase_a=phase_a,
    )

    has_anchor = m > 0
    anchor = jnp.where(
        has_anchor, jnp.uint32(P) - (m >> jnp.uint32(8)), 0
    ).astype(jnp.int32)
    lane_sel = jnp.where(
        has_anchor, jnp.uint32(W) - (m & jnp.uint32(0xFF)), 0
    ).astype(jnp.int32)
    take = lambda a: jnp.take_along_axis(a, anchor[:, None], axis=1)[:, 0]
    hop = take(hop_sel) if hop_sel is not None else jnp.uint32(0)
    bucket_sel = jnp.where(
        has_anchor,
        (take(h) + hop) & jnp.uint32(bucket_mask),
        0,
    ).astype(jnp.int32)

    # exact verification of the selected lane (fingerprint collisions land
    # in the host-rescue path; false negatives are impossible)
    lo_sel = bkey_lo[bucket_sel, lane_sel]
    hi_sel = bkey_hi[bucket_sel, lane_sel]
    fp_bad = has_anchor & (
        (lo_sel != take(lo)) | (hi_sel != take(hi))
    )
    return has_anchor, anchor, bucket_sel, lane_sel, fp_bad


def _walk_scan_t(live0_cb, alive_tcb, match_tcb, active_tb):
    """The walk recurrence with B on the LAST axis.

    lax.scan steps are sequential; with the (B, C) layout each step touches
    only C=8 lanes and drowns in per-step overhead.  Transposed to (C, B)
    every step is one elementwise op over the whole batch.
    alive/match: (T, C, B); active: (T, B); live0: (C, B).
    """

    def step(carry, xs):
        live, score, mm = carry
        alive_t, match_t, active_t = xs
        la = live & alive_t
        lm = live & match_t
        any_alive = la.any(axis=0)
        any_match = lm.any(axis=0)
        act = active_t & any_alive
        act_match = act & any_match
        live = jnp.where(act_match[None, :], lm, jnp.where(act[None, :], la, live))
        score = score + act_match.astype(jnp.int32)
        mm = mm + (act & ~any_match).astype(jnp.int32)
        return (live, score, mm), None

    B = live0_cb.shape[1]
    init = (
        live0_cb,
        jnp.zeros(B, dtype=jnp.int32),
        jnp.zeros(B, dtype=jnp.int32),
    )
    # unroll amortizes the per-step While-loop overhead (the walk is many
    # tiny (C, B) steps; overhead dominated at production batch sizes)
    (live, score, mm), _ = jax.lax.scan(
        step, init, (alive_tcb, match_tcb, active_tb), unroll=8
    )
    return live, score, mm


def _gather_span_words(ref_codes_packed, starts, NW):
    """Contiguous NW-word window per span start from the packed reference.

    Returns (words (M, NW) uint32, phase (M,) int32): each span's 2-bit
    codes live at bit offsets ``2*(phase + p)`` within its word window.
    One clipped row-gather from a sliding-window word matrix — scattered
    element-gathers ran near one element/cycle and dominated the kernel.
    Both walk variants (abs / packed) and the reference-coded read
    reconstruction share this exact layout through this helper.
    """
    w0 = starts >> 4
    phase = (starts & 15).astype(jnp.int32)
    n_words = ref_codes_packed.shape[0]
    win = jnp.stack(
        [ref_codes_packed[j : n_words - NW + 1 + j] for j in range(NW)],
        axis=1,
    )                                                 # (n_words-NW+1, NW)
    words = jnp.take(win, jnp.clip(w0, 0, win.shape[0] - 1), axis=0)
    return words, phase


def _unpack_span(words, phase, L):
    """Unpack (M, NW) word windows to (M, L) int32 2-bit codes."""
    NW = words.shape[1]
    x_idx = jnp.arange(L, dtype=jnp.int32)
    j = phase[:, None] + x_idx[None, :]               # (M, L)
    widx = j >> 4
    shift = ((j & 15) * 2).astype(jnp.uint32)
    acc = jnp.zeros(j.shape, dtype=jnp.uint32)
    for w in range(NW):
        acc = jnp.where(widx == w, words[:, w][:, None], acc)
    return ((acc >> shift) & jnp.uint32(3)).astype(jnp.int32)


def _span_walk_abs(
    reads_i32, read_lens, anchor, rows, offs, live0,
    ref_codes_packed, row_starts, row_lengths,
    *, k: int, ref_pad: int,
):
    """Forward+left walk in READ-ABSOLUTE coordinates.

    Each candidate's reference span is fetched aligned to the READ's
    coordinate system (span position p compares ref[r_start + off - anchor
    + p] against read[p]), so:
      * the read side needs NO gather at all (plain broadcast compare);
      * the span is Lmax wide;
      * both walks iterate shared absolute positions with per-read active
        masks (the recurrence no-ops outside each read's own range), which
        is exactly the masked-scan semantics the relative form used.
    Reference spans are ONE contiguous row-gather from a sliding-window
    word matrix (scattered element-gathers ran near one element/cycle and
    dominated the kernel's runtime).
    """
    B, Lmax = reads_i32.shape
    C = rows.shape[1]

    # span start in padded ref coords, aligned so span pos p == read pos p
    r_start = row_starts[rows]
    starts = (r_start + offs - anchor[:, None] + ref_pad).reshape(-1)
    NW = (Lmax + 15) // 16 + 1
    words, phase = _gather_span_words(ref_codes_packed, starts, NW)
    ref_span = _unpack_span(words, phase, Lmax).reshape(B, C, Lmax)

    match_full = ref_span == reads_i32[:, None, :]            # (B, C, Lmax)
    match_full = _fence(match_full)

    # candidate position at read pos p is off - anchor + p
    base_off = offs - anchor[:, None]                          # (B, C)
    r_len = row_lengths[rows]

    # forward: absolute p = k .. Lmax-1 (ascending); active for
    # anchor + k <= p < read_len; alive while base_off + p < r_len
    p_f = jnp.arange(k, Lmax, dtype=jnp.int32)
    f_alive = (base_off[:, :, None] + p_f[None, None, :]) < r_len[:, :, None]
    f_match = match_full[:, :, k:] & f_alive
    f_active = (
        (p_f[None, :] >= anchor[:, None] + k)
        & (p_f[None, :] < read_lens[:, None])
    )

    live_cb = jnp.moveaxis(live0, 1, 0)
    live_cb, f_score, f_mm = _walk_scan_t(
        live_cb,
        jnp.transpose(f_alive, (2, 1, 0)),
        jnp.transpose(f_match, (2, 1, 0)),
        jnp.transpose(f_active, (1, 0)),
    )

    # left: absolute p = P-2 .. 0 (descending; the anchor is < P = number
    # of k-mer positions, so no left step can start at or above P-1);
    # active for p < anchor; alive while base_off + p >= 0
    P = Lmax - k + 1
    p_l = jnp.arange(P - 2, -1, -1, dtype=jnp.int32)
    l_alive = (base_off[:, :, None] + p_l[None, None, :]) >= 0
    l_match = match_full[:, :, P - 2 :: -1] & l_alive
    l_active = p_l[None, :] < anchor[:, None]
    live_cb, l_score, l_mm = _walk_scan_t(
        live_cb,
        jnp.transpose(l_alive, (2, 1, 0)),
        jnp.transpose(l_match, (2, 1, 0)),
        jnp.transpose(l_active, (1, 0)),
    )

    return jnp.moveaxis(live_cb, 0, 1), f_score + l_score, f_mm + l_mm


def _span_walk(
    reads_i32, read_lens, anchor, rows, offs, live0,
    ref_codes_packed, row_starts, row_lengths,
    *, k: int, ref_pad: int, walk: str = "packed",
):
    """``walk`` is a static mode: "packed" = packed-domain walk (default,
    see `_span_walk_abs_packed`), "abs" = the unpacked absolute-coordinate
    walk it replaced (kept as the packed walk's test reference)."""
    if walk == "abs":
        return _span_walk_abs(
            reads_i32, read_lens, anchor, rows, offs, live0,
            ref_codes_packed, row_starts, row_lengths,
            k=k, ref_pad=ref_pad,
        )
    return _span_walk_abs_packed(
        reads_i32, read_lens, anchor, rows, offs, live0,
        ref_codes_packed, row_starts, row_lengths,
        k=k, ref_pad=ref_pad,
    )


def _span_walk_abs_packed(
    reads_i32, read_lens, anchor, rows, offs, live0,
    ref_codes_packed, row_starts, row_lengths,
    *, k: int, ref_pad: int,
):
    """Forward+left walk computed ENTIRELY in the 2-bit packed domain.

    Replaces `_span_walk_abs` (bit-identical results, equivalence-tested):
    that variant unpacked every candidate span to an (B, C, Lmax) int32
    matrix, compared it against the reads, and materialized six (T, C, B)
    alive/match/active masks for the scan — ~50 MB of HBM intermediates per
    8192x96 launch.  Here:

      * the gathered span WORDS are funnel-shifted to the read's word grid
        (one variable shift per row — phase 0 is safe: ``(x << 31) << 1``
        wraps to 0, never a shift-by-32);
      * match bits come from XOR + the 2-bit-lane zero trick
        (``~(x | x >> 1) & 0x5555...``) — one uint32 word covers 16 bases;
      * the walk recurrence consumes one WORD per scan step (16 statically
        unrolled positions), computing the alive/active masks on the fly
        from (C, B) arithmetic instead of precomputed (T, C, B) tensors.

    Walk semantics are exactly `_span_walk_abs`'s masked-scan formulation:
    forward steps are active for ``anchor + k <= p < read_len`` and alive
    while ``base_off + p < r_len``; left steps (descending) are active for
    ``p < anchor`` and alive while ``base_off + p >= 0``; positions outside
    either range are inert no-ops, so both walks iterate the full padded
    word grid.
    """
    B, Lmax = reads_i32.shape
    C = rows.shape[1]
    NWr = (Lmax + 15) // 16

    r_start = row_starts[rows]
    starts = (r_start + offs - anchor[:, None] + ref_pad).reshape(-1)
    NW = NWr + 1  # one funnel tail word
    words, phase = _gather_span_words(ref_codes_packed, starts, NW)

    # funnel-align the span words to the read's word grid: aligned word w
    # holds span bases [16w, 16w+16) at bits 2i
    sh = (jnp.uint32(2) * phase.astype(jnp.uint32))[:, None]      # (M, 1)
    lo_w = words[:, :NWr] >> sh
    hi_w = (words[:, 1 : NWr + 1] << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    aligned = (lo_w | hi_w).reshape(B, C, NWr)

    # read words in the same layout (base j at bits 2*(j&15) of word j>>4)
    pad = NWr * 16 - Lmax
    r = reads_i32 if pad == 0 else jnp.pad(reads_i32, ((0, 0), (0, pad)))
    j16 = (jnp.uint32(2) * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    rw = (r.astype(jnp.uint32).reshape(B, NWr, 16) << j16).sum(
        axis=2, dtype=jnp.uint32
    )

    x = aligned ^ rw[:, None, :]
    y = x | (x >> jnp.uint32(1))
    mbits = (~y) & jnp.uint32(0x55555555)                 # bit 2i = match
    mbits = _fence(mbits)

    base_cb = jnp.moveaxis(offs - anchor[:, None], 1, 0)  # (C, B)
    rlen_cb = jnp.moveaxis(row_lengths[rows], 1, 0)
    live_cb = jnp.moveaxis(live0, 1, 0)
    mbits_w = jnp.transpose(mbits, (2, 1, 0))             # (NWr, C, B)
    anchor_k = anchor + k

    def make_step(forward: bool):
        def step(carry, xs):
            live, score, mm = carry
            mw, w = xs                                     # (C, B), scalar
            for i in (range(16) if forward else range(15, -1, -1)):
                p = w * 16 + i
                match_t = ((mw >> jnp.uint32(2 * i)) & jnp.uint32(1)) != 0
                if forward:
                    alive_t = (base_cb + p) < rlen_cb
                    active_t = (p >= anchor_k) & (p < read_lens)
                else:
                    alive_t = (base_cb + p) >= 0
                    active_t = p < anchor
                la = live & alive_t
                lm = la & match_t
                any_alive = la.any(axis=0)
                any_match = lm.any(axis=0)
                act = active_t & any_alive
                act_match = act & any_match
                live = jnp.where(
                    act_match[None, :], lm, jnp.where(act[None, :], la, live)
                )
                score = score + act_match.astype(jnp.int32)
                mm = mm + (act & ~any_match).astype(jnp.int32)
            return (live, score, mm), None

        return step

    zeros = jnp.zeros(B, dtype=jnp.int32)
    w_idx = jnp.arange(NWr, dtype=jnp.int32)
    # provably inert words are skipped: forward steps need p >= anchor + k
    # >= k (words < k//16 never activate); left steps need p < anchor <=
    # P-1 (words past position P-2 never activate)
    w_f0 = min(k // 16, NWr)
    P_full = Lmax - k + 1
    wl = min(max((P_full - 2) // 16 + 1, 0), NWr)
    (live_cb, f_score, f_mm), _ = jax.lax.scan(
        make_step(True), (live_cb, zeros, zeros),
        (mbits_w[w_f0:], w_idx[w_f0:]), unroll=SCAN_UNROLL,
    )
    (live_cb, l_score, l_mm), _ = jax.lax.scan(
        make_step(False), (live_cb, zeros, zeros),
        (mbits_w[:wl][::-1], w_idx[:wl][::-1]), unroll=SCAN_UNROLL,
    )
    return (
        jnp.moveaxis(live_cb, 0, 1),
        f_score + l_score,
        f_mm + l_mm,
    )


def _span_walk_abs_packed_t(
    reads_i32, read_lens, anchor, rows_t, offs_t, live0_t,
    ref_codes_packed, row_starts, row_lengths,
    *, k: int, ref_pad: int,
):
    """`_span_walk_abs_packed` in the TRANSPOSED (batch-minor) layout.

    Bit-identical walk results (equivalence-tested); only the data layout
    differs.  Inputs/outputs carry the candidate axis MAJOR: rows_t /
    offs_t / live0_t are (C, B) and the returned live mask is (C, B).

    Layout discipline (see _LAYOUT_T): the span-word fetch stays a
    row-major (M, NW) gather — 28 B contiguous rows — and is transposed
    ONCE to (NW, M); every downstream op (funnel shift, read-word XOR,
    match-bit extraction) then runs on arrays whose minor dim is M = C*B
    or B, and the walk scan consumes the (NWr, C, B) match words directly
    with no further layout moves.  The row-major layout runs those same
    ops with NWr=6 or C=8 minor, and XLA stitches them with dozens of
    relayout transposes.
    """
    B, Lmax = reads_i32.shape
    C = rows_t.shape[0]
    NWr = (Lmax + 15) // 16

    r_start_t = row_starts[rows_t]                              # (C, B)
    starts_t = (r_start_t + offs_t - anchor[None, :] + ref_pad).reshape(-1)
    NW = NWr + 1  # one funnel tail word
    words, phase = _gather_span_words(ref_codes_packed, starts_t, NW)
    words_t = words.T                                           # (NW, M)

    # funnel-align in (NW, M): aligned word w holds span bases
    # [16w, 16w+16) at bits 2i (phase 0 is safe: (x << 31) << 1 wraps to 0)
    sh = (jnp.uint32(2) * phase.astype(jnp.uint32))[None, :]    # (1, M)
    lo_w = words_t[:NWr] >> sh
    hi_w = (words_t[1 : NWr + 1] << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    aligned_t = (lo_w | hi_w).reshape(NWr, C, B)

    # read words (base j at bits 2*(j&15) of word j>>4), transposed once
    pad = NWr * 16 - Lmax
    r = reads_i32 if pad == 0 else jnp.pad(reads_i32, ((0, 0), (0, pad)))
    j16 = (jnp.uint32(2) * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    rw = (r.astype(jnp.uint32).reshape(B, NWr, 16) << j16).sum(
        axis=2, dtype=jnp.uint32
    )
    rw_t = rw.T                                                 # (NWr, B)

    x = aligned_t ^ rw_t[:, None, :]
    y = x | (x >> jnp.uint32(1))
    mbits_w = (~y) & jnp.uint32(0x55555555)         # (NWr, C, B), bit 2i
    mbits_w = _fence(mbits_w)

    base_cb = offs_t - anchor[None, :]                          # (C, B)
    rlen_cb = row_lengths[rows_t]
    live_cb = live0_t
    anchor_k = anchor + k

    def make_step(forward: bool):
        def step(carry, xs):
            live, score, mm = carry
            mw, w = xs                                     # (C, B), scalar
            for i in (range(16) if forward else range(15, -1, -1)):
                p = w * 16 + i
                match_t = ((mw >> jnp.uint32(2 * i)) & jnp.uint32(1)) != 0
                if forward:
                    alive_t = (base_cb + p) < rlen_cb
                    active_t = (p >= anchor_k) & (p < read_lens)
                else:
                    alive_t = (base_cb + p) >= 0
                    active_t = p < anchor
                la = live & alive_t
                lm = la & match_t
                any_alive = la.any(axis=0)
                any_match = lm.any(axis=0)
                act = active_t & any_alive
                act_match = act & any_match
                live = jnp.where(
                    act_match[None, :], lm, jnp.where(act[None, :], la, live)
                )
                score = score + act_match.astype(jnp.int32)
                mm = mm + (act & ~any_match).astype(jnp.int32)
            return (live, score, mm), None

        return step

    zeros = jnp.zeros(B, dtype=jnp.int32)
    w_idx = jnp.arange(NWr, dtype=jnp.int32)
    w_f0 = min(k // 16, NWr)
    P_full = Lmax - k + 1
    wl = min(max((P_full - 2) // 16 + 1, 0), NWr)
    (live_cb, f_score, f_mm), _ = jax.lax.scan(
        make_step(True), (live_cb, zeros, zeros),
        (mbits_w[w_f0:], w_idx[w_f0:]), unroll=SCAN_UNROLL,
    )
    (live_cb, l_score, l_mm), _ = jax.lax.scan(
        make_step(False), (live_cb, zeros, zeros),
        (mbits_w[:wl][::-1], w_idx[:wl][::-1]), unroll=SCAN_UNROLL,
    )
    return live_cb, f_score + l_score, f_mm + l_mm


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_filter_packed(
    packed,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """probe_walk_filter on a packed input buffer: ONE uploaded array per
    launch.  ``packed`` is uint8 (B, ceil(bucket/4) + 2): 2-bit codes
    (4 bases/byte, base j at bits 2*(j%4) of byte j//4) followed by the
    little-endian uint16 read length.  Every host->device transfer has a
    fixed cost, so reads, lengths and every config scalar ride in
    device-resident arrays or this single buffer.
    """
    B = packed.shape[0]
    nb = (bucket + 3) // 4
    words = packed[:, :nb].astype(jnp.int32)
    j = jnp.arange(bucket, dtype=jnp.int32)
    reads = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3  # (B, bucket)
    read_lens = (
        packed[:, nb].astype(jnp.int32)
        | (packed[:, nb + 1].astype(jnp.int32) << 8)
    )
    return _probe_walk_filter_impl(
        reads, read_lens,
        bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
        ref_codes_packed, row_starts, row_lengths,
        s_min_table, score_threshold, num_mismatches,
        discard_multiple, discard_nonzero,
        k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
        p_limit=p_limit, ref_pad=ref_pad, walk=walk, phase_a=phase_a,
    )


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "walk", "phase_a"),
)
def probe_walk_filter(
    reads, read_lens,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Fast compact kernel on unpacked int8 reads (see
    probe_walk_filter_packed for the upload-optimal entry)."""
    return _probe_walk_filter_impl(
        reads.astype(jnp.int32), read_lens,
        bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
        ref_codes_packed, row_starts, row_lengths,
        s_min_table, score_threshold, num_mismatches,
        discard_multiple, discard_nonzero,
        k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
        p_limit=p_limit, ref_pad=ref_pad, walk=walk, phase_a=phase_a,
    )


def _probe_walk_filter_impl(
    reads_i32, read_lens,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    walk: str = "packed",
    one_col: bool = False,
    phase_a: int = 0,
):
    """Shared body: full pseudoalign filter chain on device, packed result."""
    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = _probe_bucketed(
        reads_i32, read_lens, bkey_lo, bkey_hi, bkey_fp,
        k=k, max_probe=max_probe, bucket_mask=bucket_mask, p_limit=p_limit,
        phase_a=phase_a,
    )
    # stage fence (see _FENCES): probe | walk | filters compile as
    # separate fusion regions
    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = _fence(
        (has_anchor, anchor, bucket_sel, lane_sel, fp_bad)
    )
    astart = bstart[bucket_sel, lane_sel]
    acnt = jnp.where(has_anchor, bcount[bucket_sel, lane_sel], 0)
    overflow = acnt > c_max

    if _LAYOUT_T and walk == "packed":
        # transposed (batch-minor) layout end to end: candidates MAJOR,
        # batch minor, the walk scan's native layout — see _LAYOUT_T
        c_idx_t = jnp.arange(c_max, dtype=jnp.int32)[:, None]
        live0_t = c_idx_t < jnp.minimum(acnt, c_max)[None, :]
        pidx_t = jnp.clip(astart[None, :] + c_idx_t, 0,
                          postings_row.shape[0] - 1)
        rows_t = postings_row[pidx_t]
        offs_t = postings_off[pidx_t].astype(jnp.int32)
        live_t, walk_score, walk_mm = _span_walk_abs_packed_t(
            reads_i32, read_lens, anchor, rows_t, offs_t, live0_t,
            ref_codes_packed, row_starts, row_lengths,
            k=k, ref_pad=ref_pad,
        )
        live_t, walk_score, walk_mm = _fence((live_t, walk_score, walk_mm))
        score = jnp.where(has_anchor, k + walk_score, 0)
        mm = jnp.where(has_anchor, walk_mm, 0)
        # pairwise distinct count in (C, C, B): batch stays minor
        dup_t = (
            (rows_t[:, None, :] == rows_t[None, :, :])
            & live_t[:, None, :] & live_t[None, :, :]
            & (jnp.arange(c_max)[:, None, None]
               > jnp.arange(c_max)[None, :, None])
        ).any(axis=1)
        distinct = (live_t & ~dup_t).sum(axis=0).astype(jnp.int32)
        lane_t = (1 << jnp.arange(c_max, dtype=jnp.int32))[:, None]
        mask = jnp.where(live_t, lane_t, 0).sum(axis=0)
    else:
        c_idx = jnp.arange(c_max, dtype=jnp.int32)[None, :]
        live0 = c_idx < jnp.minimum(acnt, c_max)[:, None]
        pidx = jnp.clip(astart[:, None] + c_idx, 0, postings_row.shape[0] - 1)
        rows = postings_row[pidx]
        offs = postings_off[pidx].astype(jnp.int32)

        live, walk_score, walk_mm = _span_walk(
            reads_i32, read_lens, anchor, rows, offs, live0,
            ref_codes_packed, row_starts, row_lengths,
            k=k, ref_pad=ref_pad, walk=walk,
        )
        live, walk_score, walk_mm = _fence((live, walk_score, walk_mm))
        score = jnp.where(has_anchor, k + walk_score, 0)
        mm = jnp.where(has_anchor, walk_mm, 0)

        # distinct live-row count without a device sort (pairwise compares
        # on the C lanes — ~6 cheap elementwise ops instead of a sort).  The entropy gate moved OFF device entirely: the
        # host computes it in exact f64 from the packed byte counts
        # (collect path), which also removes the old f32 boundary band
        # and its host rescues.
        dup = (
            (rows[:, :, None] == rows[:, None, :])
            & live[:, :, None] & live[:, None, :]
            & (jnp.arange(c_max)[:, None] > jnp.arange(c_max)[None, :])
        ).any(axis=2)
        distinct = (live & ~dup).sum(axis=1).astype(jnp.int32)
        lane = (1 << jnp.arange(c_max, dtype=jnp.int32))[None, :]
        mask = jnp.where(live, lane, 0).sum(axis=1)

    s_min = s_min_table[jnp.clip(read_lens, 0, s_min_table.shape[0] - 1)]
    passed = (
        has_anchor
        & (score >= score_threshold)
        & (score >= s_min)
        & (mm <= num_mismatches)
        & jnp.where(discard_multiple, distinct <= 1, True)
        & jnp.where(discard_nonzero, mm == 0, True)
    )

    needs_host = (has_anchor & overflow) | fp_bad

    if one_col:
        # HALF the fetch bytes: ship (bucket, lane) instead of astart and
        # pack everything into ONE int32 per read — the host recovers
        # astart from its own bstart table copy (unpack_compact_one).
        # Enabled by the engine only when c_max + 6 + log2(n_buckets) <= 31
        # (sign bit untouched).
        nbits = int(bucket_mask).bit_length()
        val = (
            mask
            | ((passed & ~needs_host).astype(jnp.int32) << c_max)
            | (needs_host.astype(jnp.int32) << (c_max + 1))
            | (has_anchor.astype(jnp.int32) << (c_max + 2))
            | (bucket_sel << (c_max + 3))
            | (lane_sel << (c_max + 3 + nbits))
        )
        return val[:, None]

    # ONE fetched array per kernel call: every device->host fetch has a
    # fixed latency, so the 5 logical outputs are packed into an int32
    # (B, 2) matrix (col 0 = astart; col 1 = mask | flag bits).
    flags = (
        mask
        | ((passed & ~needs_host).astype(jnp.int32) << 16)
        | (needs_host.astype(jnp.int32) << 17)
        | (has_anchor.astype(jnp.int32) << 18)
    )
    return jnp.stack([astart, flags], axis=1)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "one_col", "phase_a"),
)
def probe_walk_filter_refcoded_chunked(
    ref3,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    one_col: bool = False,
    phase_a: int = 0,
):
    """Compact kernel over REFERENCE-CODED reads (CRAM-style upload).

    ``ref3`` is (n_sub, lb, 8) uint8: row id (int32 LE), window offset
    (uint16 LE), read length (uint16 LE) per read — 8 wire bytes instead
    of ceil(bucket/4)+2.  The host dispatcher only emits a ref-coded row
    after VERIFYING the read equals ``row[off : off+len]`` byte-for-byte
    (models/aligner._refcode_rows), so reconstructing the read here from
    the device-resident reference (one contiguous span gather — the same
    `_gather_span_words` layout the walk uses) yields bit-identical codes
    and the unchanged `_probe_walk_filter_impl` produces bit-identical
    results to the raw packed path (tests/test_refcode.py).

    Zero padding rows decode as (row 0, off 0, len 0): a valid gather and
    a below-MIN-length read that every gate already ignores.
    """

    def body(refbuf):
        b = refbuf.astype(jnp.int32)
        row = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
        off = b[:, 4] | (b[:, 5] << 8)
        read_lens = b[:, 6] | (b[:, 7] << 8)
        starts = row_starts[row] + off + ref_pad
        NW = (bucket + 15) // 16 + 1
        words, phase = _gather_span_words(ref_codes_packed, starts, NW)
        reads = _unpack_span(words, phase, bucket)
        # zero past each read's length: bit-parity with the zero-padded
        # packed unpack (the entropy gate runs host-side on packed rows)
        reads = jnp.where(
            jnp.arange(bucket, dtype=jnp.int32)[None, :] < read_lens[:, None],
            reads, 0,
        )
        return _probe_walk_filter_impl(
            reads, read_lens,
            bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row,
            postings_off, ref_codes_packed, row_starts, row_lengths,
            s_min_table, score_threshold, num_mismatches,
            discard_multiple, discard_nonzero,
            k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
            p_limit=p_limit, ref_pad=ref_pad, walk=walk,
            one_col=one_col, phase_a=phase_a,
        )

    if ref3.shape[0] == 1:
        return body(ref3[0])[None]
    return jax.lax.map(body, ref3)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "one_col", "uniform_len", "phase_a"),
)
def probe_walk_filter_packed_chunked(
    packed3,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    one_col: bool = False,
    uniform_len: int = 0,
    phase_a: int = 0,
):
    """Sub-batched compact kernel in ONE jit: ``packed3`` is
    (n_sub, lb, ceil(bucket/4)+2) and `lax.map` runs the fixed-size body per
    sub-batch on device.  One upload, one compile (per n_sub), one fetched
    (n_sub, lb, 2) result — transfers and compiled executables both have
    a fixed cost, so both are minimized.

    ``uniform_len`` > 0 declares every row's read length STATICALLY: the
    packed rows then carry only the ceil(bucket/4) code bytes (no uint16
    length tail — ~8% fewer wire bytes on fixed-length Illumina chunks,
    the common case) and the length-dependent masks constant-fold.
    Padding rows (beyond the caller's row count) also claim the uniform
    length; their results are discarded host-side at collect, exactly
    like zero-length padding rows before."""
    nb = (bucket + 3) // 4

    def body(packed):
        words = packed[:, :nb].astype(jnp.int32)
        j = jnp.arange(bucket, dtype=jnp.int32)
        reads = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
        if uniform_len:
            read_lens = jnp.full(
                (packed.shape[0],), uniform_len, dtype=jnp.int32
            )
        else:
            read_lens = (
                packed[:, nb].astype(jnp.int32)
                | (packed[:, nb + 1].astype(jnp.int32) << 8)
            )
        return _probe_walk_filter_impl(
            reads, read_lens,
            bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
            ref_codes_packed, row_starts, row_lengths,
            s_min_table, score_threshold, num_mismatches,
            discard_multiple, discard_nonzero,
            k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
            p_limit=p_limit, ref_pad=ref_pad, walk=walk,
            one_col=one_col, phase_a=phase_a,
        )

    if packed3.shape[0] == 1:
        return body(packed3[0])[None]
    return jax.lax.map(body, packed3)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_full_packed_chunked(
    packed3,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Sub-batched full-output kernel in one jit; (n_sub, lb, 3) result."""
    nb = (bucket + 3) // 4

    def body(packed):
        return _probe_walk_full_packed_body(
            packed,
            bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
            ref_codes_packed, row_starts, row_lengths,
            k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
            p_limit=p_limit, ref_pad=ref_pad, bucket=bucket,
            walk=walk, phase_a=phase_a,
        )

    if packed3.shape[0] == 1:
        return body(packed3[0])[None]
    return jax.lax.map(body, packed3)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_full_packed_multi_chunked(
    packed3,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Chunked multi-library FULL-output kernel: (n_sub, lb, W) packed reads
    against stacked (L, ...) library tables; (n_sub, L, lb, 3) in one
    launch (the BAM path's per-batch alignment for every library)."""
    nb = (bucket + 3) // 4

    def body(packed):
        words = packed[:, :nb].astype(jnp.int32)
        j = jnp.arange(bucket, dtype=jnp.int32)
        reads_i32 = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
        read_lens = (
            packed[:, nb].astype(jnp.int32)
            | (packed[:, nb + 1].astype(jnp.int32) << 8)
        )

        def one(bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln):
            return _probe_walk_full_impl(
                reads_i32, read_lens,
                bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln,
                k=k, max_probe=max_probe, c_max=c_max,
                bucket_mask=bucket_mask, p_limit=p_limit, ref_pad=ref_pad,
                bucket=bucket, walk=walk, phase_a=phase_a,
            )

        return jax.vmap(one)(
            bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
            ref_codes_packed, row_starts, row_lengths,
        )

    if packed3.shape[0] == 1:
        return body(packed3[0])[None]
    return jax.lax.map(body, packed3)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_filter_packed_multi_chunked(
    packed3,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Chunked multi-library kernel: (n_sub, lb, W) packed reads against
    stacked library tables; returns (n_sub, L, lb, 2) in one launch."""
    nb = (bucket + 3) // 4

    def body(packed):
        words = packed[:, :nb].astype(jnp.int32)
        j = jnp.arange(bucket, dtype=jnp.int32)
        reads_i32 = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
        read_lens = (
            packed[:, nb].astype(jnp.int32)
            | (packed[:, nb + 1].astype(jnp.int32) << 8)
        )

        def one(bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln, s_min,
                thr, nmm, dm, dn):
            return _probe_walk_filter_impl(
                reads_i32, read_lens,
                bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln,
                s_min, thr, nmm, dm, dn,
                k=k, max_probe=max_probe, c_max=c_max,
                bucket_mask=bucket_mask, p_limit=p_limit, ref_pad=ref_pad,
                walk=walk, phase_a=phase_a,
            )

        return jax.vmap(one)(
            bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
            ref_codes_packed, row_starts, row_lengths,
            s_min_table, score_threshold, num_mismatches,
            discard_multiple, discard_nonzero,
        )

    if packed3.shape[0] == 1:
        return body(packed3[0])[None]
    return jax.lax.map(body, packed3)


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_filter_packed_multi(
    packed,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    s_min_table, score_threshold, num_mismatches,
    discard_multiple, discard_nonzero,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Multi-library variant: every table/config argument carries a leading
    library axis (stacked to common geometry); ONE launch aligns the shared
    packed read buffer against every library and returns (L, B, 2).

    The reference aligns libraries sequentially (`src/process/fastq.rs:15`,
    `src/process/bam.rs:315`); serving all libraries per launch pays the
    per-launch fixed cost once for N libraries (SURVEY.md §2c, BASELINE
    multi-library config).
    """
    B = packed.shape[0]
    nb = (bucket + 3) // 4
    words = packed[:, :nb].astype(jnp.int32)
    j = jnp.arange(bucket, dtype=jnp.int32)
    reads_i32 = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
    read_lens = (
        packed[:, nb].astype(jnp.int32)
        | (packed[:, nb + 1].astype(jnp.int32) << 8)
    )

    def one(bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln, s_min, thr,
            nmm, dm, dn):
        return _probe_walk_filter_impl(
            reads_i32, read_lens,
            bkl, bkh, bkf, bst, bcn, prow, poff, refp, rst, rln,
            s_min, thr, nmm, dm, dn,
            k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
            p_limit=p_limit, ref_pad=ref_pad, walk=walk, phase_a=phase_a,
        )

    return jax.vmap(one)(
        bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
        ref_codes_packed, row_starts, row_lengths,
        s_min_table, score_threshold, num_mismatches,
        discard_multiple, discard_nonzero,
    )


COMPACT_MASK_BITS = 16
COMPACT_PASSED_BIT = 1 << 16
COMPACT_NEEDS_HOST_BIT = 1 << 17
COMPACT_HAS_ANCHOR_BIT = 1 << 18


def unpack_compact(packed: "np.ndarray"):
    """Host-side unpack of probe_walk_filter's (B, 2) int32 result."""
    import numpy as np

    flags = packed[:, 1]
    return {
        "astart": packed[:, 0].astype(np.int64),
        "mask": (flags & (COMPACT_PASSED_BIT - 1)).astype(np.int32),
        "passed": (flags & COMPACT_PASSED_BIT) != 0,
        "needs_host": (flags & COMPACT_NEEDS_HOST_BIT) != 0,
        "has_anchor": (flags & COMPACT_HAS_ANCHOR_BIT) != 0,
    }


def unpack_compact_one(packed: "np.ndarray", c_max: int, bucket_mask: int,
                       bstart: "np.ndarray"):
    """Host-side unpack of the ONE-int32-per-read compact result.

    Layout (see `_probe_walk_filter_impl` one_col): mask | passed |
    needs_host | has_anchor | bucket_sel | lane_sel.  ``astart`` is
    recovered from the host's own copy of the bucket span table — shipping
    (bucket, lane) instead of astart HALVES the fetched bytes."""
    import numpy as np

    nbits = int(bucket_mask).bit_length()
    v = packed[:, 0]
    bucket = (v >> (c_max + 3)) & bucket_mask
    lane = (v >> (c_max + 3 + nbits)) & 7
    return {
        "astart": bstart[bucket, lane].astype(np.int64),
        "mask": (v & ((1 << c_max) - 1)).astype(np.int32),
        "passed": ((v >> c_max) & 1) != 0,
        "needs_host": ((v >> (c_max + 1)) & 1) != 0,
        "has_anchor": ((v >> (c_max + 2)) & 1) != 0,
    }


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "bucket", "walk", "phase_a"),
)
def probe_walk_full_packed(
    packed,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Full-output kernel on the packed input buffer, ONE fetched array.

    Input layout matches probe_walk_filter_packed.  Output is int32 (B, 3):
      col 0 = astart
      col 1 = mask | has_anchor<<16 | overflow<<17
      col 2 = score<<16 | mismatches   (both < 2^16: reads cap at 1024 bp)
    Used by the forensic/BAM path, where the host applies the exact f64
    gates (entropy, normalized score) itself.
    """
    return _probe_walk_full_packed_body(
        packed,
        bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
        ref_codes_packed, row_starts, row_lengths,
        k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
        p_limit=p_limit, ref_pad=ref_pad, bucket=bucket, walk=walk, phase_a=phase_a,
    )


def _probe_walk_full_packed_body(
    packed,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    nb = (bucket + 3) // 4
    words = packed[:, :nb].astype(jnp.int32)
    j = jnp.arange(bucket, dtype=jnp.int32)
    reads_i32 = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
    read_lens = (
        packed[:, nb].astype(jnp.int32)
        | (packed[:, nb + 1].astype(jnp.int32) << 8)
    )
    return _probe_walk_full_impl(
        reads_i32, read_lens,
        bkey_lo, bkey_hi, bkey_fp, bstart, bcount, postings_row, postings_off,
        ref_codes_packed, row_starts, row_lengths,
        k=k, max_probe=max_probe, c_max=c_max, bucket_mask=bucket_mask,
        p_limit=p_limit, ref_pad=ref_pad, bucket=bucket,
        walk=walk, phase_a=phase_a,
    )


def _probe_walk_full_impl(
    reads_i32, read_lens,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    bucket: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = _probe_bucketed(
        reads_i32, read_lens, bkey_lo, bkey_hi, bkey_fp,
        k=k, max_probe=max_probe, bucket_mask=bucket_mask, p_limit=p_limit,
        phase_a=phase_a,
    )
    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = _fence(
        (has_anchor, anchor, bucket_sel, lane_sel, fp_bad)
    )
    astart = bstart[bucket_sel, lane_sel]
    acnt = jnp.where(has_anchor, bcount[bucket_sel, lane_sel], 0)
    # fp_bad reads take the same exact host-rescue route as postings
    # overflow (the overflow bit, rescued in full_collect/align_batch)
    overflow = (acnt > c_max) | fp_bad

    if _LAYOUT_T and walk == "packed":
        c_idx_t = jnp.arange(c_max, dtype=jnp.int32)[:, None]
        live0_t = c_idx_t < jnp.minimum(acnt, c_max)[None, :]
        pidx_t = jnp.clip(astart[None, :] + c_idx_t, 0,
                          postings_row.shape[0] - 1)
        rows_t = postings_row[pidx_t]
        offs_t = postings_off[pidx_t].astype(jnp.int32)
        live_t, walk_score, walk_mm = _span_walk_abs_packed_t(
            reads_i32, read_lens, anchor, rows_t, offs_t, live0_t,
            ref_codes_packed, row_starts, row_lengths,
            k=k, ref_pad=ref_pad,
        )
        lane_t = (1 << jnp.arange(c_max, dtype=jnp.int32))[:, None]
        mask = jnp.where(live_t, lane_t, 0).sum(axis=0)
    else:
        c_idx = jnp.arange(c_max, dtype=jnp.int32)[None, :]
        live0 = c_idx < jnp.minimum(acnt, c_max)[:, None]
        pidx = jnp.clip(astart[:, None] + c_idx, 0, postings_row.shape[0] - 1)
        rows = postings_row[pidx]
        offs = postings_off[pidx].astype(jnp.int32)

        live, walk_score, walk_mm = _span_walk(
            reads_i32, read_lens, anchor, rows, offs, live0,
            ref_codes_packed, row_starts, row_lengths,
            k=k, ref_pad=ref_pad, walk=walk,
        )
        lane = (1 << jnp.arange(c_max, dtype=jnp.int32))[None, :]
        mask = jnp.where(live, lane, 0).sum(axis=1)
    score = jnp.where(has_anchor, k + walk_score, 0)
    mm = jnp.where(has_anchor, walk_mm, 0)

    col1 = (
        mask
        | (has_anchor.astype(jnp.int32) << 16)
        | (overflow.astype(jnp.int32) << 17)
    )
    col2 = (score << 16) | mm
    return jnp.stack([astart, col1, col2], axis=1)


def unpack_full_packed(packed: "np.ndarray"):
    """Host-side unpack of probe_walk_full_packed's (B, 3) int32 result."""
    import numpy as np

    col1 = packed[:, 1]
    col2 = packed[:, 2]
    return {
        "astart": packed[:, 0].astype(np.int64),
        "mask": (col1 & 0xFFFF).astype(np.int32),
        "has_anchor": (col1 & (1 << 16)) != 0,
        "overflow": (col1 & (1 << 17)) != 0,
        "score": (col2 >> 16).astype(np.int32),
        "mismatches": (col2 & 0xFFFF).astype(np.int32),
    }


@partial(
    jax.jit,
    static_argnames=("k", "max_probe", "c_max", "bucket_mask", "p_limit", "ref_pad",
                     "walk", "phase_a"),
)
def probe_walk_full(
    reads, read_lens,
    bkey_lo, bkey_hi, bkey_fp, bstart, bcount,
    postings_row, postings_off,
    ref_codes_packed, row_starts, row_lengths,
    *,
    k: int,
    max_probe: int,
    c_max: int,
    bucket_mask: int,
    p_limit: int,
    ref_pad: int,
    walk: str = "packed",
    phase_a: int = 0,
):
    """Fast kernel, full per-read outputs for the forensic path.

    Returns astart/mask (eq identity), raw score, mismatches, has_anchor and
    overflow — the host applies the exact f64 gates and builds the per-read
    (AlignmentScore, Filter) tuples (`DeviceAlignEngine.align_batch`).
    """
    reads_i32 = reads.astype(jnp.int32)

    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = _probe_bucketed(
        reads_i32, read_lens, bkey_lo, bkey_hi, bkey_fp,
        k=k, max_probe=max_probe, bucket_mask=bucket_mask, p_limit=p_limit,
        phase_a=phase_a,
    )
    astart = bstart[bucket_sel, lane_sel]
    acnt = jnp.where(has_anchor, bcount[bucket_sel, lane_sel], 0)
    overflow = (acnt > c_max) | fp_bad

    c_idx = jnp.arange(c_max, dtype=jnp.int32)[None, :]
    live0 = c_idx < jnp.minimum(acnt, c_max)[:, None]
    pidx = jnp.clip(astart[:, None] + c_idx, 0, postings_row.shape[0] - 1)
    rows = postings_row[pidx]
    offs = postings_off[pidx].astype(jnp.int32)

    live, walk_score, walk_mm = _span_walk(
        reads_i32, read_lens, anchor, rows, offs, live0,
        ref_codes_packed, row_starts, row_lengths,
        k=k, ref_pad=ref_pad, walk=walk,
    )
    lane = (1 << jnp.arange(c_max, dtype=jnp.int32))[None, :]
    mask = jnp.where(live, lane, 0).sum(axis=1)

    return {
        "astart": astart,
        "mask": mask,
        "score": jnp.where(has_anchor, k + walk_score, 0),
        "mismatches": jnp.where(has_anchor, walk_mm, 0),
        "has_anchor": has_anchor,
        "overflow": overflow,
    }
