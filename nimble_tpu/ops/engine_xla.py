"""Batched probe+walk on device (XLA formulation).

This is the device version of the reference's innermost hot loop
(`map_read_with_mismatch`, see `nimble_tpu.core.walk` for the pinned
semantics).  One jitted call processes a padded batch of reads:

  1. 60-bit rolling k-mer keys as two 30-bit uint32 lanes;
  2. fixed-trip open-addressing probe of the HBM-resident hash table
     (``max_probe`` is the table's measured worst-case probe distance);
  3. anchor = first read position whose k-mer has postings;
  4. gather up to C_MAX (row, offset) candidates for the anchor k-mer;
  5. lockstep forward+left walk as a `lax.scan` over base positions with a
     (B, C) boolean live-set state — the data-dependent graph walk of the
     reference becomes a fixed-shape masked scan.

All arrays are static-shaped; per-(B, Lmax) variants are compiled once and
cached by jit.  Reads whose anchor has more than C_MAX candidates are flagged
``overflow`` and re-run on the host oracle by the engine wrapper — the device
handles the overwhelmingly common case, the host guarantees exactness.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _fmix32(x):
    x = x.astype(jnp.uint32)
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


def _hash_kmer(key_lo, key_hi):
    return _fmix32(key_lo.astype(jnp.uint32) ^ _fmix32(key_hi.astype(jnp.uint32)))


def _rolling_keys(reads_i32, k: int):
    """(B, P) uint32 key halves from (B, Lmax) int32 codes.

    hi = bases [i, i+k/2), lo = bases [i+k/2, i+k), 2 bits per base.

    Built by window doubling — combine w-base windows into 2w-base windows
    (K2w[i] = Kw[i] << 2w | Kw[i+w]) — so a 15-base half costs ~6 ops
    instead of 15 shifted ors.  Kernel runtime here is op-dispatch-overhead
    bound, so op count is the metric that matters.
    """
    B, Lmax = reads_i32.shape
    P = Lmax - k + 1
    half = k // 2

    codes = reads_i32.astype(jnp.uint32)

    # pow_win[w][:, i] = packed bases [i, i+w) for power-of-two widths
    pow_win = {1: codes}
    w = 1
    while 2 * w <= max(half, k - half):
        a = pow_win[w]
        pow_win[2 * w] = (a[:, : a.shape[1] - w] << jnp.uint32(2 * w)) | a[:, w:]
        w *= 2

    def window(width):
        acc = None
        off = 0
        for i in reversed(range(width.bit_length())):
            if not (width >> i) & 1:
                continue
            pw = 1 << i
            piece = pow_win[pw][:, off:]
            if acc is None:
                acc = pow_win[pw]
            else:
                n = min(acc.shape[1], piece.shape[1])
                acc = (acc[:, :n] << jnp.uint32(2 * pw)) | piece[:, :n]
            off += pw
        return acc

    hi_full = window(half)
    hi = hi_full[:, :P]
    lo_full = hi_full if k - half == half else window(k - half)
    lo = lo_full[:, half : half + P]
    return lo, hi


def _walk_scan(live0, alive, match, step_active):
    """The live-set recurrence (semantics: `nimble_tpu/core/walk.py`).

    alive/match: (B, C, T) bool; step_active: (B, T) bool.
    Returns (live, matched_steps, mismatch_steps).
    """
    B, C, T = alive.shape

    def step(carry, xs):
        live, score, mm = carry
        alive_t, match_t, active_t = xs
        la = live & alive_t
        lm = live & match_t
        any_alive = la.any(axis=-1)
        any_match = lm.any(axis=-1)
        act = active_t & any_alive
        act_match = act & any_match
        live = jnp.where(act_match[:, None], lm, jnp.where(act[:, None], la, live))
        score = score + act_match.astype(jnp.int32)
        mm = mm + (act & ~any_match).astype(jnp.int32)
        return (live, score, mm), None

    xs = (
        jnp.moveaxis(alive, 2, 0),
        jnp.moveaxis(match, 2, 0),
        jnp.moveaxis(step_active, 1, 0),
    )
    init = (
        live0,
        jnp.zeros(live0.shape[0], dtype=jnp.int32),
        jnp.zeros(live0.shape[0], dtype=jnp.int32),
    )
    (live, score, mm), _ = jax.lax.scan(step, init, xs)
    return live, score, mm


def probe_positions(
    reads_i32, read_lens,
    table_key_lo, table_key_hi, table_start, table_count,
    *, k: int, max_probe: int, table_mask: int,
):
    """(found, start, cnt) per k-mer position — stages 1+2 of the pipeline."""
    B, Lmax = reads_i32.shape
    P = Lmax - k + 1

    lo, hi = _rolling_keys(reads_i32, k)
    h = _hash_kmer(lo, hi) & jnp.uint32(table_mask)

    start = jnp.zeros((B, P), dtype=jnp.int32)
    cnt = jnp.zeros((B, P), dtype=jnp.int32)
    found = jnp.zeros((B, P), dtype=bool)
    for p in range(max_probe):
        slot = ((h + jnp.uint32(p)) & jnp.uint32(table_mask)).astype(jnp.int32)
        eq = (table_key_lo[slot] == lo) & (table_key_hi[slot] == hi)
        new = eq & ~found
        start = jnp.where(new, table_start[slot], start)
        cnt = jnp.where(new, table_count[slot], cnt)
        found = found | eq

    pos_valid = (
        jnp.arange(P, dtype=jnp.int32)[None, :] + k <= read_lens[:, None]
    )
    cnt = jnp.where(found & pos_valid, cnt, 0)
    return found & pos_valid & (cnt > 0), start, cnt


def gather_candidates(astart, acnt, postings_row, postings_off, has_anchor, *, c_max: int):
    """(rows, offs, live0, overflow) for each read's anchor k-mer — stage 4."""
    c_idx = jnp.arange(c_max, dtype=jnp.int32)[None, :]
    live0 = (c_idx < jnp.minimum(acnt, c_max)[:, None]) & has_anchor[:, None]
    pidx = jnp.clip(astart[:, None] + c_idx, 0, postings_row.shape[0] - 1)
    rows = postings_row[pidx]
    offs = postings_off[pidx].astype(jnp.int32)
    overflow = acnt > c_max
    return rows, offs, live0, overflow


def walk_candidates(
    reads_i32, read_lens, anchor, rows, offs, live0,
    ref_codes, row_starts, row_lengths,
    *, k: int,
):
    """Lockstep forward+left walk over the candidate set — stage 5.

    Returns (live, matched_steps, mismatch_steps); the caller adds the
    anchor's k matched bases.
    """
    B, Lmax = reads_i32.shape
    r_start = row_starts[rows]
    r_len = row_lengths[rows]

    T = Lmax - k
    t_idx = jnp.arange(T, dtype=jnp.int32)

    def gather_ref(ref_pos):
        return ref_codes[jnp.clip(ref_pos, 0, ref_codes.shape[0] - 1)]

    # forward walk: read[anchor+k+t] vs row[off+k+t]
    f_read_pos = anchor[:, None] + k + t_idx[None, :]               # (B, T)
    f_active = f_read_pos < read_lens[:, None]
    f_read_base = jnp.take_along_axis(
        reads_i32, jnp.clip(f_read_pos, 0, Lmax - 1), axis=1
    )
    f_row_pos = offs[:, :, None] + k + t_idx[None, None, :]          # (B, C, T)
    f_alive = f_row_pos < r_len[:, :, None]
    f_ref_base = gather_ref(r_start[:, :, None] + f_row_pos).astype(jnp.int32)
    f_match = f_alive & (f_ref_base == f_read_base[:, None, :])
    live, f_score, f_mm = _walk_scan(live0, f_alive, f_match, f_active)

    # left walk: read[anchor-j] vs row[off-j], j = 1..T
    j_idx = t_idx + 1
    l_read_pos = anchor[:, None] - j_idx[None, :]
    l_active = l_read_pos >= 0
    l_read_base = jnp.take_along_axis(
        reads_i32, jnp.clip(l_read_pos, 0, Lmax - 1), axis=1
    )
    l_row_pos = offs[:, :, None] - j_idx[None, None, :]
    l_alive = l_row_pos >= 0
    l_ref_base = gather_ref(r_start[:, :, None] + l_row_pos).astype(jnp.int32)
    l_match = l_alive & (l_ref_base == l_read_base[:, None, :])
    live, l_score, l_mm = _walk_scan(live, l_alive, l_match, l_active)

    return live, f_score + l_score, f_mm + l_mm


@partial(jax.jit, static_argnames=("k", "max_probe", "c_max", "table_mask"))
def probe_and_walk(
    reads,        # (B, Lmax) int8 padded read codes
    read_lens,    # (B,) int32
    table_key_lo, table_key_hi, table_start, table_count,  # hash table
    postings_row, postings_off,                            # postings
    ref_codes, row_starts, row_lengths,                    # reference rows
    *,
    k: int,
    max_probe: int,
    c_max: int,
    table_mask: int,
):
    reads_i32 = reads.astype(jnp.int32)

    hit, start, cnt = probe_positions(
        reads_i32, read_lens,
        table_key_lo, table_key_hi, table_start, table_count,
        k=k, max_probe=max_probe, table_mask=table_mask,
    )

    # anchor: first position with postings
    has_anchor = hit.any(axis=1)
    anchor = jnp.argmax(hit, axis=1).astype(jnp.int32)
    astart = jnp.take_along_axis(start, anchor[:, None], axis=1)[:, 0]
    acnt = jnp.take_along_axis(cnt, anchor[:, None], axis=1)[:, 0]

    rows, offs, live0, overflow = gather_candidates(
        astart, acnt, postings_row, postings_off, has_anchor, c_max=c_max
    )

    live, walk_score, walk_mm = walk_candidates(
        reads_i32, read_lens, anchor, rows, offs, live0,
        ref_codes, row_starts, row_lengths, k=k,
    )

    score = jnp.where(has_anchor, k + walk_score, 0)
    mismatches = jnp.where(has_anchor, walk_mm, 0)

    return {
        "has_anchor": has_anchor,
        "overflow": overflow,
        "rows": rows,
        "live": live,
        "score": score,
        "mismatches": mismatches,
    }


# entropy gate constants shared with the fast kernel (ops/engine_fast.py):
# f32 on device with a boundary band punted to exact host f64
MIN_ENTROPY_SCORE_F32 = 1.75
ENTROPY_BOUNDARY_BAND = 1e-4
