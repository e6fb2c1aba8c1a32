"""The flagship "model": a batched device alignment engine.

`DeviceAlignEngine` implements the `AlignEngine` interface
(`nimble_tpu.core.calls`) with the device pipeline:

  host: pad/bucket reads ── device: probe+walk (`ops.engine_fast`) ── host:
  exact f64 gates & metric filters (vectorized numpy) + per-read packaging.

Exactness strategy (parity with `pseudoalign`, `src/align.rs:945-989`):
  * length gate and Shannon-entropy gate are computed on host in f64 with the
    reference's operation order (the device only does the integer walk);
  * normalized-score comparison (score/len >= score_percent) is exact f64 on
    host;
  * reads the device cannot bound (anchor postings > C_MAX, or longer than
    the largest bucket) are re-run through the host oracle walk
    (`core.walk.map_read_with_mismatch`) — identical semantics, so results
    are exact for every read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import os as _os_af

# NIMBLE_ASYNC_FETCH=0 disables the dispatch-time device->host copy hint
_ASYNC_FETCH = _os_af.environ.get("NIMBLE_ASYNC_FETCH", "1") != "0"

# NIMBLE_REFCODE=1 enables the CRAM-style reference-coded upload (see
# compact_dispatch): exact-match reads ship as (row, off, len) in 8 wire
# bytes and are reconstructed bit-identically on device.  OFF by default:
# the ref/raw split adds a second launch stream per chunk (extra padding,
# submissions and fetches), which pays only where upload bandwidth
# dominates.
_REFCODE = _os_af.environ.get("NIMBLE_REFCODE", "0") == "1"

# NIMBLE_UNIFORM_LEN=0 disables the uniform-length payload (drops the
# uint16 length tail + bakes the length into the executable when a batch
# is fixed-length; see DeviceAlignEngine._launch_series)
_UNIFORM_LEN = _os_af.environ.get("NIMBLE_UNIFORM_LEN", "1") != "0"

import jax
import jax.numpy as jnp

from nimble_tpu.config import (
    MIN_ENTROPY_SCORE,
    MIN_READ_LENGTH,
    AlignFilterConfig,
    FilterReason,
)
from nimble_tpu.core.filters import (
    AlignmentScore,
    FilterRec,
    filter_alignment_by_metrics,
    pseudoalign,
)
from nimble_tpu.index.build import KmerIndex
from nimble_tpu.ops.device_index import (
    DeviceIndex,
    build_bucketed_index,
    build_device_index,
)
from nimble_tpu.ops.engine_fast import (
    probe_walk_full,
    unpack_compact,
)
from nimble_tpu.ops.engine_xla import probe_and_walk

# 92 sits between the Illumina-standard 90-91 bp read lengths and the
# next power-ish step: a 90 bp read packs to 23+2 bytes in the 92 bucket
# vs 24+2 in 96 (-4% wire on the upload-bound FASTQ path) and probes 61
# k-mer positions instead of 67
DEFAULT_BUCKETS = (64, 92, 96, 128, 160, 192, 256, 384, 512, 768, 1024)

# span-walk formulations (see DeviceAlignEngine); both are bit-identical
WALK_MODES = ("packed", "abs")

# sentinel padding value for sorted eq-class arrays (align_raw)
EQ_PAD = np.int64(2**31 - 1)


# per-byte code counts for 2-bit packed reads: _PACKED_COUNT_LUT[byte] =
# (#code0, #code1, #code2, #code3) among the byte's 4 bases
_PACKED_COUNT_LUT = np.zeros((256, 4), dtype=np.uint8)
for _b in range(256):
    for _s in (0, 2, 4, 6):
        _PACKED_COUNT_LUT[_b, (_b >> _s) & 3] += 1


def entropy_pass_packed(buf: np.ndarray, m: int, lens: np.ndarray,
                        nb: int) -> np.ndarray:
    """Exact-f64 Shannon-entropy gate from a packed read buffer.

    Counts bases via a 256-entry LUT over the 2-bit packed bytes (padding
    packs as code 0 and is subtracted), then evaluates the reference's
    entropy expression in the reference's f64 operation order
    (`src/utils.rs:96-119`: A,T,C,G frequency sum, negated) and compares
    against MIN_ENTROPY_SCORE.  Replaces the old on-device f32 gate and its
    boundary-band host rescues.
    """
    counts = (
        _PACKED_COUNT_LUT[buf[:m, :nb].reshape(-1)]
        .reshape(m, nb, 4)
        .sum(axis=1, dtype=np.int64)
    )
    lens = lens[:m].astype(np.int64)
    counts[:, 0] -= nb * 4 - lens  # zero-padding packs as code 0 ('A')
    tot = lens.astype(np.float64)
    tot_safe = np.where(tot == 0, 1.0, tot)
    ent = np.zeros(m, dtype=np.float64)
    for code in (0, 3, 1, 2):  # reference frequency order A, T, C, G
        f = counts[:, code] / tot_safe
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(f > 0.0, f * np.log2(np.where(f > 0.0, f, 1.0)), 0.0)
        ent += term
    return -ent >= MIN_ENTROPY_SCORE


def batch_entropy(reads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized Shannon entropy, f64, reference op order (A,T,C,G sum).

    Matches `shannon_entropy` (`src/utils.rs:96-119`) on decoded strings.
    """
    B, Lmax = reads.shape
    mask = np.arange(Lmax)[None, :] < lens[:, None]
    tot = lens.astype(np.float64)
    tot_safe = np.where(tot == 0, 1.0, tot)
    ent = np.zeros(B, dtype=np.float64)
    for code in (0, 3, 1, 2):  # A, T, C, G — the reference's frequency order
        cnt = ((reads == code) & mask).sum(axis=1)
        f = cnt / tot_safe
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(f > 0.0, f * np.log2(np.where(f > 0.0, f, 1.0)), 0.0)
        ent += term
    return -ent


def finalize_launch_output(outs):
    """Concat sub-launch outputs on device and start the device->host copy.

    Collect-side ``np.asarray`` then finds the bytes already local instead
    of paying a synchronous device->host copy per chunk — the copy streams
    as soon as the kernels finish.  ``NIMBLE_ASYNC_FETCH=0`` disables the
    copy hint.
    """
    out_dev = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    if _ASYNC_FETCH:
        try:
            out_dev.copy_to_host_async()
        except Exception:  # noqa: BLE001 — backend-optional hint
            pass
    return out_dev


def dedupe_packed_rows(buf_all: np.ndarray):
    """Group identical packed read rows; returns (first, inv).

    ``buf_all[first]`` are the distinct rows (first occurrence order of the
    sort) and ``buf_all[first][inv] == buf_all`` row-for-row — the full
    alignment result is a pure function of the packed row (trim-zeroed
    codes + length bytes), so duplicates upload and align once.  Uses the
    verified 64-bit row-mix grouping from `core.fast_count._group_rows_exact`
    (hash + representative verification, lexsort fallback) — ~2x cheaper
    than an np.unique void-view sort at BAM batch sizes.
    """
    from nimble_tpu.core.fast_count import _group_rows_exact

    m, w = buf_all.shape
    pad_w = (w + 7) & ~7
    if pad_w != w:
        padded = np.zeros((m, pad_w), dtype=np.uint8)
        padded[:, :w] = buf_all
    else:
        padded = np.ascontiguousarray(buf_all)
    rows64 = padded.view(np.int64).reshape(m, pad_w // 8)
    gid, reps = _group_rows_exact(rows64)
    return reps, gid


class DeviceAlignEngine:
    """Batched XLA alignment engine with host-exact filtering.

    ``walk`` selects the span-walk formulation: "packed" (default, the
    packed-domain scan) or "abs" (the unpacked absolute-coordinate walk,
    kept as the packed walk's test reference).  Both are bit-identical.
    """

    def __init__(
        self,
        index: KmerIndex,
        config: AlignFilterConfig,
        *,
        c_max: int = 8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        min_batch: int = 64,
        phase_a_positions: int = 8,
        launch_batch: int = 8192,
        walk: str = "packed",
        pad_launches: Optional[bool] = None,
    ):
        self.index = index
        self.config = config
        self.c_max = int(c_max)
        assert self.c_max <= 16, "compact result packing holds <=16 candidate lanes"
        self.buckets = tuple(sorted(buckets))
        self.min_batch = int(min_batch)
        # two-phase probe boundary, a per-engine STATIC kernel arg since
        # round 5 (VERDICT r4 item 5 asked for a per-dispatcher knob):
        # phase A probes the first N k-mer positions for every read; only
        # unresolved reads re-probe the tail.  0 = the module default
        # (NIMBLE_PROBE_PHASE_A, 8).  Results are bit-identical across
        # values; two engines with different values coexist in one
        # process as distinct executables (scripts/ab_multilib_inproc.py)
        self.phase_a_positions = int(phase_a_positions)
        # launches are capped at ONE fixed shape per bucket: every distinct
        # batch shape is its own executable with its own compile
        # (sub-batches pipeline; dispatch is async)
        self.launch_batch = int(launch_batch)
        # on accelerators, small batches pad UP to the launch shape: one
        # executable per bucket, each compiled once (and persistently
        # cached), at the cost of ~ms of wasted rows (CPU tests keep the
        # cheap pow2 sizing).  ``pad_launches`` overrides the backend
        # default explicitly (e.g. the multichip dryrun exercises the
        # padding discipline on CPU).
        if pad_launches is None:
            pad_launches = jax.default_backend() != "cpu"
        self._pad_launches = bool(pad_launches)
        if walk not in WALK_MODES:
            raise ValueError(
                f"walk={walk!r} is not a walk mode; expected one of "
                f"{WALK_MODES}"
            )
        self.walk = walk
        self.didx: DeviceIndex = build_device_index(index)
        self._s_min_cache: dict = {}
        # bucketized layout for the fast compact path
        self.bidx = build_bucketed_index(index)
        # one-int32-per-read compact result (HALF the fetched bytes) when
        # mask + 3 flags + bucket + lane fit below the sign bit
        self._compact_one_col = (
            self.bidx.width <= 8
            and self.c_max + 6 + (self.bidx.n_buckets - 1).bit_length() <= 31
        )
        self._dev_fast = {
            "bkey_lo": jnp.asarray(self.bidx.bkey_lo),
            "bkey_fp": jnp.asarray(self.bidx.bkey_fp),
            "bkey_hi": jnp.asarray(self.bidx.bkey_hi),
            "bstart": jnp.asarray(self.bidx.bstart),
            "bcount": jnp.asarray(self.bidx.bcount),
            "postings_row": jnp.asarray(self.bidx.postings_row),
            "postings_off": jnp.asarray(self.bidx.postings_off),
            "ref_codes_packed": jnp.asarray(self.bidx.ref_codes_packed),
            "row_starts": jnp.asarray(self.bidx.row_starts),
            "row_lengths": jnp.asarray(self.bidx.row_lengths),
        }
        self._dev = {
            "table_key_lo": jnp.asarray(self.didx.table_key_lo),
            "table_key_hi": jnp.asarray(self.didx.table_key_hi),
            "table_start": jnp.asarray(self.didx.table_start),
            "table_count": jnp.asarray(self.didx.table_count),
            "postings_row": jnp.asarray(self.didx.postings_row),
            "postings_off": jnp.asarray(self.didx.postings_off),
            "ref_codes": jnp.asarray(self.didx.ref_codes),
            "row_starts": jnp.asarray(self.didx.row_starts),
            "row_lengths": jnp.asarray(self.didx.row_lengths),
        }
        # device-resident config scalars + per-bucket s_min tables: every
        # host-side argument to a launch is a separate host->device
        # transfer, so all of them are cached on device once
        self._dev_scalars = (
            jnp.asarray(np.int32(config.score_threshold)),
            jnp.asarray(np.int32(config.num_mismatches)),
            jnp.asarray(np.bool_(config.discard_multiple_matches)),
            jnp.asarray(np.bool_(config.discard_nonzero_mismatch)),
        )
        self._s_min_dev_cache: dict = {}

    # --- AlignEngine interface -------------------------------------------

    def align_batch(
        self, seqs: Sequence[Optional[np.ndarray]]
    ) -> List[Tuple[Optional[AlignmentScore], Optional[FilterRec]]]:
        n = len(seqs)
        results: List[Tuple[Optional[AlignmentScore], Optional[FilterRec]]] = [
            (None, None)
        ] * n

        # Partition: skipped / short / device-eligible / host-only.
        device_idx: List[int] = []
        for i, s in enumerate(seqs):
            if s is None:
                continue
            if len(s) < MIN_READ_LENGTH:
                results[i] = (None, (FilterReason.SHORT_READ, 0.0, 0))
                continue
            if len(s) > self.buckets[-1]:
                results[i] = pseudoalign(s, self.index, self.config, MIN_READ_LENGTH)
                continue
            device_idx.append(i)

        if not device_idx:
            return results

        # Bucket by padded length.
        by_bucket: dict = {}
        for i in device_idx:
            L = len(seqs[i])
            bucket = next(b for b in self.buckets if b >= L)
            by_bucket.setdefault(bucket, []).append(i)

        for bucket, idxs in by_bucket.items():
            self._run_bucket(seqs, idxs, bucket, results)
        return results

    # --- compact interface: ~6 downloaded bytes per read ------------------

    def _s_min_table(self, lmax: int) -> np.ndarray:
        """Exact integer threshold table for the normalized-score gate.

        s_min[L] = min integer s with (s / L) >= score_percent under f64,
        the same expression the reference evaluates per read
        (`src/align.rs:968`, `src/filter/align.rs:17`) — so the device-side
        integer compare `score >= s_min[len]` is bit-equivalent.
        """
        key = (self.config.score_percent, lmax)
        cached = self._s_min_cache.get(key)
        if cached is not None:
            return cached
        p = float(self.config.score_percent)
        table = np.zeros(lmax + 1, dtype=np.int32)
        for L in range(1, lmax + 1):
            s = max(0, min(int(np.ceil(p * L)), L + 1))
            while s > 0 and (s - 1) / L >= p:
                s -= 1
            while s <= L and s / L < p:
                s += 1
            table[L] = s
        table[0] = np.int32(2**31 - 1)
        self._s_min_cache[key] = table
        return table

    def _launch_B(self, m: int) -> int:
        """Padded batch size for an m-read launch.

        Accelerator backends round UP to the fixed launch_batch shape (one
        executable per bucket — every extra shape is another compile); CPU
        keeps the cheap pow2 sizing."""
        lb = self.launch_batch
        if m > lb:
            return ((m + lb - 1) // lb) * lb
        if self._pad_launches:
            return lb
        return min(max(self.min_batch, 1 << (m - 1).bit_length()), lb)

    @staticmethod
    def _pack_reads(mat: np.ndarray, lens: np.ndarray, bucket: int,
                    B: int) -> np.ndarray:
        """Pack int8 codes + lengths into ONE uint8 (B, bucket/4 + 2) buffer.

        Every transfer has a fixed latency, so each launch ships exactly
        one host array; 2-bit packing also cuts the payload 4x.
        C++ fast path (nimble_pack_reads) when available — the NumPy pack's
        widen/astype/shift temporaries dominate paired-path dispatch time.
        """
        from nimble_tpu import native

        out = native.pack_reads(mat, lens, bucket, B)
        if out is not None:
            return out
        m, width = mat.shape
        nb = (bucket + 3) // 4
        buf = np.zeros((B, nb + 2), dtype=np.uint8)
        w4 = nb * 4
        src = np.zeros((m, w4), dtype=np.uint8)
        take = min(width, bucket)
        # mask to the 2-bit lane like the C++ kernel (& 3) so the two paths
        # stay provably identical even for out-of-range codes; the encode
        # LUT only emits 0..3, so this is defensive parity, not behavior
        src[:, :take] = mat[:, :take].astype(np.uint8) & 3
        q = src.reshape(m, nb, 4)
        buf[:m, :nb] = q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (
            q[:, :, 3] << 6
        )
        buf[:m, nb] = (lens & 0xFF).astype(np.uint8)
        buf[:m, nb + 1] = (lens >> 8).astype(np.uint8)
        return buf

    def compact_dispatch(self, mat: np.ndarray, lens: np.ndarray):
        """Launch the compact kernel for a chunk; returns an opaque state.

        Single-phase: every k-mer position is probed in one launch (device
        compute is ~0.1 ms per 256k reads — per-launch latency dominates, so
        fewer, fuller launches win).  jax dispatch is asynchronous; the
        caller overlaps host work before :meth:`compact_collect`.

        PRECONDITION: ``mat`` must be zero (code A) beyond each row's
        ``lens`` — the packed entropy gate reconstructs the true base-0
        count as ``count0 - (padded - len)``.  FASTQ matrices are built
        zero-padded; a caller slicing lens below row content (like the BAM
        trim path) must zero the tail first (``full_dispatch`` does).
        """
        n, width = mat.shape
        lens = np.asarray(lens, dtype=np.int32)
        needs_host = lens > self.buckets[-1]
        eligible = (lens >= MIN_READ_LENGTH) & ~needs_host
        launches = []
        if eligible.any():
            bucket_arr = np.asarray(self.buckets)
            bucket_idx = np.searchsorted(bucket_arr, lens)
            present = np.unique(bucket_idx[eligible])
            for bi in present:
                bucket = int(bucket_arr[bi])
                if len(present) == 1 and eligible.all():
                    sel = None  # whole chunk, no row copy
                    bmat, blens, m = mat, lens, n
                else:
                    sel_idx = np.flatnonzero(eligible & (bucket_idx == bi))
                    sel, m = sel_idx, len(sel_idx)
                    bmat, blens = mat[sel_idx], lens[sel_idx]
                # ONE host->device upload for the whole bucket batch, then
                # one kernel launch per fixed-size sub-slice of the
                # device-resident buffer (the fixed 8192-read body compiles
                # once; the sub-batches are issued as separate async
                # launches rather than a lax.map loop), then ONE fetch of
                # the device-concatenated results in compact_collect.
                #
                # CRAM-style reference-coded upload (NIMBLE_REFCODE=0
                # disables): reads VERIFIED byte-equal to a library window
                # ship as (row, off, len) in 8 wire bytes instead of
                # ceil(bucket/4)+2, and the kernel reconstructs them from
                # the device-resident reference — bit-identical inputs,
                # unchanged kernel semantics.  Error-free reads are the
                # majority of real Illumina data.
                lb = self.launch_batch
                ref_mask = rr = ro = None
                if _REFCODE:
                    ref_mask, rr, ro = self._refcode_rows(bmat, blens)
                if ref_mask is not None and ref_mask.any():
                    splits = []
                    raw_i = np.flatnonzero(~ref_mask)
                    if len(raw_i):
                        splits.append((False, raw_i))
                    splits.append((True, np.flatnonzero(ref_mask)))
                else:
                    splits = [(False, None)]
                for is_ref, idx in splits:
                    if idx is None:
                        smat, slens, sm, ssel = bmat, blens, m, sel
                    else:
                        smat, slens, sm = bmat[idx], blens[idx], len(idx)
                        ssel = idx if sel is None else sel[idx]
                    if is_ref:
                        B = self._launch_B(sm)
                        n_sub = (B + lb - 1) // lb
                        # packed rows serve the host-side entropy gate
                        buf = self._pack_reads(smat, slens, bucket, sm)
                        rbuf = np.zeros((B, 8), dtype=np.uint8)
                        r32 = rr[idx].astype(np.uint32)
                        o16 = ro[idx].astype(np.uint32)
                        l16 = slens.astype(np.uint32)
                        for byte, val in enumerate(
                            (r32, r32 >> 8, r32 >> 16, r32 >> 24,
                             o16, o16 >> 8, l16, l16 >> 8)
                        ):
                            rbuf[:sm, byte] = (val & 0xFF).astype(np.uint8)
                        dev_in = jnp.asarray(rbuf.reshape(n_sub, min(B, lb), 8))
                        outs = [
                            self._launch_refcoded_kernel(
                                dev_in[i : i + 1], bucket
                            )
                            for i in range(n_sub)
                        ]
                        out_dev = finalize_launch_output(outs)
                    else:
                        out_dev, buf = self._launch_series(
                            smat, slens, bucket
                        )
                    launches.append((bucket, ssel, sm, out_dev, buf, slens))
        return {"n": n, "lens": lens, "needs_host": needs_host,
                "launches": launches}

    def _launch_series(self, smat: np.ndarray, slens: np.ndarray,
                       bucket: int):
        """Pack + upload + async-launch one bucket batch; returns
        (device-concatenated output, packed host buffer for the entropy
        gate).

        Wire-byte discipline (round 5):

        * GEOMETRIC TAIL — instead of padding the last sub-launch to the
          full ``launch_batch`` (up to lb-1 zero rows whose bytes ride the
          upload AND the result fetch for nothing), the tail launch uses
          the smallest size in {lb, lb/2, lb/4, lb/8} that fits the
          remainder.  Each size compiles once per bucket (persistent
          cache); a 33k-read batch saves ~20% of its padding bytes.
        * UNIFORM LENGTH — when every read in the batch has the same
          length (fixed-length Illumina chunks, the common case), the
          per-row uint16 length tail is dropped from the payload
          (ceil(bucket/4) bytes/read instead of +2) and the length bakes
          into the executable as a constant
          (`probe_walk_filter_packed_chunked` uniform_len).
          NIMBLE_UNIFORM_LEN=0 disables (one extra executable per length).

        With ``pad_launches`` off (CPU/tests) small batches keep the old
        single pow2-sized launch; both padding rows and uniform-length
        results for rows >= sm are discarded at collect, so the result is
        bit-identical either way (parity-tested).
        """
        lb = self.launch_batch
        sm = smat.shape[0]
        if sm <= lb and not self._pad_launches:
            sizes = [self._launch_B(sm)]
        else:
            sizes = [lb] * (sm // lb)
            t = sm - lb * len(sizes)
            if t or not sizes:
                tail = lb
                for cand in (lb // 8, lb // 4, lb // 2):
                    if cand >= max(t, self.min_batch, 1):
                        tail = cand
                        break
                sizes.append(tail)
        B_total = sum(sizes)
        buf = self._pack_reads(smat, slens, bucket, B_total)
        nb = (bucket + 3) // 4
        uni = 0
        if _UNIFORM_LEN and sm and (slens == slens[0]).all():
            uni = int(slens[0])
        payload = np.ascontiguousarray(buf[:, :nb]) if uni else buf
        dev = jnp.asarray(payload)
        outs = []
        off = 0
        for sz in sizes:
            out = self._launch_chunked_kernel(
                dev[off : off + sz][None], bucket, uniform_len=uni
            )
            outs.append(out.reshape(sz, out.shape[-1]))
            off += sz
        return finalize_launch_output(outs), buf

    def _refcode_rows(self, bmat: np.ndarray, blens: np.ndarray):
        """Identify reads that are EXACT full-length library windows.

        Returns (is_ref (m,) bool, row (m,) int32, off (m,) int32): for
        flagged reads, ``row_codes[row][off : off+len]`` equals the read
        byte-for-byte (verified here with a vectorized gather-compare, so
        the device reconstruction is bit-identical by construction).  The
        candidate window is the FIRST posting of the read's first k-mer —
        one attempt; anything else falls back to the raw upload path.
        """
        k = self.bidx.k
        m, W = bmat.shape
        is_ref = np.zeros(m, dtype=bool)
        row = np.zeros(m, dtype=np.int32)
        off = np.zeros(m, dtype=np.int32)
        ok = blens >= k
        if not ok.any():
            return is_ref, row, off
        idx0 = self.index
        ks = idx0.keys_sorted
        if not len(ks):
            return is_ref, row, off
        powers = np.uint64(1) << (
            np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
        )
        keys = (bmat[:, :k].astype(np.uint64) * powers).sum(
            axis=1, dtype=np.uint64
        )
        i = np.clip(np.searchsorted(ks, keys), 0, len(ks) - 1)
        found = ok & (ks[i] == keys)
        ps = idx0.post_starts[i]
        cand_row = idx0.postings_rows[np.clip(ps, 0, len(idx0.postings_rows) - 1)]
        cand_off = idx0.postings_offs[np.clip(ps, 0, len(idx0.postings_offs) - 1)]
        # the wire format carries the window offset as uint16 — reads
        # anchored past 65,535 bp in a long feature must take the raw
        # path (silently truncating the offset would reconstruct a
        # DIFFERENT window and break device exactness)
        fits = found & (
            (cand_off + blens <= idx0.row_lengths[cand_row])
            & (cand_off <= 0xFFFF)
        )
        cand = np.flatnonzero(fits)
        if not len(cand):
            return is_ref, row, off
        ref_flat = self.didx.ref_codes
        starts = (
            self.didx.row_starts[cand_row[cand]].astype(np.int64)
            + cand_off[cand]
        )
        win = ref_flat[
            np.clip(
                starts[:, None] + np.arange(W, dtype=np.int64)[None, :],
                0, len(ref_flat) - 1,
            )
        ]
        jj = np.arange(W, dtype=np.int32)[None, :]
        good = ((win == bmat[cand]) | (jj >= blens[cand][:, None])).all(axis=1)
        hit = cand[good]
        is_ref[hit] = True
        row[hit] = cand_row[hit]
        off[hit] = cand_off[hit]
        return is_ref, row, off

    def _launch_refcoded_kernel(self, ref3: np.ndarray, bucket: int):
        from nimble_tpu.ops.engine_fast import (
            probe_walk_filter_refcoded_chunked,
        )

        thr, nmm, dm, dn = self._dev_scalars
        return probe_walk_filter_refcoded_chunked(
            jnp.asarray(ref3),
            self._dev_fast["bkey_lo"], self._dev_fast["bkey_hi"],
            self._dev_fast["bkey_fp"],
            self._dev_fast["bstart"], self._dev_fast["bcount"],
            self._dev_fast["postings_row"], self._dev_fast["postings_off"],
            self._dev_fast["ref_codes_packed"],
            self._dev_fast["row_starts"], self._dev_fast["row_lengths"],
            self._s_min_dev(bucket), thr, nmm, dm, dn,
            k=self.bidx.k, max_probe=self.bidx.max_probe, c_max=self.c_max,
            bucket_mask=self.bidx.n_buckets - 1,
            p_limit=bucket - self.bidx.k + 1,
            ref_pad=self.bidx.ref_pad, bucket=bucket,
            walk=self.walk,
            phase_a=self.phase_a_positions,
            one_col=self._compact_one_col,
        )

    def compact_collect(self, state, defer_unresolved: bool = False):
        """Fetch results and assemble the flat result dict (see
        align_raw_compact_from_matrix).  ``defer_unresolved`` is accepted
        for API compatibility; the single-phase kernel resolves every read
        in its first launch, so the returned ``unresolved`` mask is all
        False."""
        n = state["n"]
        astart = np.zeros(n, dtype=np.int64)
        mask = np.zeros(n, dtype=np.int32)
        passed = np.zeros(n, dtype=bool)
        needs_host = state["needs_host"]

        for bucket, sel, m, out_dev, buf, blens in state["launches"]:
            # ONE fetch per bucket batch; the dispatch already concatenated
            # on device and started the host copy, so this is usually a
            # local read rather than a synchronous device->host copy
            raw = np.asarray(out_dev)
            if self._compact_one_col:
                from nimble_tpu.ops.engine_fast import unpack_compact_one

                out = unpack_compact_one(
                    raw.reshape(-1, raw.shape[-1]), self.c_max,
                    self.bidx.n_buckets - 1, self.bidx.bstart,
                )
            else:
                out = unpack_compact(raw.reshape(-1, raw.shape[-1]))
            # exact-f64 entropy gate on host (`src/align.rs:960`); the
            # kernel's passed/needs_host bits exclude it by design
            nb = (bucket + 3) // 4
            ent_ok = entropy_pass_packed(buf, m, blens, nb)
            ps = out["passed"][:m] & ent_ok
            nh = out["needs_host"][:m] & ent_ok
            if sel is None:
                astart[:] = out["astart"][:m]
                mask[:] = out["mask"][:m]
                passed[:] = ps
                needs_host[:] = nh
            else:
                astart[sel] = out["astart"][:m]
                mask[sel] = out["mask"][:m]
                passed[sel] = ps
                needs_host[sel] = nh

        result = {"astart": astart, "mask": mask, "passed": passed,
                  "needs_host": needs_host}
        if defer_unresolved:
            result["unresolved"] = np.zeros(n, dtype=bool)
        return result

    # --- columnar full-output interface (BAM/forensic fast path) ----------

    def full_dispatch(self, mat: np.ndarray, lens: np.ndarray,
                      active: np.ndarray):
        """Launch the full-output kernel for a batch; returns opaque state.

        ``active`` marks reads that should be aligned (False = skipped/None
        entries, which get no result).  Same packing/latency discipline as
        compact_dispatch.
        """
        from nimble_tpu.ops.engine_fast import probe_walk_full_packed_chunked

        n = mat.shape[0]
        lens = np.asarray(lens, dtype=np.int32)
        act = np.asarray(active, dtype=bool)
        host_rescue = act & (lens > self.buckets[-1])
        eligible = act & (lens >= MIN_READ_LENGTH) & ~host_rescue
        launches = []
        if eligible.any():
            # zero codes beyond the (trimmed) length so the packed buffer's
            # zero-padding assumption holds for the packed entropy gate
            mat_z = np.where(
                np.arange(mat.shape[1], dtype=np.int32)[None, :]
                < lens[:, None],
                mat, 0,
            ).astype(np.int8, copy=False)
            bucket_arr = np.asarray(self.buckets)
            bucket_idx = np.searchsorted(bucket_arr, lens)
            for bi in np.unique(bucket_idx[eligible]):
                bucket = int(bucket_arr[bi])
                sel = np.flatnonzero(eligible & (bucket_idx == bi))
                lb = self.launch_batch
                # pre-upload dedupe (the BAM analog of the FASTQ path's
                # seen-set): the full result is a pure function of the
                # packed row bytes (trim-zeroed codes + length), so
                # duplicate reads — the 10x norm — upload and align ONCE
                # and scatter back through `inv` at collect time
                buf_all = self._pack_reads(
                    mat_z[sel], lens[sel], bucket, len(sel)
                )
                first, inv = dedupe_packed_rows(buf_all)
                m = len(first)
                B = self._launch_B(m)
                buf = np.zeros((B, buf_all.shape[1]), dtype=np.uint8)
                buf[:m] = buf_all[first]
                n_sub = (B + lb - 1) // lb
                buf_dev = jnp.asarray(
                    buf.reshape(n_sub, min(B, lb), buf.shape[1])
                )
                outs = [
                    probe_walk_full_packed_chunked(
                        buf_dev[i : i + 1],
                        self._dev_fast["bkey_lo"], self._dev_fast["bkey_hi"],
                        self._dev_fast["bkey_fp"],
                        self._dev_fast["bstart"], self._dev_fast["bcount"],
                        self._dev_fast["postings_row"],
                        self._dev_fast["postings_off"],
                        self._dev_fast["ref_codes_packed"],
                        self._dev_fast["row_starts"],
                        self._dev_fast["row_lengths"],
                        k=self.bidx.k, max_probe=self.bidx.max_probe,
                        c_max=self.c_max, bucket_mask=self.bidx.n_buckets - 1,
                        p_limit=bucket - self.bidx.k + 1,
                        ref_pad=self.bidx.ref_pad, bucket=bucket,
                        walk=self.walk,
                        phase_a=self.phase_a_positions,
                    )
                    for i in range(n_sub)
                ]
                out_dev = finalize_launch_output(outs)
                launches.append((sel, m, out_dev, buf, bucket, inv))
        return {"n": n, "mat": mat, "lens": lens, "active": act,
                "host_rescue": host_rescue, "launches": launches}

    from nimble_tpu.config import FILTER_REASONS as _REASON_LIST
    from nimble_tpu.config import FILTER_REASON_CODE as _REASON_CODE

    def full_collect(self, state):
        """Fetch + apply the exact host-side gates; columnar pseudoalign.

        Returns dict over N reads:
          reason  int16 — index into ``_REASON_LIST`` for filtered reads,
                          -1 = passed, -2 = inactive (None input)
          norm    f64 (reported normalized score), score i32
          eq_key  int64 — >=0: device combo (astart<<c_max | mask);
                          <=-2: rescued id (see ``rescued``); -1: no eq class
          rescued dict rescue_id -> eq list
        Semantics are exactly `pseudoalign` per read (`src/align.rs:945-989`
        + `src/filter/align.rs:4-45`), vectorized.
        """
        from nimble_tpu.ops.engine_fast import unpack_full_packed

        n = state["n"]
        mat, lens, act = state["mat"], state["lens"], state["active"]
        reason = np.full(n, -2, dtype=np.int16)
        norm = np.zeros(n, dtype=np.float64)
        score = np.zeros(n, dtype=np.int32)
        eq_key = np.full(n, -1, dtype=np.int64)
        rescued: dict = {}
        cfg = self.config
        code = self._REASON_CODE

        short = act & (lens < MIN_READ_LENGTH)
        reason[short] = code[FilterReason.SHORT_READ]

        next_rescue = -2

        def host_align(i):
            nonlocal next_rescue
            alignment, filt = pseudoalign(
                mat[i, : lens[i]], self.index, cfg, MIN_READ_LENGTH
            )
            if alignment is not None:
                eq, nrm, sc = alignment
                rescued[next_rescue] = list(eq)
                eq_key[i] = next_rescue
                next_rescue -= 1
                reason[i] = -1
                norm[i] = nrm
                score[i] = sc
            else:
                reason[i] = code[filt[0]]
                norm[i] = filt[1]
                score[i] = filt[2]

        for i in np.flatnonzero(state["host_rescue"]):
            host_align(i)

        for launch in state["launches"]:
            # 6-tuple: deduped launch (m distinct rows, `inv` scatters the
            # per-distinct results back over `sel`); 5-tuple: legacy 1:1
            if len(launch) == 6:
                sel, m, out_dev, buf, bucket, inv = launch
            else:
                sel, m, out_dev, buf, bucket = launch
                inv = None
            raw = np.asarray(out_dev)           # ONE fetch per bucket batch
            out = unpack_full_packed(raw.reshape(-1, raw.shape[-1]))
            nb = (bucket + 3) // 4
            if inv is None:
                sub_lens = lens[sel]
            else:
                # distinct-row lengths live in the packed buffer itself
                sub_lens = (
                    buf[:m, nb].astype(np.int32)
                    | (buf[:m, nb + 1].astype(np.int32) << 8)
                )
            # exact-f64 entropy gate from the packed (trim-zeroed) buffer
            low_ent = ~entropy_pass_packed(
                buf, m, sub_lens, nb
            )
            ha = out["has_anchor"][:m]
            ov = out["overflow"][:m] & ~low_ent
            sc = out["score"][:m].astype(np.int32)
            mm = out["mismatches"][:m].astype(np.int32)
            nrm = sc / sub_lens  # f64, parity with `src/align.rs:968`

            # decode distinct-row counts for the multiple-match gate
            keys = (
                out["astart"][:m].astype(np.int64) << self.c_max
            ) | out["mask"][:m]
            counts = self._decode_counts(keys, ha)

            r = np.full(m, -1, dtype=np.int16)
            nr = np.zeros(m, dtype=np.float64)
            s_out = np.zeros(m, dtype=np.int32)
            k_out = np.full(m, -1, dtype=np.int64)

            r[low_ent] = code[FilterReason.HIGH_ENTROPY]
            live = ~low_ent & ~ov
            no_match = live & ~ha
            r[no_match] = code[FilterReason.NO_MATCH]
            cand = live & ha

            if cfg.discard_nonzero_mismatch:
                dz = cand & (mm != 0)
                r[dz] = code[FilterReason.DISCARDED_NONZERO_MISMATCH]
                cand = cand & ~dz

            gates = (
                (sc >= cfg.score_threshold)
                & (nrm >= cfg.score_percent)
            )
            below = cand & ~gates
            r[below] = code[FilterReason.SCORE_BELOW_THRESHOLD]
            nr[below] = nrm[below]
            s_out[below] = sc[below]
            cand = cand & gates

            if cfg.discard_multiple_matches:
                multi = cand & (counts > 1)
                r[multi] = code[FilterReason.DISCARDED_MULTIPLE_MATCH]
                nr[multi] = nrm[multi]
                s_out[multi] = sc[multi]
                cand = cand & ~multi

            above = cand & (mm > cfg.num_mismatches)
            r[above] = code[FilterReason.ABOVE_MISMATCH_THRESHOLD]
            nr[above] = nrm[above]
            s_out[above] = sc[above]
            cand = cand & ~above

            nr[cand] = nrm[cand]
            s_out[cand] = sc[cand]
            k_out[cand] = keys[cand]

            if inv is not None:
                # scatter the per-distinct results over the duplicates
                r, nr, s_out, k_out = r[inv], nr[inv], s_out[inv], k_out[inv]
                ov = ov[inv]
            reason[sel] = r
            norm[sel] = nr
            score[sel] = s_out
            eq_key[sel] = k_out

            # anchor-postings overflow: exact host rescue (rare; each
            # original row gets its own rescue id, matching the 1:1 path)
            for j in np.flatnonzero(ov):
                host_align(int(sel[j]))

        return {"reason": reason, "norm": norm, "score": score,
                "eq_key": eq_key, "rescued": rescued}

    EQ_ROW_PAD = np.int64(2**62)

    def decode_rows_padded(self, keys: np.ndarray,
                           valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized decode of device combo keys -> sorted distinct eq rows,
        (M, c_max) int64 padded with EQ_ROW_PAD (duplicates blanked)."""
        c_max = self.c_max
        prow = self.bidx.postings_row
        if valid is None:
            valid = keys >= 0
        astart = np.where(valid, keys >> c_max, 0).astype(np.int64)
        mask = np.where(valid, keys & ((1 << c_max) - 1), 0).astype(np.int64)
        lanes = np.arange(c_max, dtype=np.int64)
        rows = prow[
            np.clip(astart[:, None] + lanes[None, :], 0, len(prow) - 1)
        ].astype(np.int64)
        big = self.EQ_ROW_PAD
        bit = ((mask[:, None] >> lanes[None, :]) & 1).astype(bool)
        rows = np.where(bit & valid[:, None], rows, big)
        rows.sort(axis=1)
        dup = np.zeros_like(rows, dtype=bool)
        dup[:, 1:] = (rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] != big)
        rows = np.where(dup, big, rows)
        rows.sort(axis=1)
        return rows

    def _decode_counts(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Distinct eq-row count per device combo key (vectorized)."""
        rows = self.decode_rows_padded(keys, valid)
        return (rows != self.EQ_ROW_PAD).sum(axis=1).astype(np.int32)

    def align_raw_compact_from_matrix(self, mat: np.ndarray, lens: np.ndarray):
        """Minimum-download batch alignment: the whole filter chain runs on
        device; the result identifies each read's equivalence class as
        (anchor postings start, live-lane bitmask) — see
        `ops.engine_fast.probe_walk_filter` and :meth:`decode_combo`.

        Returns dict arrays over N reads:
          astart (N,) int64, mask (N,) int32, passed (N,) bool,
          needs_host (N,) bool
        """
        return self.compact_collect(self.compact_dispatch(mat, lens))

    def _s_min_dev(self, bucket: int):
        t = self._s_min_dev_cache.get(bucket)
        if t is None:
            t = jnp.asarray(self._s_min_table(bucket))
            self._s_min_dev_cache[bucket] = t
        return t

    def _launch_chunked_kernel(self, buf3: np.ndarray, bucket: int,
                               uniform_len: int = 0):
        from nimble_tpu.ops.engine_fast import probe_walk_filter_packed_chunked

        thr, nmm, dm, dn = self._dev_scalars
        return probe_walk_filter_packed_chunked(
            jnp.asarray(buf3),
            self._dev_fast["bkey_lo"], self._dev_fast["bkey_hi"],
            self._dev_fast["bkey_fp"],
            self._dev_fast["bstart"], self._dev_fast["bcount"],
            self._dev_fast["postings_row"], self._dev_fast["postings_off"],
            self._dev_fast["ref_codes_packed"], self._dev_fast["row_starts"],
            self._dev_fast["row_lengths"],
            self._s_min_dev(bucket), thr, nmm, dm, dn,
            k=self.bidx.k,
            max_probe=self.bidx.max_probe,
            c_max=self.c_max,
            bucket_mask=self.bidx.n_buckets - 1,
            p_limit=bucket - self.bidx.k + 1,
            ref_pad=self.bidx.ref_pad,
            bucket=bucket,
            walk=self.walk,
            phase_a=self.phase_a_positions,
            one_col=self._compact_one_col,
            uniform_len=uniform_len,
        )

    def decode_combo(self, astart: int, mask: int) -> List[int]:
        """(astart, mask) -> sorted distinct eq-class row ids (host-side)."""
        rows = []
        c = 0
        m = int(mask)
        base = int(astart)
        prow = self.bidx.postings_row  # compact astart indexes the bucketized postings
        while m:
            if m & 1:
                rows.append(int(prow[base + c]))
            m >>= 1
            c += 1
        return sorted(set(rows))

    # --- internals --------------------------------------------------------

    def _pad_batch(self, seqs, idxs, bucket):
        B = 1
        while B < len(idxs):
            B *= 2
        B = max(B, self.min_batch)
        reads = np.zeros((B, bucket), dtype=np.int8)
        lens = np.zeros(B, dtype=np.int32)
        for j, i in enumerate(idxs):
            s = seqs[i]
            reads[j, : len(s)] = s
            lens[j] = len(s)
        return reads, lens

    def _run_full_kernel(self, reads, blens, bucket, p_limit):
        out = probe_walk_full(
            jnp.asarray(reads), jnp.asarray(blens),
            self._dev_fast["bkey_lo"], self._dev_fast["bkey_hi"],
                        self._dev_fast["bkey_fp"],
            self._dev_fast["bstart"], self._dev_fast["bcount"],
            self._dev_fast["postings_row"], self._dev_fast["postings_off"],
            self._dev_fast["ref_codes_packed"], self._dev_fast["row_starts"],
            self._dev_fast["row_lengths"],
            k=self.bidx.k,
            max_probe=self.bidx.max_probe,
            c_max=self.c_max,
            bucket_mask=self.bidx.n_buckets - 1,
            p_limit=min(p_limit, bucket - self.bidx.k + 1),
            ref_pad=self.bidx.ref_pad,
            walk=self.walk,
            phase_a=self.phase_a_positions,
        )
        return {k: np.array(v) for k, v in jax.device_get(out).items()}

    def _run_bucket(self, seqs, idxs, bucket, results) -> None:
        reads, lens = self._pad_batch(seqs, idxs, bucket)
        m = len(idxs)

        # single-phase: all k-mer positions probed in one launch (per-launch
        # latency dwarfs the extra probe compute)
        out = self._run_full_kernel(reads, lens, bucket, bucket)

        # Host-exact gates + filters.
        ent = batch_entropy(reads, lens)
        cfg = self.config
        for j, i in enumerate(idxs):
            s = seqs[i]
            if ent[j] < MIN_ENTROPY_SCORE:
                results[i] = (None, (FilterReason.HIGH_ENTROPY, 0.0, 0))
                continue
            if out["overflow"][j]:
                # anchor postings exceeded C_MAX — exact host rescue
                results[i] = pseudoalign(s, self.index, cfg, MIN_READ_LENGTH)
                continue
            if not out["has_anchor"][j]:
                results[i] = (None, (FilterReason.NO_MATCH, 0.0, 0))
                continue
            eq = self.decode_combo(int(out["astart"][j]), int(out["mask"][j]))
            score = int(out["score"][j])
            mismatches = int(out["mismatches"][j])
            normalized = score / len(s)  # f64, parity with `src/align.rs:968`
            if cfg.discard_nonzero_mismatch and mismatches != 0:
                results[i] = (None, (FilterReason.DISCARDED_NONZERO_MISMATCH, 0.0, 0))
                continue
            results[i] = filter_alignment_by_metrics(
                eq,
                score,
                normalized,
                cfg.score_threshold,
                cfg.score_percent,
                cfg.discard_multiple_matches,
                cfg.num_mismatches,
                mismatches,
            )
