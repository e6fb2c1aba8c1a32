"""High-throughput counting path for the FASTQ workload.

Semantically identical to `core.calls.get_calls` -> counts (the FASTQ
pipeline discards the per-read forensics, `src/process/fastq.rs:16-27`), but
restructured for batch throughput:

  1. the engine's compact interface runs the WHOLE per-read filter chain on
     device and downloads ~6 bytes/read: a (anchor-postings-start, live-lane
     bitmask) pair that exactly identifies the read's equivalence class
     without shipping it (decoded host-side from the postings array);
  2. read-pairs are DEDUPED by sequence bytes: the reference's score map is
     keyed by the read(+mate) string (`src/align.rs:574-579`), so duplicate
     pairs contribute ONCE;
  3. the string-shaped tail (orientation/chemistry filtering, intersect
     levels, group rollup, natural sort) runs once per distinct
     (eq1, eq2) combination — real libraries produce few combos regardless
     of read count.

Reads the device could not decide exactly (candidate overflow, entropy on
the f32 boundary, oversized reads) are rescued through the per-read host
oracle, preserving exactness for every read.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nimble_tpu.config import (
    MIN_READ_LENGTH,
    AlignFilterConfig,
    PairState,
)
from nimble_tpu.core.calls import sort_score_vector
from nimble_tpu.core.filters import pseudoalign
from nimble_tpu.core.orientation import filter_and_coerce_sequence_call_orientations
from nimble_tpu.library import Reference


def pack_matrix(reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of coded reads into an (N, Lmax) int8 matrix + lengths."""
    n = len(reads)
    lmax = max((len(r) for r in reads), default=1)
    mat = np.zeros((n, max(lmax, 1)), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = r
        lens[i] = len(r)
    return mat, lens


def dedupe_admit(seen, mat, lens, mate_mat=None, mate_lens=None):
    """Seen-set admission on the read(+mate) bytes (the reference's score-map
    key, `src/align.rs:574-579`): filters the chunk to unseen rows.

    Returns (mat, lens, mate_mat, mate_lens, prededuped).  ``seen`` is a
    native dedupe set (or None -> no-op with prededuped False).

    The key is the PLAIN r1+r2 concatenation, exactly like the reference's
    score map.  One deliberate divergence: on a key collision the reference
    keeps the LAST pair's alignment (HashMap insert replaces) while this
    path keeps the FIRST (later duplicates are dropped before alignment).
    The two differ only when differently-split pairs share a concatenation
    AND align differently — re-aligning duplicates to honor last-write-wins
    would forfeit the entire pre-upload dedupe.
    """
    if seen is None or not mat.shape[0]:
        return mat, lens, mate_mat, mate_lens, False
    flat1, off1 = FastCounter._flatten_rows(mat, lens)
    if mate_mat is not None:
        flat2, off2 = FastCounter._flatten_rows(mate_mat, mate_lens)
    else:
        flat2, off2 = None, None
    is_new = seen.insert_batch(flat1, off1, flat2, off2)
    new_idx = np.flatnonzero(is_new)
    if len(new_idx) < mat.shape[0]:
        mat, lens = mat[new_idx], lens[new_idx]
        if mate_mat is not None:
            mate_mat = mate_mat[new_idx]
            mate_lens = mate_lens[new_idx]
    return mat, lens, mate_mat, mate_lens, True


def stack_pair(mat, lens, mate_mat, mate_lens):
    """Stack R1 and R2 matrices into one (2N, Wmax) batch for a single
    device transaction.  Rows stay zero-padded beyond their lengths (the
    packed entropy gate's precondition)."""
    w = max(mat.shape[1], mate_mat.shape[1])

    def _widen(m):
        if m.shape[1] == w:
            return m
        out = np.zeros((m.shape[0], w), dtype=m.dtype)
        out[:, : m.shape[1]] = m
        return out

    stacked = np.concatenate([_widen(mat), _widen(mate_mat)], axis=0)
    return stacked, np.concatenate([lens, mate_lens])


def split_stacked(raw: dict, n: int) -> Tuple[dict, dict]:
    """Split a stacked R1+R2 compact result back into per-mate dicts.

    Every value in a compact raw dict is row-indexed (compact_collect's
    contract), so rows [0, n) are R1 and [n, ...) are R2."""
    return (
        {k: v[:n] for k, v in raw.items()},
        {k: v[n:] for k, v in raw.items()},
    )


class _Synchronous:
    """Future-shaped wrapper for the no-executor path: runs the device
    transaction at .result() time (i.e. in :meth:`FastCounter.process`)."""

    def __init__(self, job):
        self._job = job
        self._done = False
        self._value = None
        self._exc = None

    def result(self):
        if not self._done:
            job, self._job = self._job, None
            self._done = True
            try:
                self._value = job()
            except BaseException as e:  # noqa: BLE001 — Future parity
                # cache like concurrent.futures.Future: a second result()
                # replays the stored exception instead of re-launching
                # device work
                self._exc = e
                raise
        if self._exc is not None:
            raise self._exc
        return self._value


def submit_transaction(fetcher, dispatch_fn, collect_fn, args):
    """Launch one device transaction under the NIMBLE_DISPATCH policy and
    return a future-shaped handle (.result() -> collected output).

    Default ("inline"): dispatch (pack + upload + async launch) on the
    CALLING thread, collect on the worker, so uploads and fetches of
    neighbouring chunks overlap.  NIMBLE_DISPATCH=worker moves the whole
    transaction onto the worker for transports where the upload blocks the
    caller without overlapping anything.  With no executor the
    transaction runs lazily at .result() time.
    """
    if fetcher is None:
        return _Synchronous(lambda: collect_fn(dispatch_fn(*args)))
    if os.environ.get("NIMBLE_DISPATCH") == "worker":
        return fetcher.submit(lambda: collect_fn(dispatch_fn(*args)))
    state = dispatch_fn(*args)
    return fetcher.submit(collect_fn, state)


def _group_rows_exact(
    rows: np.ndarray, _force_lexsort: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Group identical rows of an (N, W) int64 matrix, exactly.

    Returns (gid (N,) group id per row, reps (G,) row index of each group's
    first occurrence).  Hash-buckets rows with a vectorized 64-bit mix and
    then VERIFIES every row against its group representative — a silent
    hash collision would merge different eq contents into one count — with
    a lexsort fallback when verification ever fails.  ~4x faster than
    np.lexsort on the combo tables this path sees (39k rows, ~100 groups).
    """
    n = rows.shape[0]
    h = np.zeros(n, dtype=np.uint64)
    for c in range(rows.shape[1]):  # boost-style order-dependent combine
        h ^= (
            rows[:, c].astype(np.uint64)
            + np.uint64(0x9E3779B97F4A7C15)
            + (h << np.uint64(6))
            + (h >> np.uint64(2))
        )
    _, gid = np.unique(h, return_inverse=True)
    n_groups = int(gid.max()) + 1 if n else 0
    reps = np.zeros(n_groups, dtype=np.int64)
    reps[gid[::-1]] = np.arange(n - 1, -1, -1)  # first occurrence wins
    if _force_lexsort or not (rows == rows[reps[gid]]).all():
        # hash collision (vanishingly rare): exact lexsort grouping
        order = np.lexsort(rows.T[::-1])
        s = rows[order]
        new = np.empty(n, dtype=bool)
        new[0] = True
        new[1:] = (s[1:] != s[:-1]).any(axis=1)
        gid_sorted = np.cumsum(new) - 1
        gid = np.empty(n, dtype=np.int64)
        gid[order] = gid_sorted
        # representative = first occurrence in ORIGINAL order
        n_groups = int(gid_sorted[-1]) + 1
        reps = np.zeros(n_groups, dtype=np.int64)
        reps[gid[::-1]] = np.arange(n - 1, -1, -1)
    return gid, reps


def _combo_ids(mat, lens, engine, which_label, raw=None):
    """Run the compact device path + host rescue for one mate side.

    Returns (cid (N,) int64, eq_of_cid dict).  cid semantics:
      -1            — read did not pass (no eq class)
      >= 0          — device result: astart * 2^c_max + mask
      <= -2         — rescued read with an out-of-band eq class
    ``eq_of_cid`` maps every non-(-1) cid to its eq-class list.
    """
    if raw is None:
        raw = engine.align_raw_compact_from_matrix(mat, lens)
    c_max = engine.c_max
    cid = np.where(
        raw["passed"],
        raw["astart"].astype(np.int64) * (1 << c_max) + raw["mask"],
        np.int64(-1),
    )

    eq_of_cid: Dict[int, List[int]] = {}
    next_rescue_id = -2
    for i in np.flatnonzero(raw["needs_host"]):
        codes = mat[i, : lens[i]]
        alignment, _ = pseudoalign(codes, engine.index, engine.config, MIN_READ_LENGTH)
        if alignment is not None:
            eq_of_cid[next_rescue_id] = alignment[0]
            cid[i] = next_rescue_id
            next_rescue_id -= 1
        else:
            cid[i] = -1
    return cid, eq_of_cid


class FastCounter:
    """Streaming FASTQ counter: feed chunks, finalize to results.

    Dedupe (score-map key semantics) and combo accumulation are GLOBAL
    across chunks — feeding a file in chunks produces results identical to
    one giant batch, with memory bounded by distinct reads + combos (the
    same asymptotics as the reference's score map).
    """

    def __init__(self, engine, reference: Reference, config: AlignFilterConfig):
        self.engine = engine
        self.reference = reference
        self.config = config
        from nimble_tpu import native

        # native C++ hash set when available; Python set fallback
        self._native_seen = native.make_dedupe_set()
        self._seen: set = set()
        # combo key -> [eq1, eq2, multiplicity]
        self._combos: Dict[Tuple, list] = {}
        # background fetch thread (see dispatch); one worker keeps the
        # transfer order deterministic
        from concurrent.futures import ThreadPoolExecutor

        self._fetcher = ThreadPoolExecutor(max_workers=1)
        # background dispatch thread (see dispatch_async); single worker so
        # chunks dedupe/upload in submission order
        self._dispatcher = ThreadPoolExecutor(max_workers=1)

    _EQ_BIG = np.int64(2**62)

    def _decode_many(self, cids: np.ndarray) -> np.ndarray:
        """Vectorized decode of non-negative combo ids -> sorted deduped
        eq rows, (M, c_max) padded with _EQ_BIG.  Negative ids (no pass /
        rescued) come out all-padding; rescued rows are patched by callers.
        """
        c_max = self.engine.c_max
        if not hasattr(self.engine, "bidx"):
            # engines with interned combo ids (e.g. MeshAlignEngine):
            # distinct cids == distinct eq contents, decode each via the
            # engine (cheap — they are few)
            rows = np.full((len(cids), c_max), self._EQ_BIG, dtype=np.int64)
            for idx, cid in enumerate(cids):
                if cid >= 0:
                    eq = self.engine.decode_combo(
                        int(cid) >> c_max, int(cid) & ((1 << c_max) - 1)
                    )
                    rows[idx, : len(eq)] = eq
            return rows
        # one decode algorithm: the engine's (EQ_ROW_PAD == _EQ_BIG == 2**62)
        return self.engine.decode_rows_padded(np.asarray(cids, dtype=np.int64))

    @staticmethod
    def _flatten_rows(m, ls):
        """(matrix, lens) -> (flat exact-length rows, offsets)."""
        kl = ls.astype(np.int64)
        offs = np.zeros(len(kl) + 1, dtype=np.int64)
        np.cumsum(kl, out=offs[1:])
        if len(kl) and kl.min() == m.shape[1]:
            # uniform full-width reads: rows are already contiguous
            return np.ascontiguousarray(m).reshape(-1), offs
        valid = np.arange(m.shape[1])[None, :] < kl[:, None]
        return m[valid], offs  # row-major -> concatenated exact rows

    def dispatch(self, mat, lens, mate_mat=None, mate_lens=None):
        """Launch this chunk's device work (async); returns a handle for
        :meth:`process`.  The result FETCH also starts immediately on a
        background thread, so the wire transfer of chunk N overlaps the
        host counting of chunk N-1 (hiding the host tail behind transfers
        and kernel execution).

        Duplicate read pairs are dropped BEFORE upload: the reference's
        score map is keyed by the read(+mate) bytes (`src/align.rs:574-579`)
        so a duplicate pair cannot change any count — skipping it saves its
        wire bytes and device work entirely (real 10x runs are heavy with
        PCR duplicates).  The global seen-set admission happens here, so
        counting in :meth:`process` treats every surviving read as new.
        """
        mate_mat, mate_lens = self._clip_mates(mat, mate_mat, mate_lens)
        if hasattr(self.engine, "compact_dispatch"):
            mat, lens, mate_mat, mate_lens, prededuped = dedupe_admit(
                self._native_seen, mat, lens, mate_mat, mate_lens
            )
        else:
            prededuped = False
        st1 = st2 = None
        paired_stacked = False
        if hasattr(self.engine, "compact_dispatch") and mat.shape[0]:
            if mate_mat is not None:
                # ONE device transaction for both mates: R1 rows then R2
                # rows in a single stacked batch: each upload/launch/fetch
                # has a fixed latency, so halving the transaction count
                # halves that cost; results split back by row in process().
                launch_args = stack_pair(mat, lens, mate_mat, mate_lens)
                paired_stacked = True
            else:
                launch_args = (mat, lens)
            st1 = submit_transaction(
                self._fetcher, self.engine.compact_dispatch,
                self.engine.compact_collect, launch_args)
            return (mat, lens, mate_mat, mate_lens, st1, st2, True,
                    prededuped, paired_stacked)
        return (mat, lens, mate_mat, mate_lens, st1, st2, False, prededuped,
                paired_stacked)

    def dispatch_async(self, mat, lens, mate_mat=None, mate_lens=None):
        """Pipeline the whole dispatch stage (dedupe + pack + upload + async
        launch) onto a dedicated thread; returns a future whose result is a
        :meth:`dispatch` handle (:meth:`process` accepts it directly).

        The dispatch stage's dedupe hash-set insert, C++ read pack and
        host->device upload all release the GIL, so running them on their
        own thread overlaps them with the previous chunk's counting — a
        3-stage pipeline (dispatch | device+fetch | count) instead of one
        serialized thread.  Chunk ORDER is preserved by the single worker;
        first-occurrence dedupe across chunks is order-dependent only in
        WHICH duplicate survives, and duplicates share alignment results by
        construction (the key is the read bytes), so counts are identical.

        Do not mix with :meth:`add` (the non-deduped path) concurrently:
        the seen-set is not thread-safe.
        """
        if self._dispatcher is None:
            return self.dispatch(mat, lens, mate_mat, mate_lens)
        return self._dispatcher.submit(
            self.dispatch, mat, lens, mate_mat, mate_lens
        )

    def process(self, handle) -> None:
        """Collect + count one dispatched chunk (accepts a dispatch handle
        or a dispatch_async future of one)."""
        if hasattr(handle, "result"):
            handle = handle.result()
        (mat, lens, mate_mat, mate_lens, st1, st2, async_fetch,
         prededuped, paired_stacked) = handle
        if st1 is None:
            if not prededuped:
                self._add_with_raw(mat, lens, mate_mat, mate_lens, None, None)
            return
        if async_fetch:
            raw1 = st1.result()
            raw2 = st2.result() if st2 is not None else None
        else:
            raw1 = self.engine.compact_collect(st1)
            raw2 = (
                self.engine.compact_collect(st2) if st2 is not None else None
            )
        if paired_stacked:
            raw1, raw2 = split_stacked(raw1, mat.shape[0])
        self._add_with_raw(mat, lens, mate_mat, mate_lens, raw1, raw2,
                           prededuped=prededuped)

    @staticmethod
    def _clip_mates(mat, mate_mat, mate_lens):
        """Extra R2 rows are ignored, like the slow path: `score_sequences`
        zips mates by R1 index and never consumes the surplus
        (`src/align.rs:537-558`)."""
        if mate_mat is not None and mate_mat.shape[0] > mat.shape[0]:
            mate_mat = mate_mat[: mat.shape[0]]
            mate_lens = mate_lens[: mat.shape[0]]
        return mate_mat, mate_lens

    def close(self) -> None:
        """Release the background executors (idempotent).  After close,
        dispatch/process still work — stages run synchronously."""
        if self._dispatcher is not None:
            self._dispatcher.shutdown(wait=True)
            self._dispatcher = None
        if self._fetcher is not None:
            self._fetcher.shutdown(wait=True)
            self._fetcher = None

    def add(self, mat, lens, mate_mat=None, mate_lens=None) -> None:
        mate_mat, mate_lens = self._clip_mates(mat, mate_mat, mate_lens)
        self._add_with_raw(mat, lens, mate_mat, mate_lens, None, None)

    def _add_with_raw(self, mat, lens, mate_mat, mate_lens, raw1, raw2,
                      prededuped: bool = False) -> None:
        n = mat.shape[0]
        if n == 0:
            return
        engine, config = self.engine, self.config

        cid1, rescued1 = _combo_ids(mat, lens, engine, "r1", raw=raw1)
        if mate_mat is not None:
            cid2, rescued2 = _combo_ids(mate_mat, mate_lens, engine, "r2", raw=raw2)
        else:
            cid2 = np.full(n, -1, dtype=np.int64)
            rescued2 = {}

        # distinct (cid1, cid2) combos; decode each ONCE, vectorized.
        # (np.unique(axis=0) sorts structured rows and is ~50x slower than
        # 1-D unique on int64 — compose from per-side uniques instead)
        u1, inv1 = np.unique(cid1, return_inverse=True)
        if mate_mat is None:
            combos = np.stack([u1, np.full(len(u1), -1, dtype=np.int64)], axis=1)
            inverse = inv1
        else:
            u2, inv2 = np.unique(cid2, return_inverse=True)
            code = inv1.astype(np.int64) * len(u2) + inv2
            ucode, inverse = np.unique(code, return_inverse=True)
            combos = np.stack(
                [u1[ucode // len(u2)], u2[ucode % len(u2)]], axis=1
            )
        eq_rows1 = self._decode_many(combos[:, 0])
        eq_rows2 = self._decode_many(combos[:, 1])
        has_rescue = bool(rescued1) or bool(rescued2)
        rescue_eqs: Dict[int, Tuple[List[int], List[int]]] = {}
        if has_rescue:
            resc_rows = np.flatnonzero((combos[:, 0] < -1) | (combos[:, 1] < -1))
            for ci in resc_rows:
                ci = int(ci)
                c1, c2 = combos[ci]
                e1 = rescued1[int(c1)] if c1 < -1 else [
                    int(x) for x in eq_rows1[ci] if x != self._EQ_BIG
                ]
                e2 = rescued2[int(c2)] if c2 < -1 else [
                    int(x) for x in eq_rows2[ci] if x != self._EQ_BIG
                ]
                rescue_eqs[ci] = (e1, e2)

        # score-map admission + pair validity, vectorized over combos
        nonempty1 = eq_rows1[:, 0] != self._EQ_BIG
        nonempty2 = eq_rows2[:, 0] != self._EQ_BIG
        keep_combo = nonempty1 | nonempty2
        if config.require_valid_pair and mate_mat is not None:
            keep_combo &= nonempty1 & nonempty2 & (eq_rows1 == eq_rows2).all(axis=1)
        for ci, (e1, e2) in rescue_eqs.items():
            keep = bool(e1) or bool(e2)
            if keep and config.require_valid_pair and mate_mat is not None:
                keep = bool(e1) and bool(e2) and sorted(e1) == sorted(e2)
            keep_combo[ci] = keep

        # content key of a combo = the padded eq-row bytes (different
        # anchors, same eq class -> one combo entry)
        content_mat = np.concatenate([eq_rows1, eq_rows2], axis=1)

        keep_mask = keep_combo[inverse]
        if not keep_mask.any():
            return

        # dedupe kept read pairs by sequence bytes (GLOBAL across chunks —
        # keys are the exact-length read bytes so chunk padding width is
        # irrelevant)
        kept = np.flatnonzero(keep_mask)
        kept_inverse = inverse[kept]

        if prededuped:
            # dispatch() already did global seen-set admission on the raw
            # bytes; every read in this chunk is new by construction
            counts_per_combo = np.bincount(kept_inverse, minlength=len(combos))
        elif self._native_seen is not None:
            all_kept = len(kept) == n

            # vectorized key extraction + native hash-set insert
            def flatten(m, ls):
                if not all_kept:
                    m, ls = m[kept], ls[kept]
                return self._flatten_rows(m, ls)

            flat1, off1 = flatten(mat, lens)
            if mate_mat is not None:
                flat2, off2 = flatten(mate_mat, mate_lens)
            else:
                flat2, off2 = None, None
            is_new = self._native_seen.insert_batch(flat1, off1, flat2, off2)
            counts_per_combo = np.bincount(
                kept_inverse[is_new], minlength=len(combos)
            )
        else:
            counts_per_combo = np.zeros(len(combos), dtype=np.int64)
            for j in range(len(kept)):
                i = kept[j]
                # the reference's score-map key is the PLAIN concatenation
                # r1_str + r2_str (`src/align.rs:576-579`): different
                # (r1, r2) splits with an equal concatenation are ONE key
                if mate_mat is not None:
                    key = (mat[i, : lens[i]].tobytes()
                           + mate_mat[i, : mate_lens[i]].tobytes())
                else:
                    key = mat[i, : lens[i]].tobytes()
                if key in self._seen:
                    continue
                self._seen.add(key)
                counts_per_combo[kept_inverse[j]] += 1
        self._bump_combos(
            combos, counts_per_combo, eq_rows1, eq_rows2, content_mat,
            rescue_eqs,
        )

    def _bump_combos(self, combos, counts_per_combo, eq_rows1, eq_rows2,
                     content_mat, rescue_eqs) -> None:
        """Accumulate per-combo counts into the global combo dict.

        Device combos are grouped by eq CONTENT first (vectorized — tens of
        thousands of distinct (anchor, mask) ids usually collapse to ~100
        distinct eq classes), so the Python dict work runs once per content
        group instead of once per combo.  Rescued combos keep their tuple
        keys (rare)."""
        nz = np.flatnonzero(counts_per_combo)
        if len(nz) == 0:
            return
        if rescue_eqs:
            resc_keys = np.fromiter(rescue_eqs.keys(), dtype=np.int64,
                                    count=len(rescue_eqs))
            is_resc = np.isin(nz, resc_keys)
            for ci in nz[is_resc]:
                ci = int(ci)
                e1, e2 = rescue_eqs[ci]
                key = (tuple(e1), tuple(e2))
                entry = self._combos.get(key)
                if entry is None:
                    self._combos[key] = [e1, e2, int(counts_per_combo[ci])]
                else:
                    entry[2] += int(counts_per_combo[ci])
            nz = nz[~is_resc]
            if len(nz) == 0:
                return
        gid, reps = _group_rows_exact(content_mat[nz])
        gcounts = np.bincount(
            gid, weights=counts_per_combo[nz]
        ).astype(np.int64)
        big = self._EQ_BIG
        for g in range(len(reps)):
            ci = int(nz[reps[g]])
            key = content_mat[ci].tobytes()
            entry = self._combos.get(key)
            if entry is None:
                e1 = [int(x) for x in eq_rows1[ci] if x != big]
                e2 = [int(x) for x in eq_rows2[ci] if x != big]
                self._combos[key] = [e1, e2, int(gcounts[g])]
            else:
                entry[2] += int(gcounts[g])

    def finalize(self) -> List[Tuple[List[str], Tuple[int, List[str], List[str]]]]:
        """Memoized orientation pipeline per combo -> sorted results."""
        results: Dict[Tuple[str, ...], int] = {}
        for e1, e2, mult in self._combos.values():
            state = (
                PairState.BOTH if (e1 and e2)
                else PairState.FIRST if e1
                else PairState.SECOND
            )
            call = (
                state,
                (e1, 0.0) if e1 else None,
                (e2, 0.0) if e2 else None,
                [],
                [],
            )
            tmp: Dict[Tuple[str, ...], list] = {}
            filter_and_coerce_sequence_call_orientations(
                call, tmp, self.reference, self.config, "", {}
            )
            for callset in tmp:
                results[callset] = results.get(callset, 0) + mult

        ret = [
            (list(callset), (count, [], [])) for callset, count in results.items()
        ]
        self.close()  # streaming is over: release the fetch worker thread
        return sort_score_vector(ret)


def fast_count_calls_matrix(
    mat: np.ndarray,
    lens: np.ndarray,
    mate_mat: Optional[np.ndarray],
    mate_lens: Optional[np.ndarray],
    engine,
    reference: Reference,
    config: AlignFilterConfig,
) -> List[Tuple[List[str], Tuple[int, List[str], List[str]]]]:
    """Counts identical to ``sort_score_vector(get_calls(...)[0])`` with
    empty metadata (the FASTQ path)."""
    counter = FastCounter(engine, reference, config)
    counter.add(mat, lens, mate_mat, mate_lens)
    return counter.finalize()


def fast_count_calls(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    engine,
    reference: Reference,
    config: AlignFilterConfig,
) -> List[Tuple[List[str], Tuple[int, List[str], List[str]]]]:
    """List-of-arrays convenience wrapper over the matrix fast path."""
    if len(reads) == 0:
        return []
    if mate_reads is not None and len(mate_reads) < len(reads):
        raise ValueError(
            "Error -- read and reverse read files do not have matching lengths: "
        )
    mat, lens = pack_matrix(reads)
    if mate_reads is not None:
        mate_mat, mate_lens = pack_matrix(list(mate_reads)[: len(reads)])
    else:
        mate_mat, mate_lens = None, None
    return fast_count_calls_matrix(
        mat, lens, mate_mat, mate_lens, engine, reference, config
    )
