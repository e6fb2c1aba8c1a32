"""Columnar BAM group streaming: the fast-path equivalent of
SortedBamReader + UMIReader (`src/parse/sorted_bam_reader.rs`,
`src/parse/bam.rs`) with records kept as flat arrays end-to-end — no
per-record Python objects, and per-record bytes are materialized only for
records that are actually emitted.

Records are parsed in bulk by the native C++ scanner (`nimble_bam_scan`),
derived fields (the 38-field metadata row, clipped/normalized sequences,
CB/UMI tags) are computed in one C++ pass (`nimble_bam_meta`), the skip
rules apply as vectorized byte-mask filters, and the UMI-run buffering /
CB sort / dummy-pair / qname-pairing / UMI×CB group-by emission runs in
C++ (`nimble_bam_runs`) with a Python fallback for irregular streams
(whose unpaired-qname warnings need the reference's prints).

Byte-parity contract: the stream of emitted batches (record order +
per-record metadata + group boundaries) equals what `UMIReader` over
`SortedBamReader` yields — the pipeline tests assert the final gzipped
TSVs are byte-identical.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from nimble_tpu.io.umi import READ_BLOCK_REPORT_SIZE

UMI_WHITELIST = (b"AAAAAAAAAA",)  # `src/parse/sorted_bam_reader.rs:4`

# bytes-valued columns carried per record: metadata prefix + the metadata
# fields the consumer needs + the grouping keys
_COLS = ("meta", "meta1", "meta15", "rev2", "qn", "sk", "cb", "umi",
         "qname_raw")


@dataclass
class EmittedBatch:
    """Many UMI×CB groups in one flat COLUMNAR batch.

    All bytes-valued per-record data rides (offsets, flat) columns — no
    per-record Python objects; ``group_off`` (int64, n_groups+1) delimits
    groups.  The output metadata block of record i is
    ``meta.get(i) + b"\\t" + skipb.get(i)``; ``skip_true`` is the parsed
    SKIP column (True = the record is an unpaired dummy)."""

    meta: "_Col"         # metadata prefix (36 tab-joined fields)
    skipb: "_Col"        # resolved SKIP column bytes (b"TRUE"/b"FALSE")
    skip_true: np.ndarray
    qual: "_Col"
    rev2: "_Col"
    seq15: "_Col"
    qn: "_Col"
    seq: "_Col"          # 2-bit codes as int8, flat ragged layout
    group_off: np.ndarray

    def __len__(self) -> int:
        return len(self.skip_true)

    @property
    def n_groups(self) -> int:
        return len(self.group_off) - 1

    def drop_last_group(self) -> "EmittedBatch":
        """Batch minus its final group (the reference's dropped-final-UMI
        quirk, `src/process/bam.rs:163-179`)."""
        if self.n_groups == 0:
            return self
        return self.slice_groups(0, self.n_groups - 1)

    def slice_groups(self, g_lo: int, g_hi: int) -> "EmittedBatch":
        """Groups [g_lo, g_hi) as a new batch (multi-host group-range
        sharding; zero-copy column views)."""
        g_lo = max(0, g_lo)
        g_hi = min(self.n_groups, g_hi)
        if g_lo >= g_hi:
            g_lo = g_hi = 0
        start = int(self.group_off[g_lo])
        end = int(self.group_off[g_hi])

        def cut(col: "_Col") -> "_Col":
            return col.head(end).drop_front(start)

        return EmittedBatch(
            cut(self.meta), cut(self.skipb), self.skip_true[start:end],
            cut(self.qual), cut(self.rev2), cut(self.seq15), cut(self.qn),
            cut(self.seq), self.group_off[g_lo : g_hi + 1] - start,
        )


_FALSE5 = np.frombuffer(b"FALSE", dtype=np.uint8)
_TRUE4 = np.frombuffer(b"TRUE", dtype=np.uint8)


def _skip_words(is_true: np.ndarray) -> "_Col":
    """Constant-word SKIP column: b"TRUE" where ``is_true`` else b"FALSE"."""
    k = len(is_true)
    lens = np.where(is_true, 4, 5).astype(np.int64)
    offs = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    mat = np.tile(_FALSE5, (k, 1))
    mat[is_true, :4] = _TRUE4
    flat = mat[np.arange(5)[None, :] < lens[:, None]]
    return _Col(offs, flat)


def read_bam_header(f) -> Tuple[str, List[Tuple[str, int]]]:
    """Parse the BAM header from a decompressed stream; returns (text, refs)."""

    def rd(n):
        d = f.read(n)
        if len(d) != n:
            raise EOFError("truncated BAM stream")
        return d

    if rd(4) != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack("<i", rd(4))[0]
    text = rd(l_text).decode("ascii", "replace")
    n_ref = struct.unpack("<i", rd(4))[0]
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", rd(4))[0]
        name = rd(l_name)[:-1].decode("ascii", "replace")
        refs.append((name, struct.unpack("<i", rd(4))[0]))
    return text, refs


class _Col:
    """A variable-length bytes column as (offsets, flat uint8 array)."""

    __slots__ = ("offs", "flat")

    def __init__(self, offs: np.ndarray, flat: np.ndarray):
        self.offs = offs
        self.flat = flat

    @staticmethod
    def empty() -> "_Col":
        return _Col(np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.uint8))

    def __len__(self):
        return len(self.offs) - 1

    def get(self, i: int) -> bytes:
        return self.flat[self.offs[i] : self.offs[i + 1]].tobytes()

    def slicer(self):
        """Fast per-row getter for hot loops: ONE whole-column bytes copy up
        front, then each row read is a plain Python bytes slice (~5x cheaper
        than ndarray slice + tobytes per row)."""
        flat = self.flat.tobytes()
        offs = self.offs.tolist()

        def get(i: int, _f=flat, _o=offs) -> bytes:
            return _f[_o[i] : _o[i + 1]]

        return get

    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    def filter(self, keep: np.ndarray) -> "_Col":
        """Vectorized row filter (byte-level repeat mask)."""
        from nimble_tpu import native

        res = native.take_rows(self.offs, self.flat, np.flatnonzero(keep))
        if res is not None:
            return _Col(res[0], res[1])
        lens = self.lens()
        byte_keep = np.repeat(keep, lens)
        new_lens = lens[keep]
        offs = np.zeros(len(new_lens) + 1, dtype=np.int64)
        np.cumsum(new_lens, out=offs[1:])
        return _Col(offs, self.flat[: self.offs[-1]][byte_keep])

    def take(self, idx: np.ndarray) -> "_Col":
        """Vectorized row gather (rows in ``idx`` order, repeats allowed)."""
        from nimble_tpu import native

        res = native.take_rows(self.offs, self.flat, idx)
        if res is not None:
            return _Col(res[0], res[1])
        lens = self.lens()[idx]
        offs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        delta = np.repeat(self.offs[idx] - offs[:-1], lens)
        return _Col(offs, self.flat[delta + np.arange(total, dtype=np.int64)])

    def head(self, n: int) -> "_Col":
        """First ``n`` rows (zero-copy views)."""
        return _Col(self.offs[: n + 1], self.flat[: self.offs[n]])

    def concat(self, other: "_Col") -> "_Col":
        offs = np.concatenate([self.offs, other.offs[1:] + self.offs[-1]])
        return _Col(offs, np.concatenate([self.flat, other.flat]))

    @staticmethod
    def concat_many(cols: "List[_Col]") -> "_Col":
        """One-pass concatenation of N columns (vs N-1 pairwise copies)."""
        if len(cols) == 1:
            return cols[0]
        offs_parts = [cols[0].offs]
        base = int(cols[0].offs[-1])
        for c in cols[1:]:
            offs_parts.append(c.offs[1:] + base)
            base += int(c.offs[-1])
        return _Col(
            np.concatenate(offs_parts),
            np.concatenate([c.flat for c in cols]),
        )

    def drop_front(self, n: int) -> "_Col":
        base = self.offs[n]
        return _Col(self.offs[n:] - base, self.flat[base:])


class _Carry:
    """Pending (not yet emitted) surviving records, columnar."""

    def __init__(self):
        self.cols: Dict[str, _Col] = {c: _Col.empty() for c in _COLS}
        self.seq = _Col.empty()          # int8 codes ride the same layout
        self.oflags = np.zeros(0, dtype=np.uint8)

    def __len__(self):
        return len(self.oflags)

    def extend(self, other: "_Carry") -> None:
        for c in _COLS:
            self.cols[c] = self.cols[c].concat(other.cols[c])
        self.seq = self.seq.concat(other.seq)
        self.oflags = np.concatenate([self.oflags, other.oflags])

    def drop_front(self, n: int) -> None:
        for c in _COLS:
            self.cols[c] = self.cols[c].drop_front(n)
        self.seq = self.seq.drop_front(n)
        self.oflags = self.oflags[n:]


class _Pend:
    """Pending EMITTED records awaiting batch flush, columnar.

    Shared by the pure-Python and native-pipe orchestrations of
    :class:`ColumnarGroupStream` so the batching/withholding semantics
    (the CURRENT last group is withheld until more groups follow or clean
    EOF) live in exactly one place."""

    NAMES = ("meta", "skipb", "qual", "rev2", "seq15", "qn", "seq")

    def __init__(self):
        self.cols: Dict[str, _Col] = {c: _Col.empty() for c in self.NAMES}
        self.skip_true = np.zeros(0, dtype=bool)
        self.starts: List[int] = []  # absolute group starts in pending
        # emission pieces accumulate in lists and concatenate ONCE per
        # batch flush (_flush_tails): the old per-emission pairwise
        # concat recopied the whole growing pending buffer on every UMI
        # run — O(batch x runs) bytes of producer-thread memcpy
        self._tails: Dict[str, List[_Col]] = {c: [] for c in self.NAMES}
        self._skip_tails: List[np.ndarray] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add_taken(self, cols: Dict[str, _Col], skip_true: np.ndarray,
                  group_starts) -> None:
        """Append already row-gathered columns + their group starts."""
        base = self._n
        for s in group_starts:
            self.starts.append(base + int(s))
        if len(skip_true):
            for c in self.NAMES:
                self._tails[c].append(cols[c])
            self._skip_tails.append(skip_true)
            self._n += len(skip_true)

    def _flush_tails(self) -> None:
        if self._skip_tails:
            for c in self.NAMES:
                self.cols[c] = _Col.concat_many(
                    [self.cols[c]] + self._tails[c]
                )
                self._tails[c].clear()
            self.skip_true = np.concatenate(
                [self.skip_true] + self._skip_tails
            )
            self._skip_tails.clear()

    def make_batch(self, end: int, cut: int) -> EmittedBatch:
        self._flush_tails()
        c = self.cols
        return EmittedBatch(
            c["meta"].head(end), c["skipb"].head(end), self.skip_true[:end],
            c["qual"].head(end), c["rev2"].head(end), c["seq15"].head(end),
            c["qn"].head(end), c["seq"].head(end),
            np.asarray(self.starts[:cut] + [end], dtype=np.int64),
        )

    def emit_ready(self, final: bool,
                   target_records: int) -> Iterator[EmittedBatch]:
        n_keep = 0 if final else 1
        while len(self.starts) > n_keep and (
            final or self.starts[-1] >= target_records
        ):
            end = self.starts[-1] if not final else self._n
            cut = len(self.starts) - n_keep
            out = self.make_batch(end, cut)
            for c in self.NAMES:
                self.cols[c] = self.cols[c].drop_front(end)
            self.skip_true = self.skip_true[end:]
            self._n = len(self.skip_true)
            rem = [s - end for s in self.starts[cut:]]
            self.starts.clear()
            self.starts.extend(rem)
            yield out
            if final:
                break

    def drop_open_group(self) -> None:
        if self.starts:
            self._flush_tails()
            end = self.starts.pop()
            for c in self.NAMES:
                self.cols[c] = self.cols[c].head(end)
            self.skip_true = self.skip_true[:end]
            self._n = len(self.skip_true)


class ColumnarGroupStream:
    """Yields flat multi-group batches (EmittedBatch), reference semantics.

    Requires the native library; callers fall back to the object-based
    UMIReader pipeline when :func:`nimble_tpu.native.available` is false.
    """

    # 4 MB decompressed chunks: the standalone producer sweep (round 4)
    # measured 661k rec/s at 4 MB vs 585k at 8 MB vs 464k at 32 MB — the
    # scan/meta working set stays cache-resident at 4-6 MB
    _CHUNK = 4 << 20

    def __init__(self, path: str, force_bam_paired: bool):
        from nimble_tpu import native
        from nimble_tpu.io.bam import _warn_missing_eof, open_bgzf

        if not native.available():
            raise RuntimeError("columnar BAM stream requires the native library")
        self._native = native
        _warn_missing_eof(path)
        # Native producer pipe (read+inflate+scan+meta+filter+run-emission on
        # a dedicated C++ thread, GIL-free) when the file is a well-formed
        # BGZF BAM; any open failure falls back to this class's pure-Python
        # orchestration, which re-raises the reference-parity errors.
        #
        # OPT-IN (NIMBLE_BAM_PIPE=1): on a 4-core host the pipe lost to
        # the pure orchestration, because the worker + its 4-thread
        # inflate pool + the device consumers oversubscribe the cores and
        # each slot handoff adds a copy, while the pure path's native
        # calls already release the GIL.  On hosts with more cores the
        # balance may flip; the parity surface is pinned by
        # tests/test_bam_pipe.py either way.
        self._pipe = None
        self._f = None
        if os.environ.get("NIMBLE_BAM_PIPE"):
            try:
                self._pipe = native.BamPipe(path, force_bam_paired)
            except Exception:
                self._pipe = None
        if self._pipe is None:
            self._f = open_bgzf(path)
            try:
                read_bam_header(self._f)
            except Exception:
                self._f.close()
                raise
        self.force_bam_paired = force_bam_paired
        self.read_counter = 0
        self._tail = b""
        self._eof = False
        self._error: Optional[Exception] = None
        # scan/meta output-buffer pool: every retained column is copied
        # (take_rows/filter) before the next chunk, so reuse is safe and
        # saves the fresh-page faults that dominated the warm producer
        self._pool: dict = {}
        # producer free-pass state (`src/process/bam.rs:163-179`): an
        # empty post-filter run before ANY delivered group sends the
        # (possibly empty) current group and reading continues; any later
        # empty run ends the stream
        self._free_pass_used = False
        self._groups_started_total = 0
        # entries emitted since the last free pass (0 right after a pass:
        # the then-open group counts as DELIVERED); >0 means an
        # UNDELIVERED open group exists
        self._entries_since_pass = 0
        # set at stream end: True when the final emitted group is an
        # undelivered OPEN group that the reference producer never sends
        # (the dropped-final-group quirk applies to exactly this case)
        self.final_open_group_pending = False

    # -------------------------- chunk ingestion ------------------------

    def _scan_chunk(self) -> Optional[_Carry]:
        """Read+scan one chunk, apply skip rules; None at (logical) EOF."""
        if self._error is not None:
            return None  # no reads past a fatal record
        res = self._scan_raw(self._pool)
        if res is None:
            return None
        return self._meta_filter(res, self._pool)

    def _scan_raw(self, pool):
        """Producer stage 1: file read + BGZF inflate + record scan.

        Owns the sequential stream state (file position, BGZF tail carry,
        EOF flag); returns bam_scan's raw column tuple, or None at EOF.
        The output arrays live in ``pool`` buffers — the caller must not
        run another _scan_raw against the same pool until stage 2
        (:meth:`_meta_filter`) has consumed them.
        """
        while True:
            if self._eof and not self._tail:
                return None
            if not self._eof:
                chunk = self._f.read(self._CHUNK)
                if len(chunk) < self._CHUNK:
                    self._eof = True
                data = self._tail + chunk
            else:
                data = self._tail
            if not data:
                return None
            res = self._native.bam_scan(data, len(data) // 36 + 1,
                                        pool=pool)
            (count, consumed, fixed, qname, seq, qual, aux, _cig) = res
            self._tail = data[consumed:]
            if count == 0:
                if self._eof:
                    if self._tail:
                        raise EOFError("truncated BAM stream")
                    return None
                continue
            return (count, fixed, qname, seq, qual, aux)

    def _meta_filter(self, scanres, pool) -> Optional[_Carry]:
        """Producer stage 2: metadata derivation + skip rules -> _Carry.

        Independent per chunk (no stream state except ``self._error``,
        which only ever transitions None -> fatal); every retained column
        is a fresh filter() copy, so the pool buffers are reusable as soon
        as this returns.
        """
        count, fixed, qname, seq, qual, aux = scanres
        cols = self._native.bam_meta(count, fixed, qname, seq, qual,
                                     aux, pool=pool)
        oflags = cols["oflags"]
        paired = (oflags & 1) != 0
        has_cb = (oflags & 4) != 0
        has_umi = (oflags & 8) != 0

        # skip rules, reference order (`sorted_bam_reader.rs:45-68`)
        keep = np.ones(count, dtype=bool)
        if self.force_bam_paired:
            keep &= paired
        keep &= has_cb
        bad_umi = keep & ~has_umi
        if bad_umi.any():
            # the reference raises when the reader reaches this record
            first_bad = int(np.flatnonzero(bad_umi)[0])
            keep &= np.arange(count) < first_bad
            self._error = ValueError("Error -- Could not read UMI.")

        # whitelisted-UMI filter (vectorized 10-byte compare)
        umi_off, umi_flat = cols["umi"]
        umi_lens = np.diff(umi_off[: count + 1])
        cand = keep & (umi_lens == 10)
        if cand.any():
            idx = np.flatnonzero(cand)
            win = umi_flat[
                umi_off[idx][:, None] + np.arange(10, dtype=np.int64)[None, :]
            ]
            keep[idx[(win == ord("A")).all(axis=1)]] = False

        out = _Carry()
        for name in _COLS:
            if name == "qname_raw":
                offs, flat = qname
                offs = offs[: count + 1]
            else:
                offs, flat = cols[name]
                offs = offs[: count + 1]
            col = _Col(np.ascontiguousarray(offs, dtype=np.int64),
                       flat[: offs[-1]])
            out.cols[name] = col.filter(keep)
        s_offs, s_flat = cols["seq2"]
        out.seq = _Col(
            np.ascontiguousarray(s_offs[: count + 1], dtype=np.int64),
            s_flat[: s_offs[count]].view(np.uint8),
        ).filter(keep)
        out.oflags = oflags[keep]
        return out

    # ----------------- Python fallback (irregular runs) ----------------

    def _run_entries_python(self, c: _Carry, lo: int, hi: int,
                            is_final: bool) -> List[Tuple[int, bytes]]:
        """CB-sort + dummy-pair + qname-pair one UMI run; reference
        semantics incl. the unpaired-qname warnings
        (`src/parse/sorted_bam_reader.rs:85-162`)."""
        cb = c.cols["cb"]
        qn = c.cols["qname_raw"]
        order = list(range(lo, hi))
        if not is_final:
            order.sort(key=lambda i: cb.get(i))

        if not self.force_bam_paired:
            buf: List[Tuple[int, bytes]] = []
            for i in order:
                buf.append((i, b"FALSE"))
                if not (c.oflags[i] & 1):
                    buf.append((i, b"TRUE"))
        else:
            sk = c.cols["sk"]
            buf = [(i, sk.get(i)) for i in order]

        entries: List[Tuple[int, bytes]] = []
        n = len(buf)
        j = 0
        seen_qnames: Optional[set] = None
        while j < n:
            if j + 1 >= n:
                break
            i1, s1 = buf[j]
            i2, s2 = buf[j + 1]
            q1 = qn.get(i1)
            if q1 == qn.get(i2):
                if c.oflags[i1] & 16:
                    entries.append((i1, s1))
                    entries.append((i2, s2))
                else:
                    entries.append((i2, s2))
                    entries.append((i1, s1))
                if seen_qnames is not None:
                    seen_qnames.add(q1)
                j += 2
            else:
                print("Warning: Unpaired qname!")
                if seen_qnames is None:
                    seen_qnames = set(qn.get(i) for i, _ in entries)
                if q1 in seen_qnames:
                    print(
                        f"Warning: Read with qname "
                        f"'{q1.decode('latin-1')}' has been deleted "
                        "but was seen before."
                    )
                seen_qnames.add(q1)
                j += 1
        return entries

    def _fallback_runs(self, carry: _Carry, at_eof: bool):
        """Run-split + emit one carry the slow way (irregular streams whose
        unpaired-qname warnings need the reference's exact prints).

        Returns ``(e_idx, e_skip, g_starts, keep_from, truncated)`` and
        updates ``self._free_pass_used`` / ``self._entries_since_pass``.
        """
        n = len(carry)
        umi = carry.cols["umi"]
        umis = [umi.get(i) for i in range(n)]
        boundaries = [0]
        for i in range(1, n):
            if umis[i] != umis[i - 1]:
                boundaries.append(i)
        boundaries.append(n)
        runs = [
            (a, b)
            for a, b in zip(boundaries[:-1], boundaries[1:]) if a < b
        ]
        process_final = at_eof and self._error is None
        if not process_final and runs:
            keep_from = runs[-1][0]
            runs = runs[:-1]
        else:
            keep_from = n
        cbc = carry.cols["cb"]
        e_idx: List[int] = []
        e_skip: List[int] = []
        g_starts: List[int] = []
        last_key = None
        truncated = False
        pass_at = None
        for lo, hi in runs:
            is_final_run = process_final and hi == n
            entries = self._run_entries_python(carry, lo, hi, is_final_run)
            if not entries:
                # empty post-filter run: BamTruncatedRecord in the
                # reference — ends the stream iff a group was already
                # delivered, else consumes the producer's one free pass
                # (`src/process/bam.rs:163-179`)
                aligned = (
                    self._free_pass_used
                    or self._groups_started_total + len(g_starts) >= 2
                )
                if not aligned:
                    self._free_pass_used = True
                    pass_at = len(e_idx)
                    last_key = None  # key state resets
                    continue
                truncated = True
                break
            for i, skip_val in entries:
                cbv = cbc.get(i)
                key = umis[i] + cbv[: max(len(cbv) - 2, 0)]
                if key != last_key:
                    g_starts.append(len(e_idx))
                    last_key = key
                e_idx.append(i)
                e_skip.append(
                    2 if self.force_bam_paired
                    else (1 if skip_val == b"TRUE" else 0)
                )
        if pass_at is not None:
            self._entries_since_pass = len(e_idx) - pass_at
        else:
            self._entries_since_pass += len(e_idx)
        return e_idx, e_skip, g_starts, keep_from, truncated

    # ------------------- batch iteration (fast pipeline) ----------------

    def _count_progress(self, k: int) -> None:
        """Progress print parity (`src/parse/bam.rs:121-127`)."""
        before = self.read_counter
        self.read_counter += k
        blk = READ_BLOCK_REPORT_SIZE
        for mark in range((before // blk) + 1,
                          (self.read_counter // blk) + 1):
            print(f"Aligned reads {(mark - 1) * blk}-{mark * blk}")

    def _add_emitted(self, pend: _Pend, c: _Carry, emit_idx, emit_skip,
                     group_starts) -> None:
        """Row-gather ``emit_idx`` from the carry into the pend buffer."""
        self._groups_started_total += len(group_starts)
        idx = np.asarray(emit_idx, dtype=np.int64)
        k = len(idx)
        taken: Dict[str, _Col] = {}
        skip_true = np.zeros(0, dtype=bool)
        if k:
            codes = np.asarray(emit_skip, dtype=np.int8)
            if (codes == 2).all():
                # force_bam_paired path: the sk column holds the BAM's
                # own SK:Z: aux value verbatim — the skip test is exact
                # string equality with "TRUE" (`src/align.rs:527-531`,
                # slow path: m[37] == "TRUE"), not a length heuristic
                skipb = c.cols["sk"].take(idx)
                sl = skipb.lens()
                skip_true = np.zeros(k, dtype=bool)
                four = np.flatnonzero(sl == 4)
                if len(four):
                    o = skipb.offs[:-1][four]
                    eq = np.ones(len(four), dtype=bool)
                    for j, ch in enumerate(b"TRUE"):
                        eq &= skipb.flat[o + j] == ch
                    skip_true[four] = eq
            else:
                skip_true = codes == 1
                skipb = _skip_words(skip_true)
            for name, src in (
                ("meta", "meta"), ("qual", "meta1"), ("rev2", "rev2"),
                ("seq15", "meta15"), ("qn", "qn"),
            ):
                taken[name] = c.cols[src].take(idx)
            taken["skipb"] = skipb
            taken["seq"] = c.seq.take(idx)
        pend.add_taken(taken, skip_true, group_starts)
        self._count_progress(k)

    def _end_stream(self, pend: _Pend, target_records: int,
                    drop_open_on_error: bool = False):
        """Compute the final-group verdict, flush, close (the shared
        stream-termination epilogue for EOF / truncation / error)."""
        open_exists = self._entries_since_pass > 0
        delivered = self._groups_started_total - (1 if open_exists else 0)
        # has_aligned at the final truncation: a group was delivered
        # before (free pass counts) -> the open group is never sent
        self.final_open_group_pending = open_exists and (
            self._free_pass_used or delivered >= 1
        )
        if drop_open_on_error and open_exists:
            # fatal error: delivered groups are logged, the partial
            # open group was never returned by the reader
            pend.drop_open_group()
        yield from pend.emit_ready(final=True, target_records=target_records)
        self.close()

    def _stop_prefetch(self) -> None:
        """Terminate the scan-ahead thread(s) and wait (idempotent).

        Must run BEFORE the file handle closes: the scanner may be inside
        self._f.read(), and a concurrent close() would race it (ADVICE
        r4).  Draining the bounded queues (and feeding the pool-ring
        queue a wakeup sentinel) wakes any blocked get()/put() so every
        worker can observe the stop flag and exit.
        """
        threads = getattr(self, "_prefetch_threads", None)
        if not threads:
            return
        import queue as _queue

        self._prefetch_stop.set()
        free = getattr(self, "_prefetch_free", None)
        queues = [self._prefetch_q]
        q1 = getattr(self, "_prefetch_q1", None)
        if q1 is not None:
            queues.append(q1)
        while any(t.is_alive() for t in threads):
            if free is not None:
                free.put_nowait(None)  # wake a scanner blocked on get
            if q1 is not None:
                try:
                    # wake a metaer blocked on q1.get (the scanner may
                    # have exited on the stop flag without a terminal put)
                    q1.put_nowait(("end", None))
                except _queue.Full:
                    pass
            drained = False
            for q in queues:
                try:
                    q.get_nowait()
                    drained = True
                except _queue.Empty:
                    pass
            if not drained:
                for t in threads:
                    t.join(0.02)
        self._prefetch_threads = None
        self._prefetch_free = None
        self._prefetch_q1 = None

    def close(self) -> None:
        self._stop_prefetch()
        if self._pipe is not None:
            self._pipe.close()
        elif self._f is not None:
            self._f.close()

    def batches(self, target_records: int = 16384) -> Iterator[EmittedBatch]:
        """Yield flat multi-group COLUMNAR batches in stream order.

        The stream's CURRENT last group is withheld until more groups
        follow or clean EOF — exactly when the object-based reader would
        surface it (and never, like the reference, when a fatal record
        error interrupts the stream first).
        """
        if self._pipe is not None:
            yield from self._batches_pipe(target_records)
            return
        carry = _Carry()
        pend = _Pend()

        # Prefetch thread(s): the scan side (read + parallel BGZF inflate +
        # C++ scan/meta + filters) runs ahead of the run/group emission
        # below.  Exceptions re-raise at the same consume point as the
        # inline call.  NIMBLE_BAM_PREFETCH:
        #   0 — inline (no thread): the round-3 behavior
        #   1 — ONE scan-ahead thread running the whole scan half
        #       (the DEFAULT; same-process ABBA measured it winning ~10%
        #       once consumer prepare moved to C++)
        #   2 — TWO pipeline stages (round-5 experiment, opt-in): stage 1
        #       owns the file and the sequential read+inflate+bam_scan
        #       state; stage 2 runs bam_meta + skip filters, with a ring
        #       of 3 scan pools handed between them.  Producer-ONLY it
        #       ties mode 1 (~540k rec/s median both, idle host), and
        #       END-TO-END it LOSES (ABBA 8 rounds: median 186k vs 203k,
        #       best 195k vs 261k rec/s) — the extra thread's GIL slices
        #       and core share cost more than the deeper pipeline earns
        #       on the 4-core host (the BamPipe lesson again).  Kept for
        #       wider hosts, where the producer's long leg halves.
        # Parity is unchanged in all modes (same sequential calls).
        fetch = self._scan_chunk
        mode = os.environ.get("NIMBLE_BAM_PREFETCH", "1")
        if mode == "1":
            import queue as _queue
            import threading as _threading

            q: "_queue.Queue" = _queue.Queue(maxsize=2)
            stop = _threading.Event()

            def _prefetcher() -> None:
                while not stop.is_set():
                    try:
                        item = self._scan_chunk()
                    except BaseException as e:  # noqa: BLE001 — replayed
                        q.put(("exc", e))
                        return
                    q.put(("ok", item))
                    if item is None:
                        return

            self._prefetch_q = q
            self._prefetch_q1 = None
            self._prefetch_free = None
            self._prefetch_stop = stop
            self._prefetch_threads = [_threading.Thread(
                target=_prefetcher, daemon=True)]
            self._prefetch_threads[0].start()

            def fetch():
                kind, val = q.get()
                if kind == "exc":
                    raise val
                return val
        elif mode == "2":
            import queue as _queue
            import threading as _threading

            q1: "_queue.Queue" = _queue.Queue(maxsize=1)
            q2: "_queue.Queue" = _queue.Queue(maxsize=2)
            free: "_queue.Queue" = _queue.Queue()
            pools = [{}, {}, {}]
            for i in range(len(pools)):
                free.put(i)
            stop = _threading.Event()

            def _scanner() -> None:
                while not stop.is_set():
                    pidx = free.get()
                    if pidx is None or stop.is_set():
                        return
                    try:
                        r = self._scan_raw(pools[pidx])
                    except BaseException as e:  # noqa: BLE001 — replayed
                        q1.put(("exc", e))
                        return
                    if r is None:
                        q1.put(("end", None))
                        return
                    q1.put(("ok", (r, pidx)))

            def _metaer() -> None:
                meta_pool: dict = {}
                while not stop.is_set():
                    kind, val = q1.get()
                    if kind != "ok":
                        q2.put((kind, val) if kind == "exc"
                               else ("ok", None))
                        return
                    r, pidx = val
                    if self._error is not None:
                        # a fatal record already surfaced: chunks the
                        # scanner read ahead are never processed (the
                        # reference stops reading at the error)
                        free.put(pidx)
                        q2.put(("ok", None))
                        return
                    try:
                        c = self._meta_filter(r, meta_pool)
                    except BaseException as e:  # noqa: BLE001 — replayed
                        q2.put(("exc", e))
                        return
                    free.put(pidx)
                    q2.put(("ok", c))

            self._prefetch_q = q2
            self._prefetch_q1 = q1
            self._prefetch_stop = stop
            self._prefetch_free = free
            t1 = _threading.Thread(target=_scanner, daemon=True)
            t2 = _threading.Thread(target=_metaer, daemon=True)
            self._prefetch_threads = [t1, t2]
            t1.start()
            t2.start()

            def fetch():
                kind, val = q2.get()
                if kind == "exc":
                    raise val
                return val

        # the try/finally guards ABANDONMENT (consumer exception or an
        # early generator close): without it the prefetcher would keep
        # scanning, block forever on the bounded queue, and hold the BAM
        # file handle open for the process lifetime (ADVICE r4).  Normal
        # termination paths reach _end_stream -> close(), which also stops
        # the prefetcher before the handle closes.
        try:
            yield from self._batches_loop(fetch, carry, pend, target_records)
        finally:
            self._stop_prefetch()

    def _batches_loop(self, fetch, carry, pend,
                      target_records: int) -> Iterator[EmittedBatch]:
        import time as _time

        _timing = os.environ.get("NIMBLE_TIMING")
        t_fetch = t_emit = 0.0
        _t_last = _time.time()
        while True:
            ts = _time.time()
            t_emit += ts - _t_last
            batch = fetch()
            _t_last = _time.time()
            t_fetch += _t_last - ts
            if _timing and batch is None:
                import sys as _sys

                print(f"[bam_fast scanwait] fetch {t_fetch:.2f}s "
                      f"emit {t_emit:.2f}s", file=_sys.stderr)
            at_eof = batch is None
            if batch is not None:
                carry.extend(batch)
            n = len(carry)
            if n == 0 and at_eof:
                if self._error is not None:
                    yield from self._end_stream(
                        pend, target_records, drop_open_on_error=True)
                    raise self._error
                yield from self._end_stream(pend, target_records)
                return

            res = None
            if n:
                umi = carry.cols["umi"]
                cb = carry.cols["cb"]
                qname = carry.cols["qname_raw"]
                res = self._native.bam_runs(
                    (umi.offs, umi.flat), (cb.offs, cb.flat),
                    (qname.offs, qname.flat), carry.oflags, n,
                    self.force_bam_paired,
                    at_eof and self._error is None,
                    free_pass_used=self._free_pass_used,
                    groups_started_before=self._groups_started_total,
                )
            if res is not None:
                (emit_idx, emit_skip, group_off, consumed, truncated,
                 free_used, entries_after_pass) = res
                if free_used:
                    self._free_pass_used = True
                    self._entries_since_pass = int(entries_after_pass)
                else:
                    self._entries_since_pass += len(emit_idx)
                self._add_emitted(pend, carry, emit_idx, emit_skip,
                                  group_off[:-1])
                carry.drop_front(consumed)
                if truncated:
                    # a run paired down to nothing after has_aligned: the
                    # reference stream ends here (BamTruncatedRecord ->
                    # UMIReader None); everything past it is never read
                    yield from self._end_stream(pend, target_records)
                    return
            elif n:
                # Python fallback (irregular stream: reference warnings)
                e_idx, e_skip, g_starts, keep_from, truncated = (
                    self._fallback_runs(carry, at_eof)
                )
                self._add_emitted(pend, carry, e_idx,
                                  np.asarray(e_skip, dtype=np.int8), g_starts)
                if truncated:
                    yield from self._end_stream(pend, target_records)
                    return
                carry.drop_front(keep_from)

            if at_eof:
                if self._error is not None:
                    yield from self._end_stream(
                        pend, target_records, drop_open_on_error=True)
                    raise self._error
                yield from self._end_stream(pend, target_records)
                return
            yield from pend.emit_ready(final=False,
                                       target_records=target_records)

    # ------------------ batch iteration (native pipe) -------------------

    def _sync_state(self, state) -> None:
        """Adopt the worker's run-state snapshot (the C++ side owns the
        free-pass/group counters between irregular handoffs)."""
        self._free_pass_used, self._groups_started_total, \
            self._entries_since_pass = state

    def _batches_pipe(self,
                      target_records: int) -> Iterator[EmittedBatch]:
        """Consume the native producer pipe: C++ hands fully row-gathered
        emission batches; irregular carries run through the Python fallback
        (for its reference-parity warnings) and ack back to the worker."""
        pend = _Pend()
        while True:
            res = self._pipe.next()
            kind = res[0]
            if kind == "emit":
                _, cols, skip_true, gstarts, truncated, at_eof, state = res
                self._sync_state(state)
                taken = {
                    name: _Col(offs, flat)
                    for name, (offs, flat) in cols.items()
                }
                pend.add_taken(taken, np.asarray(skip_true, dtype=bool),
                               gstarts)
                self._count_progress(len(skip_true))
                if truncated:
                    yield from self._end_stream(pend, target_records)
                    return
                if not at_eof:
                    # at_eof slots flush via the terminal slot's end_stream
                    # (pure-path parity: the final add goes straight to the
                    # stream epilogue, not through a mid-stream flush)
                    yield from pend.emit_ready(
                        final=False, target_records=target_records)
            elif kind == "carry":
                _, ccols, oflags, at_eof, missing_umi, state = res
                self._sync_state(state)
                if missing_umi and self._error is None:
                    self._error = ValueError("Error -- Could not read UMI.")
                carry = _Carry()
                for name in _COLS:
                    offs, flat = ccols[name]
                    carry.cols[name] = _Col(offs, flat)
                s_offs, s_flat = ccols["seq"]
                carry.seq = _Col(s_offs, s_flat)
                carry.oflags = np.asarray(oflags, dtype=np.uint8)
                e_idx, e_skip, g_starts, keep_from, truncated = (
                    self._fallback_runs(carry, at_eof)
                )
                self._add_emitted(pend, carry, e_idx,
                                  np.asarray(e_skip, dtype=np.int8), g_starts)
                self._pipe.ack(keep_from, truncated, self._free_pass_used,
                               self._groups_started_total,
                               self._entries_since_pass)
                if truncated:
                    yield from self._end_stream(pend, target_records)
                    return
                yield from pend.emit_ready(
                    final=False, target_records=target_records)
                # at_eof carries resolve via the terminal slot the worker
                # pushes right after the ack
            else:  # terminal
                _, error_kind, gz_status, state = res
                self._sync_state(state)
                if error_kind == 1:
                    # stream ended mid-record: pure-path parity raises out
                    # of _scan_chunk without flushing pending batches
                    self.close()
                    raise EOFError("truncated BAM stream")
                if error_kind == 3:
                    self.close()
                    raise gzip.BadGzipFile(
                        "corrupt BGZF stream (native inflate code "
                        f"{gz_status})")
                if error_kind == 4:
                    self.close()
                    raise EOFError(
                        "Compressed file ended before the "
                        "end-of-stream marker was reached")
                if error_kind == 2:
                    if self._error is None:
                        self._error = ValueError(
                            "Error -- Could not read UMI.")
                    yield from self._end_stream(
                        pend, target_records, drop_open_on_error=True)
                    raise self._error
                yield from self._end_stream(pend, target_records)
                return
