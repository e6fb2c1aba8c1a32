"""k-mer index over the (doubled) reference library.

The reference delegates index construction to the external `debruijn_mapping`
crate (`build_index::build_index::<Kmer30>`, `src/bin/main.rs:121-128`), which
builds a colored de Bruijn graph keyed by 30-mers.  For the device engine we use
an equivalent flat formulation designed for batched device probing:

  * every k-mer (k=30) of every library row is packed into a 60-bit integer
    key (base-major, A=0 C=1 G=2 T=3 — the same 2-bit alphabet as the
    reference's `DnaString`), with NO canonicalization: the library loader has
    already doubled the rows with explicit reverse complements
    (`src/reference_library.rs:128-153`), so orientation is encoded in which
    row a k-mer belongs to;
  * each distinct key maps to its postings: the list of (row_id, offset)
    occurrences.  The "color"/equivalence-class of a k-mer is exactly the set
    of rows in its postings;
  * for the device, the same data is laid out as an open-addressed hash table
    (key -> postings span) plus a flat postings array and the concatenated
    2-bit row codes (see `nimble_tpu.ops.device_index`).

Host-side structures here are the ground truth; the device arrays are derived
views of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from nimble_tpu.config import KMER_SIZE
from nimble_tpu.utils.dna import encode_bases


def pack_kmer_keys(codes: np.ndarray, k: int = KMER_SIZE) -> np.ndarray:
    """All rolling k-mer keys of a code array, as uint64 (base-major).

    key(i) = sum_{j<k} codes[i+j] << (2*(k-1-j)) — i.e. the first base is the
    most-significant 2 bits, so keys compare lexicographically.
    Returns an empty array when len(codes) < k.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    # incremental rolling hash: key_{i+1} = ((key_i << 2) & mask) | c_{i+k}
    mask = np.uint64((1 << (2 * k)) - 1)
    # vectorized: prefix "polynomial" evaluation via cumulative shifts is
    # awkward; use the windowed dot with powers instead (k is only 30).
    powers = (np.uint64(1) << (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)))
    # sliding windows (n, k) — fine for host-side library/rescue volumes
    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    return (windows * powers).sum(axis=1, dtype=np.uint64) & mask


@dataclass
class KmerIndex:
    """Host k-mer index: packed rows + columnar (CSR) postings.

    Attributes:
      k:             k-mer size (30)
      row_codes:     per-row int8 base codes of the doubled library
      row_lengths:   np.ndarray of row lengths
      keys_sorted:   (n_distinct,) uint64 distinct keys, ascending
      post_starts:   (n_distinct+1,) int64 CSR spans into the postings arrays
      postings_rows: (num_kmers,) int32 — key-grouped (row, offset) postings,
      postings_offs: (num_kmers,) int32    row-major then offset-ascending
                     within each key (matching the extraction order)

    The columnar layout is what the device-table builders consume (zero-copy
    spans); `kmer_map`/`lookup` provide the dict-shaped view the pinned host
    oracle (`core/walk.py`) reads, materialized per key on demand.
    """

    k: int
    row_codes: List[np.ndarray]
    row_lengths: np.ndarray
    keys_sorted: np.ndarray
    post_starts: np.ndarray
    postings_rows: np.ndarray
    postings_offs: np.ndarray
    num_kmers: int = 0
    # rows flagged in the tandem-repeat divergence class (docs/SEMANTICS.md);
    # populated by build_index via detect_tandem_repeat_rows
    repeat_rows: np.ndarray = None

    def lookup(self, key: int) -> np.ndarray | None:
        i = int(np.searchsorted(self.keys_sorted, np.uint64(key)))
        if i >= len(self.keys_sorted) or int(self.keys_sorted[i]) != int(key):
            return None
        s, e = int(self.post_starts[i]), int(self.post_starts[i + 1])
        return np.stack(
            [self.postings_rows[s:e], self.postings_offs[s:e]], axis=1
        )

    @property
    def kmer_map(self) -> "_KmerMapView":
        return _KmerMapView(self)


class _KmerMapView:
    """Read-only dict-shaped view over the columnar postings (lazy)."""

    def __init__(self, index: KmerIndex):
        self._index = index

    def get(self, key: int, default=None):
        got = self._index.lookup(key)
        return default if got is None else got

    def __getitem__(self, key: int) -> np.ndarray:
        got = self._index.lookup(key)
        if got is None:
            raise KeyError(key)
        return got

    def __contains__(self, key: int) -> bool:
        return self._index.lookup(key) is not None

    def __len__(self) -> int:
        return len(self._index.keys_sorted)

    def __iter__(self):
        return iter(self._index.keys_sorted)

    def keys(self) -> np.ndarray:
        return self._index.keys_sorted


def _row_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling keys for one row; native C++ extractor when available."""
    from nimble_tpu import native

    keys = native.extract_kmer_keys(codes, k)
    if keys is None:
        keys = pack_kmer_keys(codes, k)
    return keys


def detect_tandem_repeat_rows(
    postings_rows: np.ndarray,
    postings_offs: np.ndarray,
    post_starts: np.ndarray,
    k: int,
) -> np.ndarray:
    """Rows in the documented walk-semantics divergence class.

    docs/SEMANTICS.md isolates the ONE input structure where the shipped
    positional walk can differ from a kallisto-style color intersection
    (the unfetchable `debruijn_mapping` crate's family): a row holding a
    tandem repeat with period p <= k and run length >= k + p, which
    contains every k-mer of an arbitrarily long in-phase read without
    spanning it.  That condition is EXACTLY "some k-mer occurs twice in
    the row at offset distance <= k": codes[i..i+k) == codes[i+p..i+p+k)
    iff codes[j] == codes[j+p] for all j in [i, i+k), i.e. a period-p
    match run of length k, i.e. a repeat run spanning k + p bases.

    The sorted postings already group each key's (row, offset) occurrences
    row-major / offset-ascending, so the minimal same-row distance for any
    key is realized by CONSECUTIVE postings — one vectorized pass over the
    postings arrays finds every flagged row (O(num_kmers), no rescan of
    the sequences).

    Returns the sorted unique row ids in the divergence class.
    """
    total = len(postings_rows)
    if total < 2:
        return np.empty(0, dtype=np.int32)
    same_key = np.ones(total - 1, dtype=bool)
    # posting-span boundaries: positions where a new key starts.  Every
    # key in keys_sorted has >= 1 posting today, so interior starts are
    # always > 0; mask anyway so a future zero-posting key cannot wrap
    # `starts - 1` to -1 and silently clear the LAST boundary instead
    # (ADVICE r4).
    starts = np.asarray(post_starts[1:-1], dtype=np.int64)
    starts = starts[starts > 0]
    same_key[starts - 1] = False
    same_row = postings_rows[1:] == postings_rows[:-1]
    near = (postings_offs[1:] - postings_offs[:-1]) <= k
    hits = same_key & same_row & near
    return np.unique(postings_rows[:-1][hits])


def build_index(
    sequences: List[str], k: int = KMER_SIZE, num_threads: int = 1
) -> KmerIndex:
    """Build the k-mer postings index from (doubled) library row sequences.

    Mirrors the role of `debruijn_mapping::build_index` (`src/bin/main.rs:121`),
    including its ``num_threads`` build parallelism: rows are key-extracted
    concurrently (NumPy/native code releases the GIL).
    """
    row_codes = [encode_bases(s) for s in sequences]
    row_lengths = np.array([len(c) for c in row_codes], dtype=np.int32)

    if num_threads > 1 and len(row_codes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            all_keys = list(pool.map(lambda c: _row_keys(c, k), row_codes))
    else:
        all_keys = [_row_keys(c, k) for c in row_codes]

    keys_per_row = []
    rows_per_row = []
    offs_per_row = []
    for row_id, keys in enumerate(all_keys):
        if len(keys) == 0:
            continue
        keys_per_row.append(keys)
        rows_per_row.append(np.full(len(keys), row_id, dtype=np.int32))
        offs_per_row.append(np.arange(len(keys), dtype=np.int32))

    if keys_per_row:
        all_keys = np.concatenate(keys_per_row)
        all_rows = np.concatenate(rows_per_row)
        all_offs = np.concatenate(offs_per_row)
        total = len(all_keys)
        # stable sort groups identical keys while keeping each key's postings
        # in extraction order (row-major, offset-ascending)
        order = np.argsort(all_keys, kind="stable")
        sk = all_keys[order]
        postings_rows = np.ascontiguousarray(all_rows[order], dtype=np.int32)
        postings_offs = np.ascontiguousarray(all_offs[order], dtype=np.int32)
        boundaries = np.flatnonzero(np.diff(sk)) + 1
        keys_sorted = sk[np.concatenate(([0], boundaries))]
        post_starts = np.concatenate(
            ([0], boundaries, [total])
        ).astype(np.int64)
    else:
        total = 0
        keys_sorted = np.empty(0, dtype=np.uint64)
        post_starts = np.zeros(1, dtype=np.int64)
        postings_rows = np.empty(0, dtype=np.int32)
        postings_offs = np.empty(0, dtype=np.int32)

    repeat_rows = detect_tandem_repeat_rows(
        postings_rows, postings_offs, post_starts, k
    )
    if len(repeat_rows):
        import warnings

        warnings.warn(
            f"{len(repeat_rows)} library row(s) contain tandem repeats with "
            f"period <= k={k} (row ids {repeat_rows[:8].tolist()}"
            f"{', ...' if len(repeat_rows) > 8 else ''}): reads lying inside "
            "such repeats are the one input class where this tool's "
            "positional walk may report a different eq class than the "
            "upstream pseudoaligner (see docs/SEMANTICS.md, 'The one "
            "divergence class').",
            stacklevel=2,
        )

    return KmerIndex(
        k=k,
        row_codes=row_codes,
        row_lengths=row_lengths,
        keys_sorted=keys_sorted,
        post_starts=post_starts,
        postings_rows=postings_rows,
        postings_offs=postings_offs,
        num_kmers=total,
        repeat_rows=repeat_rows,
    )
