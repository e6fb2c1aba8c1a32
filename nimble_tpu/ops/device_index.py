"""Device-resident k-mer index: open-addressed hash table + postings + rows.

Derived from the host `KmerIndex` (`nimble_tpu.index.build`), laid out for
batched probing on the device:

  * 60-bit k-mer keys are split into two 30-bit halves carried as uint32
    lanes (``key_hi`` = first 15 bases, ``key_lo`` = last 15 bases) — JAX
    runs with 64-bit integers disabled by default;
  * an open-addressed, linearly-probed hash table maps keys to a span
    (start, count) in the flat postings arrays; empty slots hold the sentinel
    0xFFFFFFFF in both key lanes (impossible: real halves are < 2^30);
  * ``max_probe`` is the table's exact maximum probe-sequence length measured
    at build time, so a fixed-trip probe loop is provably sufficient;
  * postings are (row_id, offset) pairs; the reference rows live as one
    concatenated int8 code array with per-row starts/lengths.

This mirrors the role of the colored de Bruijn graph built by the external
`debruijn_mapping::build_index` (`src/bin/main.rs:121-128`): a k-mer's
postings row-set is exactly its color/equivalence class.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nimble_tpu.index.build import KmerIndex

EMPTY_SLOT = np.uint32(0xFFFFFFFF)


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on uint32 lanes (identical in numpy and jnp)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def hash_kmer(key_lo: np.ndarray, key_hi: np.ndarray) -> np.ndarray:
    """Combine the two 30-bit halves into a well-mixed uint32 hash."""
    return fmix32(key_lo.astype(np.uint32) ^ fmix32(key_hi.astype(np.uint32)))


FP_SALT = np.uint32(0x7FEB352D)


def kmer_fp(key_lo: np.ndarray, key_hi: np.ndarray) -> np.ndarray:
    """uint32 probe FINGERPRINT of a 60-bit key, independent of hash_kmer.

    The probe loop's table gathers dominate the fast kernel (measured
    3.0 ms of a 5.8 ms 8192-read launch), so the probe compares one
    fingerprint word per lane instead of the lo|hi pair — HALVING the
    gathered bytes.  A fingerprint can collide (~2^-32 per lane compare),
    so the kernel verifies the SELECTED lane's full lo/hi key afterward
    (two (B,) element gathers) and routes mismatches into the exact
    host-rescue path (`needs_host`/`overflow`).  Must mix differently
    from hash_kmer: keys sharing a bucket share hash low bits.
    """
    lo = key_lo.astype(np.uint32)
    hi = key_hi.astype(np.uint32)
    rot = (hi << np.uint32(16)) | (hi >> np.uint32(16))
    return fmix32(rot ^ fmix32(lo ^ FP_SALT))


@dataclass
class DeviceIndex:
    """Flat numpy arrays ready to be device_put (see DeviceAlignEngine)."""

    k: int
    table_size: int          # power of two
    max_probe: int           # exact max probe distance measured at build
    table_key_lo: np.ndarray  # (table_size,) uint32
    table_key_hi: np.ndarray  # (table_size,) uint32
    table_start: np.ndarray   # (table_size,) int32 — postings span start
    table_count: np.ndarray   # (table_size,) int32 — postings span length
    postings_row: np.ndarray  # (n_postings,) int32
    postings_off: np.ndarray  # (n_postings,) int32
    ref_codes: np.ndarray     # (total_ref_len,) int8 — concatenated rows
    row_starts: np.ndarray    # (n_rows,) int32
    row_lengths: np.ndarray   # (n_rows,) int32
    max_postings: int         # largest postings span in the index


@dataclass
class BucketedDeviceIndex:
    """Bucketized hash layout for fast device probing.

    Element-wise linear probing (DeviceIndex) costs one random gather per
    probe step; random gathers are the costly memory access, so this layout
    packs WIDTH slots into one contiguous bucket row — a single gather
    fetches the whole bucket and the lane compare is elementwise.  ``max_probe`` counts BUCKET hops
    (nearly always 1 at load <= 0.5).

    ``ref_codes_padded`` carries ``ref_pad`` guard zeros on both sides so the
    walk can slice fixed-size candidate spans without bounds clamping.
    """

    k: int
    n_buckets: int
    width: int
    max_probe: int
    bkey_lo: np.ndarray     # (n_buckets, width) uint32
    bkey_hi: np.ndarray     # (n_buckets, width) uint32
    bkey_fp: np.ndarray     # (n_buckets, width) uint32 — kmer_fp(lo, hi)
    bstart: np.ndarray      # (n_buckets, width) int32
    bcount: np.ndarray      # (n_buckets, width) int32
    postings_row: np.ndarray
    postings_off: np.ndarray
    ref_codes_padded: np.ndarray  # (ref_pad + total_len + ref_pad) int8
    ref_codes_packed: np.ndarray  # same data 2-bit packed, 16 bases/uint32
    ref_pad: int
    row_starts: np.ndarray
    row_lengths: np.ndarray
    max_postings: int


def insert_bucket_table(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    bkey_lo: np.ndarray, bkey_hi: np.ndarray,
    bstart: np.ndarray, bcount: np.ndarray, width: int,
) -> int:
    """Insert ``keys`` (with postings spans ``starts``/``counts``) into a
    bucketized table; returns the measured max_probe in bucket hops.
    Native C++ loop when available, NumPy/Python fallback otherwise.
    ``bkey_lo``/``bkey_hi`` must be pre-filled with EMPTY_SLOT."""
    n_keys = len(keys)
    if n_keys == 0:
        return 1
    if n_keys > bkey_lo.shape[0] * width:
        raise ValueError(
            f"{n_keys} keys exceed bucket table capacity "
            f"{bkey_lo.shape[0]}x{width}"
        )
    from nimble_tpu import native

    got = native.build_bucket_table(
        keys, starts, counts, bkey_lo, bkey_hi, bstart, bcount, width
    )
    if got is not None:
        return max(int(got), 1)

    n_buckets = bkey_lo.shape[0]
    mask = n_buckets - 1
    key_lo = (keys & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = ((keys >> np.uint64(30)) & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    h = hash_kmer(key_lo, key_hi).astype(np.int64) & mask
    fill = np.zeros(n_buckets, dtype=np.int64)
    max_probe = 1
    for i in range(n_keys):
        b = int(h[i])
        probe = 1
        while fill[b] >= width:
            b = (b + 1) & mask
            probe += 1
        lane = fill[b]
        bkey_lo[b, lane] = key_lo[i]
        bkey_hi[b, lane] = key_hi[i]
        bstart[b, lane] = starts[i]
        bcount[b, lane] = counts[i]
        fill[b] += 1
        max_probe = max(max_probe, probe)
    return max_probe


def insert_hash_table(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    table_key_lo: np.ndarray, table_key_hi: np.ndarray,
    table_start: np.ndarray, table_count: np.ndarray,
) -> int:
    """Insert into a flat open-addressed table (element-wise linear probe);
    returns max_probe.  Native fast path with Python fallback."""
    n_keys = len(keys)
    if n_keys == 0:
        return 1
    if n_keys > len(table_key_lo):
        raise ValueError(
            f"{n_keys} keys exceed table capacity {len(table_key_lo)}"
        )
    from nimble_tpu import native

    got = native.build_hash_table(
        keys, np.asarray(starts, dtype=np.int32),
        np.asarray(counts, dtype=np.int32),
        table_key_lo, table_key_hi, table_start, table_count,
    )
    if got is not None:
        return max(int(got), 1)

    table_size = len(table_key_lo)
    mask = table_size - 1
    key_lo = (keys & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = ((keys >> np.uint64(30)) & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    h = hash_kmer(key_lo, key_hi).astype(np.int64) & mask
    occupied = np.zeros(table_size, dtype=bool)
    max_probe = 1
    for i in range(n_keys):
        slot = int(h[i])
        probe = 1
        while occupied[slot]:
            slot = (slot + 1) & mask
            probe += 1
        occupied[slot] = True
        table_key_lo[slot] = key_lo[i]
        table_key_hi[slot] = key_hi[i]
        table_start[slot] = starts[i]
        table_count[slot] = counts[i]
        max_probe = max(max_probe, probe)
    return max_probe


def span_gather_indices(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat indices covering [starts[i], starts[i]+counts[i]) for every i,
    concatenated in order — the vectorized multi-span gather."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    local = np.concatenate(([0], np.cumsum(counts)[:-1]))
    return np.repeat(np.asarray(starts, dtype=np.int64) - local, counts) + np.arange(total)


def build_bucketed_index(
    index: KmerIndex, width: int = 8, load_factor: float = 0.25,
    ref_pad: int = 1024 + 32, min_buckets: int = 16,
) -> BucketedDeviceIndex:
    """Bucketized table at load 0.25: the probe loop's table gathers are the
    kernel's dominant cost, and a quarter-full 8-wide layout keeps the
    measured max_probe at 1 for virtually any key set (2x HBM for the
    table, which is megabytes)."""
    keys = index.keys_sorted
    n_keys = len(keys)

    # zero-copy views of the host index's columnar CSR postings
    counts = np.diff(index.post_starts)
    starts = index.post_starts[:-1]
    total_postings = index.num_kmers
    if total_postings:
        postings_row = index.postings_rows
        postings_off = index.postings_offs
    else:
        postings_row = np.zeros(1, dtype=np.int32)
        postings_off = np.zeros(1, dtype=np.int32)

    n_buckets = max(16, int(min_buckets))
    while n_buckets * width * load_factor < max(n_keys, 1):
        n_buckets *= 2

    # grow until max_probe == 1: every probe hop costs a full (B, P, W)
    # table gather + lane reduction in the kernel, while another table
    # doubling costs megabytes of device memory — overflowing buckets are
    # Poisson-rare, so one doubling almost always suffices.  Cap at 64 MB
    # per key half.
    while True:
        bkey_lo = np.full((n_buckets, width), EMPTY_SLOT, dtype=np.uint32)
        bkey_hi = np.full((n_buckets, width), EMPTY_SLOT, dtype=np.uint32)
        bstart = np.zeros((n_buckets, width), dtype=np.int32)
        bcount = np.zeros((n_buckets, width), dtype=np.int32)
        max_probe = insert_bucket_table(
            keys, starts, counts, bkey_lo, bkey_hi, bstart, bcount, width
        )
        if max_probe == 1 or n_buckets * width * 4 >= (64 << 20):
            break
        n_buckets *= 2

    row_lengths = index.row_lengths.astype(np.int32)
    row_starts = np.concatenate(([0], np.cumsum(row_lengths)))[:-1].astype(np.int32)
    total_len = int(row_lengths.sum())
    padded_len = ref_pad + max(total_len, 1) + ref_pad
    padded_len = (padded_len + 15) // 16 * 16  # whole uint32 words
    ref_padded = np.zeros(padded_len, dtype=np.int8)
    for r, codes in enumerate(index.row_codes):
        ref_padded[ref_pad + row_starts[r] : ref_pad + row_starts[r] + len(codes)] = codes

    # 2-bit packing, 16 bases per uint32: base j lives in word j>>4 at bit
    # 2*(j&15) — gathers cost per element, so spans are fetched as a few
    # contiguous words and unpacked with shifts and masks.
    w = ref_padded.astype(np.uint32).reshape(-1, 16)
    shifts = (np.uint32(2) * np.arange(16, dtype=np.uint32))[None, :]
    ref_packed = (w << shifts).sum(axis=1, dtype=np.uint32)

    return BucketedDeviceIndex(
        k=index.k,
        n_buckets=n_buckets,
        width=width,
        max_probe=max_probe,
        bkey_lo=bkey_lo,
        bkey_hi=bkey_hi,
        bkey_fp=kmer_fp(bkey_lo, bkey_hi),
        bstart=bstart,
        bcount=bcount,
        postings_row=postings_row,
        postings_off=postings_off,
        ref_codes_padded=ref_padded,
        ref_codes_packed=ref_packed,
        ref_pad=ref_pad,
        row_starts=row_starts,
        row_lengths=row_lengths,
        max_postings=int(counts.max()) if n_keys else 0,
    )


def build_device_index(index: KmerIndex, load_factor: float = 0.4) -> DeviceIndex:
    """Lay the host KmerIndex out as flat device-ready arrays."""
    k = index.k
    keys = index.keys_sorted
    n_keys = len(keys)

    # zero-copy views of the host index's columnar CSR postings
    counts = np.diff(index.post_starts)
    starts = index.post_starts[:-1]
    total_postings = index.num_kmers
    if total_postings:
        postings_row = index.postings_rows
        postings_off = index.postings_offs
    else:
        postings_row = np.zeros(1, dtype=np.int32)
        postings_off = np.zeros(1, dtype=np.int32)

    table_size = 64
    while table_size * load_factor < max(n_keys, 1):
        table_size *= 2

    table_key_lo = np.full(table_size, EMPTY_SLOT, dtype=np.uint32)
    table_key_hi = np.full(table_size, EMPTY_SLOT, dtype=np.uint32)
    table_start = np.zeros(table_size, dtype=np.int32)
    table_count = np.zeros(table_size, dtype=np.int32)

    # Linear-probe insertion (host-side, one-time at library load)
    max_probe = insert_hash_table(
        keys, starts, counts,
        table_key_lo, table_key_hi, table_start, table_count,
    )

    # concatenated reference rows
    row_lengths = index.row_lengths.astype(np.int32)
    row_starts = np.concatenate(([0], np.cumsum(row_lengths)))[:-1].astype(np.int32)
    total_len = int(row_lengths.sum())
    ref_codes = np.zeros(max(total_len, 1), dtype=np.int8)
    for r, codes in enumerate(index.row_codes):
        ref_codes[row_starts[r] : row_starts[r] + len(codes)] = codes

    return DeviceIndex(
        k=k,
        table_size=table_size,
        max_probe=max_probe,
        table_key_lo=table_key_lo,
        table_key_hi=table_key_hi,
        table_start=table_start,
        table_count=table_count,
        postings_row=postings_row,
        postings_off=postings_off,
        ref_codes=ref_codes,
        row_starts=row_starts,
        row_lengths=row_lengths,
        max_postings=int(counts.max()) if n_keys else 0,
    )
