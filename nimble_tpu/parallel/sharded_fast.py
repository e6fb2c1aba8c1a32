"""Mesh port of the bucketized fast kernel (data × model sharding).

`parallel.sharded` runs the original element-gather formulation; this module
ports the production fast kernel (`ops.engine_fast.probe_walk_filter`) onto a
2-D `jax.sharding.Mesh`:

  * ``data`` axis — reads sharded batch-wise (DP);
  * ``model`` axis — the BUCKETIZED k-mer table partitioned by key-hash high
    bits into per-shard open-addressed sub-tables (common geometry).  Each
    key lives on exactly one shard, so each read's anchor k-mer has exactly
    one owner; the owner walks the read and `psum` over ``model`` merges the
    packed outputs (zeros elsewhere).

The step consumes the same ONE packed uint8 buffer per launch as the
single-chip engine (2-bit codes + u16 length) and emits ONE int32 (B, 3)
result — astart is globalized as ``shard_id * postings_stride + local``, so
the host-side combo decode uses the stacked postings exactly like the
single-chip path.  Bit-equality with `probe_walk_filter` is asserted in
tests/test_sharded.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from nimble_tpu.index.build import KmerIndex
from nimble_tpu.ops.device_index import (
    EMPTY_SLOT,
    hash_kmer,
    insert_bucket_table,
    kmer_fp,
    span_gather_indices,
)
from nimble_tpu.ops.engine_fast import (
    _probe_encoded,
    _span_walk,
)


@dataclass
class ShardedBucketedIndex:
    """Per-model-shard bucketized tables with common geometry."""

    k: int
    n_shards: int
    n_buckets: int
    width: int
    max_probe: int
    postings_stride: int        # per-shard postings capacity (Pmax)
    bkey_lo: np.ndarray         # (S, n_buckets, width) uint32
    bkey_hi: np.ndarray
    bkey_fp: np.ndarray         # (S, n_buckets, width) uint32 kmer_fp(lo,hi)
    bstart: np.ndarray          # (S, n_buckets, width) int32 (shard-local)
    bcount: np.ndarray
    postings_row: np.ndarray    # (S, Pmax) int32
    postings_off: np.ndarray    # (S, Pmax) int32
    postings_row_flat: np.ndarray  # (S*Pmax,) int32 — host decode view
    ref_codes_packed: np.ndarray   # replicated, 2-bit packed
    ref_pad: int
    row_starts: np.ndarray
    row_lengths: np.ndarray
    max_postings: int


def build_sharded_bucketed_index(
    index: KmerIndex, n_shards: int, width: int = 8, load_factor: float = 0.5,
    ref_pad: int = 1024 + 32,
) -> ShardedBucketedIndex:
    """Partition the k-mer map by key-hash high bits into per-shard
    bucketized tables (same geometry on every shard)."""
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0
    keys = index.keys_sorted
    n_keys = len(keys)
    key_lo = (keys & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = ((keys >> np.uint64(30)) & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    h_full = hash_kmer(key_lo, key_hi)
    # shard by high hash bits; bucket index inside a shard uses low bits —
    # independent bit ranges keep per-shard load balanced
    shard_of = ((h_full >> np.uint32(16)) & np.uint32(n_shards - 1)).astype(np.int64)

    per_shard = np.bincount(shard_of, minlength=n_shards) if n_keys else np.zeros(n_shards, np.int64)
    max_keys = int(per_shard.max()) if n_keys else 1
    n_buckets = 16
    while n_buckets * width * load_factor < max(max_keys, 1):
        n_buckets *= 2

    # per shard: key subset keeps the global (sorted) key order; postings
    # spans are re-based to shard-local starts and gathered vectorized from
    # the host index's columnar CSR arrays
    g_counts = np.diff(index.post_starts)
    g_starts = index.post_starts[:-1]
    max_postings = int(g_counts.max()) if n_keys else 0
    shard_sel = [np.flatnonzero(shard_of == s) for s in range(n_shards)]
    pmax = max(
        (int(g_counts[sel].sum()) for sel in shard_sel if len(sel)),
        default=1,
    )
    pmax = max(pmax, 1)
    prow = np.zeros((n_shards, pmax), dtype=np.int32)
    poff = np.zeros((n_shards, pmax), dtype=np.int32)
    # grow until max_probe == 1 (same rationale as build_bucketed_index:
    # each hop costs a full table gather + lane reduction per launch)
    while True:
        bkl = np.full((n_shards, n_buckets, width), EMPTY_SLOT, dtype=np.uint32)
        bkh = np.full((n_shards, n_buckets, width), EMPTY_SLOT, dtype=np.uint32)
        bst = np.zeros((n_shards, n_buckets, width), dtype=np.int32)
        bcn = np.zeros((n_shards, n_buckets, width), dtype=np.int32)
        max_probe = 1
        for s, sel in enumerate(shard_sel):
            if not len(sel):
                continue
            counts_s = g_counts[sel]
            local_starts = np.concatenate(([0], np.cumsum(counts_s)[:-1]))
            probe = insert_bucket_table(
                keys[sel], local_starts, counts_s,
                bkl[s], bkh[s], bst[s], bcn[s], width,
            )
            max_probe = max(max_probe, probe)
            gidx = span_gather_indices(g_starts[sel], counts_s)
            prow[s, : len(gidx)] = index.postings_rows[gidx]
            poff[s, : len(gidx)] = index.postings_offs[gidx]
        if max_probe == 1 or n_shards * n_buckets * width * 4 >= (64 << 20):
            break
        n_buckets *= 2

    row_lengths = index.row_lengths.astype(np.int32)
    row_starts = np.concatenate(([0], np.cumsum(row_lengths)))[:-1].astype(np.int32)
    total_len = int(row_lengths.sum())
    padded_len = ref_pad + max(total_len, 1) + ref_pad
    padded_len = (padded_len + 15) // 16 * 16
    ref_padded = np.zeros(padded_len, dtype=np.int8)
    for r, codes in enumerate(index.row_codes):
        ref_padded[ref_pad + row_starts[r] : ref_pad + row_starts[r] + len(codes)] = codes
    w = ref_padded.astype(np.uint32).reshape(-1, 16)
    shifts = (np.uint32(2) * np.arange(16, dtype=np.uint32))[None, :]
    ref_packed = (w << shifts).sum(axis=1, dtype=np.uint32)

    return ShardedBucketedIndex(
        k=index.k, n_shards=n_shards, n_buckets=n_buckets, width=width,
        max_probe=max_probe, postings_stride=pmax,
        bkey_lo=bkl, bkey_hi=bkh, bkey_fp=kmer_fp(bkl, bkh),
        bstart=bst, bcount=bcn,
        postings_row=prow, postings_off=poff,
        postings_row_flat=prow.reshape(-1),
        ref_codes_packed=ref_packed, ref_pad=ref_pad,
        row_starts=row_starts, row_lengths=row_lengths,
        max_postings=max_postings,
    )


def make_sharded_fast_step(
    mesh: Mesh, sbidx: ShardedBucketedIndex, *, c_max: int, bucket: int,
    score_threshold: int, num_mismatches: int,
    discard_multiple: bool, discard_nonzero: bool,
):
    """Jitted (data × model) fast step: packed buffer in, packed (B, 3) out.

    Output columns (replicated over 'model', sharded over 'data'):
      col 0 = global astart (shard_id * postings_stride + local start)
      col 1 = mask | passed<<16 | needs_host<<17 | has_anchor<<18
      col 2 = score<<16 | mismatches
    Matches `probe_walk_filter` bit-for-bit on a 1-shard model axis, and for
    any sharding by the owner-merge argument (each anchor key has exactly
    one owner shard; psum merges owner-masked packed values).
    """
    k = sbidx.k
    max_probe = sbidx.max_probe
    bucket_mask = sbidx.n_buckets - 1
    stride = sbidx.postings_stride
    p_limit = bucket - k + 1
    nb = (bucket + 3) // 4

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None),                       # packed reads buffer
            P("model", None, None), P("model", None, None),  # bucket keys
            P("model", None, None),                # bucket fingerprints
            P("model", None, None), P("model", None, None),  # bucket spans
            P("model", None), P("model", None),    # postings
            P(), P(), P(),                         # packed ref, row spans
            P(),                                   # s_min table
        ),
        out_specs=P("data", None),
        check_vma=False,
    )
    def step(packed, bkl, bkh, bkf, bst, bcn, prow, poff, refp, rstarts,
             rlens, s_min_table):
        bkl, bkh, bkf = bkl[0], bkh[0], bkf[0]
        bst, bcn = bst[0], bcn[0]
        prow, poff = prow[0], poff[0]

        B = packed.shape[0]
        words = packed[:, :nb].astype(jnp.int32)
        j = jnp.arange(bucket, dtype=jnp.int32)
        reads_i32 = (words[:, j >> 2] >> ((j & 3) * 2)[None, :]) & 3
        read_lens = (
            packed[:, nb].astype(jnp.int32)
            | (packed[:, nb + 1].astype(jnp.int32) << 8)
        )

        # local ENCODED probe over this shard's sub-table (two-phase
        # compacted, shared with the single-chip kernel); the global anchor
        # is ONE pmax of the (B,) encoded values over the model axis — the
        # old formulation psum'd a (B, P) per-position hit mask, ~P x more
        # interconnect traffic per launch.  Each key lives on exactly one shard, so
        # at the winning position only the owner shard matches (fingerprint
        # collisions on a non-owner shard lose the verification below and
        # route to host rescue, exactly like single-chip fp collisions).
        P_pos = min(bucket - k + 1, p_limit)
        W = bkf.shape[1]
        m_loc, h, lo, hi, hop_sel = _probe_encoded(
            reads_i32, read_lens, bkf,
            k=k, max_probe=max_probe, bucket_mask=bucket_mask,
            p_limit=p_limit,
        )
        m_g = jax.lax.pmax(m_loc, "model")
        has_anchor = m_g > 0
        anchor = jnp.where(
            has_anchor, jnp.uint32(P_pos) - (m_g >> jnp.uint32(8)), 0
        ).astype(jnp.int32)
        owner = has_anchor & (m_loc == m_g)

        take = lambda a: jnp.take_along_axis(a, anchor[:, None], axis=1)[:, 0]
        lane_sel = jnp.where(
            owner, jnp.uint32(W) - (m_loc & jnp.uint32(0xFF)), 0
        ).astype(jnp.int32)
        hop = take(hop_sel) if hop_sel is not None else jnp.uint32(0)
        bucket_sel = jnp.where(
            owner, (take(h) + hop) & jnp.uint32(bucket_mask), 0
        ).astype(jnp.int32)

        # exact verification of the owner shard's selected lane
        fp_bad_loc = owner & (
            (bkl[bucket_sel, lane_sel] != take(lo))
            | (bkh[bucket_sel, lane_sel] != take(hi))
        )

        astart_loc = bst[bucket_sel, lane_sel]
        acnt = jnp.where(owner, bcn[bucket_sel, lane_sel], 0)
        overflow_loc = acnt > c_max

        c_idx = jnp.arange(c_max, dtype=jnp.int32)[None, :]
        live0 = c_idx < jnp.minimum(acnt, c_max)[:, None]
        pidx = jnp.clip(astart_loc[:, None] + c_idx, 0, prow.shape[0] - 1)
        rows = prow[pidx]
        offs = poff[pidx].astype(jnp.int32)

        live, walk_score, walk_mm = _span_walk(
            reads_i32, read_lens, anchor, rows, offs, live0,
            refp, rstarts, rlens,
            k=k, ref_pad=sbidx.ref_pad,
        )

        shard_id = jax.lax.axis_index("model").astype(jnp.int32)
        lane_bits = (1 << jnp.arange(c_max, dtype=jnp.int32))[None, :]
        mask_loc = jnp.where(live & owner[:, None], lane_bits, 0).sum(axis=1)

        own_i = owner.astype(jnp.int32)
        score_g = jax.lax.psum(own_i * (k + walk_score), "model")
        mm_g = jax.lax.psum(own_i * walk_mm, "model")
        mask_g = jax.lax.psum(mask_loc, "model")
        astart_g = jax.lax.psum(
            own_i * (astart_loc + shard_id * stride), "model"
        )
        overflow_g = jax.lax.psum(
            (owner & overflow_loc).astype(jnp.int32), "model"
        ) > 0
        rows_g = jax.lax.psum(jnp.where(owner[:, None] & live, rows, 0), "model")
        live_g = jax.lax.psum(
            (owner[:, None] & live).astype(jnp.int32), "model"
        ) > 0

        score = jnp.where(has_anchor, score_g, 0)
        mm = jnp.where(has_anchor, mm_g, 0)

        # distinct live-row count via pairwise lane compares (no device
        # sort); the entropy gate runs host-side in exact f64 like the
        # single-chip engine (MeshAlignEngine.compact_collect)
        dup = (
            (rows_g[:, :, None] == rows_g[:, None, :])
            & live_g[:, :, None] & live_g[:, None, :]
            & (jnp.arange(c_max)[:, None] > jnp.arange(c_max)[None, :])
        ).any(axis=2)
        distinct = (live_g & ~dup).sum(axis=1).astype(jnp.int32)

        s_min = s_min_table[jnp.clip(read_lens, 0, s_min_table.shape[0] - 1)]
        passed = (
            has_anchor
            & (score >= jnp.int32(score_threshold))
            & (score >= s_min)
            & (mm <= jnp.int32(num_mismatches))
        )
        if discard_multiple:
            passed = passed & (distinct <= 1)
        if discard_nonzero:
            passed = passed & (mm == 0)

        fp_bad_g = jax.lax.psum(fp_bad_loc.astype(jnp.int32), "model") > 0
        needs_host = (has_anchor & overflow_g) | fp_bad_g
        flags = (
            mask_g
            | ((passed & ~needs_host).astype(jnp.int32) << 16)
            | (needs_host.astype(jnp.int32) << 17)
            | (has_anchor.astype(jnp.int32) << 18)
        )
        col2 = (score << 16) | mm
        return jnp.stack([astart_g, flags, col2], axis=1)

    return jax.jit(step)



def sharded_device_arrays(sbidx: ShardedBucketedIndex) -> Tuple:
    return (
        jnp.asarray(sbidx.bkey_lo),
        jnp.asarray(sbidx.bkey_hi),
        jnp.asarray(sbidx.bkey_fp),
        jnp.asarray(sbidx.bstart),
        jnp.asarray(sbidx.bcount),
        jnp.asarray(sbidx.postings_row),
        jnp.asarray(sbidx.postings_off),
        jnp.asarray(sbidx.ref_codes_packed),
        jnp.asarray(sbidx.row_starts),
        jnp.asarray(sbidx.row_lengths),
    )
