"""Multi-chip execution: data-parallel reads × model-parallel k-mer index.

The reference's only parallelism is a single-host thread pipeline
(`src/process/bam.rs:149-226`); this design scales over a 2-D
`jax.sharding.Mesh`:

  * ``data`` axis — reads are sharded batch-wise (the DP axis; one shard per
    chip, one feed per host);
  * ``model`` axis — the k-mer hash table + postings are sharded by key-hash
    (the TP-analog axis for libraries whose index outgrows one device's memory).

Each key lives on exactly one model shard, so each read's anchor k-mer has
exactly one owner.  The combine is pure XLA collectives inside `shard_map`:

  1. every model shard probes its table slice for all positions;
  2. `psum` over ``model`` merges per-position hit masks -> the global anchor
     position (first hit anywhere) is known replicated;
  3. only the owner shard walks the read (its postings hold the candidates;
     reference rows are replicated — they are tiny next to the table);
  4. `psum` over ``model`` merges the walk outputs (non-owners contribute
     zeros); a per-row hit histogram is `psum`-merged over BOTH axes.

Single-device semantics are preserved exactly: the sharded step's outputs
are bit-identical to `ops.engine_xla.probe_and_walk` on the same batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from nimble_tpu.index.build import KmerIndex
from nimble_tpu.ops.device_index import (
    EMPTY_SLOT,
    hash_kmer,
    insert_hash_table,
    span_gather_indices,
)
from nimble_tpu.ops.engine_xla import (
    gather_candidates,
    probe_positions,
    walk_candidates,
)


@dataclass
class ShardedIndex:
    """Stacked per-shard tables (leading axis = model shard)."""

    k: int
    n_shards: int
    table_size: int
    max_probe: int
    table_key_lo: np.ndarray   # (S, T) uint32
    table_key_hi: np.ndarray   # (S, T) uint32
    table_start: np.ndarray    # (S, T) int32
    table_count: np.ndarray    # (S, T) int32
    postings_row: np.ndarray   # (S, Pmax) int32
    postings_off: np.ndarray   # (S, Pmax) int32
    ref_codes: np.ndarray      # replicated
    row_starts: np.ndarray
    row_lengths: np.ndarray
    num_rows: int


def build_sharded_index(
    index: KmerIndex, n_shards: int, load_factor: float = 0.4
) -> ShardedIndex:
    """Partition the k-mer map by key hash into ``n_shards`` stacked tables."""
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0, "n_shards must be pow2"
    k = index.k

    keys = index.keys_sorted
    key_lo = (keys & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = ((keys >> np.uint64(30)) & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    h_full = hash_kmer(key_lo, key_hi)
    # shard assignment uses high hash bits; slot selection uses low bits
    shard_of = ((h_full >> np.uint32(16)) & np.uint32(n_shards - 1)).astype(np.int64)

    # shared table geometry: sized for the most loaded shard
    max_keys = int(np.bincount(shard_of, minlength=n_shards).max()) if len(keys) else 1
    table_size = 64
    while table_size * load_factor < max_keys:
        table_size *= 2

    tkl = np.full((n_shards, table_size), EMPTY_SLOT, dtype=np.uint32)
    tkh = np.full((n_shards, table_size), EMPTY_SLOT, dtype=np.uint32)
    tst = np.zeros((n_shards, table_size), dtype=np.int32)
    tcn = np.zeros((n_shards, table_size), dtype=np.int32)

    # per shard: keys keep the global (sorted) order; postings spans re-base
    # to shard-local starts and gather vectorized from the columnar CSR
    g_counts = np.diff(index.post_starts)
    g_starts = index.post_starts[:-1]
    max_probe = 1
    shard_sel = [np.flatnonzero(shard_of == s) for s in range(n_shards)]
    pmax = max(
        (int(g_counts[sel].sum()) for sel in shard_sel if len(sel)),
        default=1,
    )
    pmax = max(pmax, 1)
    prow = np.zeros((n_shards, pmax), dtype=np.int32)
    poff = np.zeros((n_shards, pmax), dtype=np.int32)
    for s, sel in enumerate(shard_sel):
        if not len(sel):
            continue
        counts_s = g_counts[sel]
        local_starts = np.concatenate(([0], np.cumsum(counts_s)[:-1]))
        probe = insert_hash_table(
            keys[sel], local_starts, counts_s,
            tkl[s], tkh[s], tst[s], tcn[s],
        )
        max_probe = max(max_probe, probe)
        gidx = span_gather_indices(g_starts[sel], counts_s)
        prow[s, : len(gidx)] = index.postings_rows[gidx]
        poff[s, : len(gidx)] = index.postings_offs[gidx]

    row_lengths = index.row_lengths.astype(np.int32)
    row_starts = np.concatenate(([0], np.cumsum(row_lengths)))[:-1].astype(np.int32)
    total_len = int(row_lengths.sum())
    ref_codes = np.zeros(max(total_len, 1), dtype=np.int8)
    for r, codes in enumerate(index.row_codes):
        ref_codes[row_starts[r] : row_starts[r] + len(codes)] = codes

    return ShardedIndex(
        k=k,
        n_shards=n_shards,
        table_size=table_size,
        max_probe=max_probe,
        table_key_lo=tkl,
        table_key_hi=tkh,
        table_start=tst,
        table_count=tcn,
        postings_row=prow,
        postings_off=poff,
        ref_codes=ref_codes,
        row_starts=row_starts,
        row_lengths=row_lengths,
        num_rows=len(row_lengths),
    )


def make_sharded_step(mesh: Mesh, sidx: ShardedIndex, *, c_max: int = 8):
    """Build the jitted 2-D-sharded align step over ``mesh`` ('data','model').

    Returns ``step(reads, read_lens, *index_arrays) -> dict`` where per-read
    outputs are sharded over 'data' and ``row_hit_counts`` (the per-library-row
    hit histogram, the psum-merged DP reduction) is fully replicated.
    """
    k = sidx.k
    max_probe = sidx.max_probe
    table_mask = sidx.table_size - 1
    num_rows = sidx.num_rows

    data_spec = P("data")
    model_spec = P("model")
    repl = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None), data_spec,               # reads, lens
            P("model", None), P("model", None),        # table keys
            P("model", None), P("model", None),        # table spans
            P("model", None), P("model", None),        # postings
            repl, repl, repl,                          # ref rows
        ),
        out_specs={
            "has_anchor": data_spec,
            "overflow": data_spec,
            "rows": P("data", None),
            "live": P("data", None),
            "score": data_spec,
            "mismatches": data_spec,
            "row_hit_counts": repl,
        },
        check_vma=False,
    )
    def step(reads, read_lens, tkl, tkh, tst, tcn, prow, poff, refc, rstarts, rlens):
        # model-sharded inputs arrive with a leading shard axis of size 1
        tkl, tkh, tst, tcn = tkl[0], tkh[0], tst[0], tcn[0]
        prow, poff = prow[0], poff[0]
        reads_i32 = reads.astype(jnp.int32)

        # local probe of this model shard's table slice
        hit, start, cnt = probe_positions(
            reads_i32, read_lens, tkl, tkh, tst, tcn,
            k=k, max_probe=max_probe, table_mask=table_mask,
        )

        # global anchor: first position hit on ANY model shard
        hit_any = jax.lax.psum(hit.astype(jnp.int32), "model") > 0
        has_anchor = hit_any.any(axis=1)
        anchor = jnp.argmax(hit_any, axis=1).astype(jnp.int32)

        # this shard owns the read iff ITS table has the anchor k-mer
        owner = jnp.take_along_axis(hit, anchor[:, None], axis=1)[:, 0]
        astart = jnp.take_along_axis(start, anchor[:, None], axis=1)[:, 0]
        acnt = jnp.take_along_axis(cnt, anchor[:, None], axis=1)[:, 0]

        rows, offs, live0, overflow = gather_candidates(
            astart, acnt, prow, poff, has_anchor & owner, c_max=c_max
        )
        live, walk_score, walk_mm = walk_candidates(
            reads_i32, read_lens, anchor, rows, offs, live0,
            refc, rstarts, rlens, k=k,
        )

        own = owner & has_anchor
        score = jax.lax.psum(jnp.where(own, k + walk_score, 0), "model")
        mismatches = jax.lax.psum(jnp.where(own, walk_mm, 0), "model")
        overflow_g = jax.lax.psum(
            jnp.where(own, overflow, False).astype(jnp.int32), "model"
        ) > 0
        rows_g = jax.lax.psum(jnp.where(own[:, None], rows, 0), "model")
        live_g = jax.lax.psum(
            jnp.where(own[:, None], live, False).astype(jnp.int32), "model"
        ) > 0

        # per-row hit histogram, merged over the whole mesh (the DP reduction)
        flat_rows = jnp.where(live, rows, 0).reshape(-1)
        flat_hits = jnp.where(own[:, None], live, False).astype(jnp.int32).reshape(-1)
        counts_local = jax.ops.segment_sum(flat_hits, flat_rows, num_segments=num_rows)
        row_hit_counts = jax.lax.psum(counts_local, ("data", "model"))

        return {
            "has_anchor": has_anchor,
            "overflow": overflow_g,
            "rows": rows_g,
            "live": live_g,
            "score": score,
            "mismatches": mismatches,
            "row_hit_counts": row_hit_counts,
        }

    return jax.jit(step)


def device_arrays(sidx: ShardedIndex) -> Tuple:
    """The index arrays in the order make_sharded_step expects after reads."""
    return (
        jnp.asarray(sidx.table_key_lo),
        jnp.asarray(sidx.table_key_hi),
        jnp.asarray(sidx.table_start),
        jnp.asarray(sidx.table_count),
        jnp.asarray(sidx.postings_row),
        jnp.asarray(sidx.postings_off),
        jnp.asarray(sidx.ref_codes),
        jnp.asarray(sidx.row_starts),
        jnp.asarray(sidx.row_lengths),
    )
