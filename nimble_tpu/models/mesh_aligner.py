"""Multi-chip alignment engine over a (data × model) device mesh.

Runs the bucketized fast kernel sharded over the mesh
(`parallel.sharded_fast.make_sharded_fast_step`) — reads data-parallel, the
k-mer table hash-partitioned over the model axis — behind the same compact
interface as `DeviceAlignEngine`, so `core.fast_count.FastCounter` and the
pipelines work unchanged (including the vectorized combo decode: global
``astart`` indexes the stacked per-shard postings).

Exactness follows the single-chip engine: integer thresholds on device, f64
gates via the compact flags, host-oracle rescue for unbounded reads.  On a
single-host CPU run the mesh uses the 8 virtual devices from
``xla_force_host_platform_device_count``; on a GPU host it spans all cards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from nimble_tpu.config import (
    MIN_ENTROPY_SCORE,
    MIN_READ_LENGTH,
    AlignFilterConfig,
    FilterReason,
)
from nimble_tpu.core.filters import filter_alignment_by_metrics, pseudoalign
from nimble_tpu.index.build import KmerIndex
from nimble_tpu.models.aligner import DEFAULT_BUCKETS, batch_entropy
from nimble_tpu.ops.engine_fast import unpack_full_packed
from nimble_tpu.parallel.sharded_fast import (
    build_sharded_bucketed_index,
    make_sharded_fast_step,
    sharded_device_arrays,
)


class _BidxShim:
    """Just enough of BucketedDeviceIndex for FastCounter's combo decode."""

    def __init__(self, postings_row_flat: np.ndarray):
        self.postings_row = postings_row_flat


def default_mesh(data: int, model: int) -> jax.sharding.Mesh:
    """A (data, model) mesh over the local devices, with Auto axis types:
    the kernels rely on the compiler to place the gathers of replicated
    tables by data-sharded indices, which Explicit axes (``make_mesh``'s
    default) refuse to resolve."""
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(auto, auto))


class MeshAlignEngine:
    """Data × model sharded fast engine (see module docstring)."""

    def __init__(
        self,
        index: KmerIndex,
        config: AlignFilterConfig,
        *,
        mesh: Optional[jax.sharding.Mesh] = None,
        n_index_shards: Optional[int] = None,
        c_max: int = 8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        min_batch: int = 64,
        launch_batch: int = 8192,
        pad_launches: Optional[bool] = None,
    ):
        self.index = index
        self.config = config
        self.c_max = int(c_max)
        self.buckets = tuple(sorted(buckets))
        self.min_batch = int(min_batch)
        self._launch_batch_per_shard = int(launch_batch)

        if mesh is None:
            n = len(jax.devices())
            model = n_index_shards or (2 if n % 2 == 0 and n > 1 else 1)
            data = n // model
            mesh = default_mesh(data, model)
        self.mesh = mesh
        self.data_shards = mesh.shape["data"]
        model_shards = mesh.shape["model"]
        # explicit override for the backend-default launch padding (the
        # multichip dryrun exercises the padding discipline on CPU meshes)
        if pad_launches is None:
            pad_launches = jax.default_backend() != "cpu"
        self._pad_launches = bool(pad_launches)

        # degenerate 1x1 mesh: single chip, no partitioning — delegate to
        # the single-chip engine so no shard_map/collective machinery is
        # paid (bit-equality with the sharded step is tested across mesh
        # shapes including 1x1, tests/test_sharded.py)
        self._delegate = None
        if self.data_shards == 1 and model_shards == 1:
            from nimble_tpu.models.aligner import DeviceAlignEngine

            self._delegate = DeviceAlignEngine(
                index, config, c_max=c_max, buckets=buckets,
                min_batch=min_batch, launch_batch=launch_batch,
                pad_launches=pad_launches,
            )
            self.bidx = self._delegate.bidx
            return

        self.sbidx = build_sharded_bucketed_index(index, model_shards)
        self.bidx = _BidxShim(self.sbidx.postings_row_flat)
        self._dev = sharded_device_arrays(self.sbidx)
        self._steps: dict = {}
        self._s_min_cache: dict = {}
        self._s_min_dev_cache: dict = {}

    # --- shared helpers (mirror DeviceAlignEngine) ------------------------

    _s_min_table = None  # assigned below to avoid duplicating the logic

    def _s_min(self, lmax: int) -> np.ndarray:
        from nimble_tpu.models.aligner import DeviceAlignEngine

        return DeviceAlignEngine._s_min_table(self, lmax)

    def _s_min_dev(self, bucket: int):
        t = self._s_min_dev_cache.get(bucket)
        if t is None:
            t = jnp.asarray(self._s_min(bucket))
            self._s_min_dev_cache[bucket] = t
        return t

    def _step_for(self, bucket: int):
        step = self._steps.get(bucket)
        if step is None:
            cfg = self.config
            step = make_sharded_fast_step(
                self.mesh, self.sbidx, c_max=self.c_max, bucket=bucket,
                score_threshold=int(cfg.score_threshold),
                num_mismatches=int(cfg.num_mismatches),
                discard_multiple=bool(cfg.discard_multiple_matches),
                discard_nonzero=bool(cfg.discard_nonzero_mismatch),
            )
            self._steps[bucket] = step
        return step

    def _pack(self, mat, lens, bucket, B):
        from nimble_tpu.models.aligner import DeviceAlignEngine

        return DeviceAlignEngine._pack_reads(mat, lens, bucket, B)

    def _batch_size(self, m: int) -> int:
        B = max(self.min_batch, 1 << (m - 1).bit_length())
        while B % self.data_shards:
            B *= 2
        return B

    def _launch_B(self, m: int) -> int:
        """Padded batch size (DeviceAlignEngine._launch_B discipline: on
        accelerators every launch uses the fixed launch_batch shape)."""
        lb = self.launch_batch
        if m > lb:
            return ((m + lb - 1) // lb) * lb
        if self._pad_launches:
            return lb
        return min(self._batch_size(m), lb)

    @property
    def launch_batch(self) -> int:
        """Fixed sub-launch size: one compile per bucket on real hardware
        (the single-chip engine's launch discipline, ported to the mesh)."""
        lb = self._launch_batch_per_shard * self.data_shards
        while lb % self.data_shards:
            lb *= 2
        return lb

    # --- compact interface (FastCounter) ----------------------------------

    def compact_dispatch(self, mat: np.ndarray, lens: np.ndarray):
        if self._delegate is not None:
            return self._delegate.compact_dispatch(mat, lens)
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
                    sel, m, bmat, blens = None, n, mat, lens
                else:
                    sel_idx = np.flatnonzero(eligible & (bucket_idx == bi))
                    sel, m = sel_idx, len(sel_idx)
                    bmat, blens = mat[sel_idx], lens[sel_idx]
                lb = self.launch_batch
                B = self._launch_B(m)
                buf = self._pack(bmat, blens, bucket, B)
                step = self._step_for(bucket)
                s_min = self._s_min_dev(bucket)
                if B <= lb:
                    outs = [step(buf, *self._dev, s_min)]
                else:
                    # fixed-size async sub-launches: the lb-read body
                    # compiles once per bucket regardless of chunk size
                    outs = [
                        step(buf[i : i + lb], *self._dev, s_min)
                        for i in range(0, B, lb)
                    ]
                from nimble_tpu.models.aligner import finalize_launch_output

                out_dev = finalize_launch_output(outs)
                launches.append((bucket, sel, m, out_dev, buf, blens))
        return {"n": n, "lens": lens, "needs_host": needs_host,
                "launches": launches}

    def compact_collect(self, state, defer_unresolved: bool = False):
        if self._delegate is not None:
            return self._delegate.compact_collect(
                state, defer_unresolved=defer_unresolved
            )
        n = state["n"]
        astart = np.zeros(n, dtype=np.int64)
        mask = np.zeros(n, dtype=np.int32)
        passed = np.zeros(n, dtype=bool)
        needs_host = state["needs_host"]
        from nimble_tpu.models.aligner import entropy_pass_packed

        for bucket, sel, m, out_dev, buf, blens in state["launches"]:
            packed = np.asarray(out_dev)        # ONE fetch per bucket batch
            flags = packed[:m, 1]
            a = packed[:m, 0].astype(np.int64)
            mk = (flags & 0xFFFF).astype(np.int32)
            nb = (bucket + 3) // 4
            ent_ok = entropy_pass_packed(buf, m, blens, nb)
            ps = ((flags & (1 << 16)) != 0) & ent_ok
            nh = ((flags & (1 << 17)) != 0) & ent_ok
            if sel is None:
                astart[:], mask[:], passed[:], needs_host[:] = a, mk, ps, nh
            else:
                astart[sel], mask[sel] = a, mk
                passed[sel], needs_host[sel] = ps, nh
        result = {"astart": astart, "mask": mask, "passed": passed,
                  "needs_host": needs_host}
        if defer_unresolved:
            result["unresolved"] = np.zeros(n, dtype=bool)
        return result

    def align_raw_compact_from_matrix(self, mat: np.ndarray, lens: np.ndarray):
        return self.compact_collect(self.compact_dispatch(mat, lens))

    def decode_combo(self, astart: int, mask: int) -> List[int]:
        """(global astart, mask) -> sorted distinct eq rows (host-side)."""
        if self._delegate is not None:
            return self._delegate.decode_combo(astart, mask)
        prow = self.sbidx.postings_row_flat
        rows = []
        c = 0
        m = int(mask)
        base = int(astart)
        while m:
            if m & 1:
                rows.append(int(prow[base + c]))
            m >>= 1
            c += 1
        return sorted(set(rows))

    # --- full interface (BAM fast path) ----------------------------------

    EQ_ROW_PAD = np.int64(2**62)

    from nimble_tpu.config import FILTER_REASON_CODE as _REASON_CODE

    def decode_rows_padded(self, keys: np.ndarray, valid=None) -> np.ndarray:
        from nimble_tpu.models.aligner import DeviceAlignEngine

        if self._delegate is not None:
            return self._delegate.decode_rows_padded(keys, valid)
        return DeviceAlignEngine.decode_rows_padded(self, keys, valid)

    def _decode_counts(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        from nimble_tpu.models.aligner import DeviceAlignEngine

        return DeviceAlignEngine._decode_counts(self, keys, valid)

    def full_dispatch(self, mat: np.ndarray, lens: np.ndarray,
                      active: np.ndarray):
        """Full-output dispatch on the mesh (the BAM consumer's alignment):
        same launch discipline as :meth:`compact_dispatch`; the sharded
        step's packed (B, 3) result carries score/mismatches in col 2, so
        one step serves both interfaces."""
        if self._delegate is not None:
            return ("dlg", self._delegate.full_dispatch(mat, lens, active))
        n = mat.shape[0]
        lens = np.asarray(lens, dtype=np.int32)
        act = np.asarray(active, dtype=bool)
        host_rescue = act & (lens > self.buckets[-1])
        eligible = act & (lens >= MIN_READ_LENGTH) & ~host_rescue
        launches = []
        if eligible.any():
            # zero codes beyond the (trimmed) length: the packed entropy
            # gate assumes zero padding
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
                m = len(sel)
                lb = self.launch_batch
                B = self._launch_B(m)
                buf = self._pack(mat_z[sel], lens[sel], bucket, B)
                step = self._step_for(bucket)
                s_min = self._s_min_dev(bucket)
                if B <= lb:
                    outs = [step(buf, *self._dev, s_min)]
                else:
                    outs = [
                        step(buf[i : i + lb], *self._dev, s_min)
                        for i in range(0, B, lb)
                    ]
                launches.append((sel, m, outs, buf, bucket))
        return {"n": n, "mat": mat, "lens": lens, "active": act,
                "host_rescue": host_rescue, "launches": launches}

    def full_collect(self, state):
        """Fetch + exact host gates (borrows DeviceAlignEngine.full_collect
        after translating the sharded flag layout to the full layout)."""
        from nimble_tpu.models.aligner import DeviceAlignEngine

        if isinstance(state, tuple) and state[0] == "dlg":
            return self._delegate.full_collect(state[1])
        launches = []
        for sel, m, outs, buf, bucket in state["launches"]:
            raw = np.asarray(
                outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
            )
            col1 = raw[:, 1]
            # sharded: mask | passed<<16 | needs_host<<17 | has_anchor<<18
            # full:    mask | has_anchor<<16 | overflow<<17
            full_col1 = (
                (col1 & 0xFFFF)
                | (((col1 >> 18) & 1) << 16)
                | (((col1 >> 17) & 1) << 17)
            )
            conv = np.stack([raw[:, 0], full_col1, raw[:, 2]], axis=1)
            launches.append((sel, m, conv, buf, bucket))
        lib_state = dict(state)
        lib_state["launches"] = launches
        return DeviceAlignEngine.full_collect(self, lib_state)

    # --- forensic interface ------------------------------------------------

    def align_batch(self, seqs: Sequence[Optional[np.ndarray]]):
        """Per-read (AlignmentScore, Filter) tuples via the sharded kernel.

        Distinct eq identity comes from the compact (astart, mask) pair; raw
        score/mismatches ride in col 2 of the packed result.
        """
        if self._delegate is not None:
            return self._delegate.align_batch(seqs)
        n = len(seqs)
        results: list = [(None, None)] * n
        cfg = self.config

        device_idx = []
        for i, s in enumerate(seqs):
            if s is None:
                continue
            if len(s) < MIN_READ_LENGTH:
                results[i] = (None, (FilterReason.SHORT_READ, 0.0, 0))
                continue
            if len(s) > self.buckets[-1]:
                results[i] = pseudoalign(s, self.index, cfg, MIN_READ_LENGTH)
                continue
            device_idx.append(i)
        if not device_idx:
            return results

        by_bucket: dict = {}
        for i in device_idx:
            L = len(seqs[i])
            bucket = next(b for b in self.buckets if b >= L)
            by_bucket.setdefault(bucket, []).append(i)

        for bucket, idxs in by_bucket.items():
            m = len(idxs)
            lb = self.launch_batch
            B = self._launch_B(m)
            reads = np.zeros((B, bucket), dtype=np.int8)
            blens = np.zeros(B, dtype=np.int32)
            for j, i in enumerate(idxs):
                reads[j, : len(seqs[i])] = seqs[i]
                blens[j] = len(seqs[i])
            buf = self._pack(reads[:m], blens[:m], bucket, B)
            step = self._step_for(bucket)
            s_min = self._s_min_dev(bucket)
            if B <= lb:
                outs = [step(buf, *self._dev, s_min)]
            else:
                outs = [
                    step(buf[i : i + lb], *self._dev, s_min)
                    for i in range(0, B, lb)
                ]
            out = np.asarray(
                outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
            )
            flags = out[:m, 1]
            a = out[:m, 0].astype(np.int64)
            mk = (flags & 0xFFFF).astype(np.int32)
            has_anchor = (flags & (1 << 18)) != 0
            # needs_host covers both postings overflow and the entropy
            # boundary band; the host oracle resolves either exactly
            nh = (flags & (1 << 17)) != 0
            score = (out[:m, 2] >> 16).astype(np.int32)
            mm = (out[:m, 2] & 0xFFFF).astype(np.int32)

            ent = batch_entropy(reads[:m], blens[:m])
            for j, i in enumerate(idxs):
                s = seqs[i]
                if ent[j] < MIN_ENTROPY_SCORE:
                    results[i] = (None, (FilterReason.HIGH_ENTROPY, 0.0, 0))
                    continue
                if nh[j]:
                    results[i] = pseudoalign(s, self.index, cfg, MIN_READ_LENGTH)
                    continue
                if not has_anchor[j]:
                    results[i] = (None, (FilterReason.NO_MATCH, 0.0, 0))
                    continue
                eq = self.decode_combo(int(a[j]), int(mk[j]))
                sc = int(score[j])
                normalized = sc / len(s)  # f64 (`src/align.rs:968`)
                if cfg.discard_nonzero_mismatch and int(mm[j]) != 0:
                    results[i] = (
                        None, (FilterReason.DISCARDED_NONZERO_MISMATCH, 0.0, 0)
                    )
                    continue
                results[i] = filter_alignment_by_metrics(
                    eq, sc, normalized,
                    cfg.score_threshold, cfg.score_percent,
                    cfg.discard_multiple_matches, cfg.num_mismatches, int(mm[j]),
                )
        return results
