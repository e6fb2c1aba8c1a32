"""Single-pass multi-library device execution.

The reference aligns each library sequentially per chunk/UMI group
(`src/process/fastq.rs:15`, `src/process/bam.rs:315`).  On the device path
every chunk pays a per-launch/per-fetch latency, so N sequential library
passes pay it N times.  This dispatcher
stacks every library's bucketized table (rebuilt at common geometry) plus
its config scalars along a leading library axis and serves ALL libraries in
one vmapped kernel launch per chunk — one upload, one fetch, ~flat cost in
the library count.

Per-library results are handed back in each engine's own combo-id space
(astart indexes that library's postings array), so `FastCounter`'s decode
and the rest of the host tail are unchanged.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

import jax.numpy as jnp

from nimble_tpu.config import MIN_READ_LENGTH
from nimble_tpu.models.aligner import (
    DeviceAlignEngine,
    finalize_launch_output,
)
from nimble_tpu.ops.device_index import build_bucketed_index
from nimble_tpu.ops.engine_fast import (
    probe_walk_filter_packed_multi_chunked,
    probe_walk_full_packed_multi_chunked,
    unpack_compact,
)


class MultiLibraryDispatcher:
    """One vmapped launch per chunk serving every library's engine.

    With ``mesh=`` the launch buffer is sharded over the mesh's ``data``
    axis and the stacked tables are replicated, so GSPMD partitions the
    stacked kernel data-parallel across devices — single-pass
    multi-library on a multi-chip mesh (small custom libraries replicate
    cheaply; DP over reads is the right scaling axis for them).
    Bit-equality with the single-device dispatcher is tested on virtual
    meshes (tests/test_multi_mesh.py)."""

    def __init__(self, engines: Sequence[DeviceAlignEngine], *, mesh=None,
                 phase_a: int = 0):
        if not engines:
            raise ValueError("MultiLibraryDispatcher needs >=1 engine")
        for e in engines:
            if not isinstance(e, DeviceAlignEngine):
                raise ValueError("MultiLibraryDispatcher requires "
                                 "DeviceAlignEngine instances")
        self.engines = list(engines)
        e0 = engines[0]
        self.c_max = e0.c_max
        self.buckets = e0.buckets
        self.min_batch = e0.min_batch
        self.launch_batch = e0.launch_batch
        if not all(e.buckets == self.buckets and e.c_max == self.c_max
                   for e in engines):
            raise ValueError("engines disagree on bucket/c_max geometry")

        # rebuild every library's bucketized table at COMMON geometry
        rebuilt = [
            build_bucketed_index(e.index)
            for e in engines
        ]
        n_buckets = max(b.n_buckets for b in rebuilt)
        if any(b.n_buckets != n_buckets for b in rebuilt):
            rebuilt = [
                build_bucketed_index(e.index, min_buckets=n_buckets)
                for e in engines
            ]
        self.n_buckets = n_buckets
        self.max_probe = max(b.max_probe for b in rebuilt)
        self.k = rebuilt[0].k
        # Per-dispatcher probe boundary (VERDICT r4 item 5): the STACKED
        # kernel defaults to SINGLE-PHASE, unlike the single-library
        # engines' two-phase default (8).  In the N-library mixed
        # workload most reads are foreign to each library and never
        # resolve in phase A, so the per-library compaction + while_loop
        # phase-B machinery runs hot under vmap; probing every position
        # vectorized won a same-process ABBA over 4 libraries
        # (scripts/ab_multilib_inproc.py re-measures it).  Pass phase_a to
        # override.
        self.phase_a = phase_a or (1 << 30)
        self.ref_pad = rebuilt[0].ref_pad
        if not all(b.k == self.k and b.ref_pad == self.ref_pad
                   for b in rebuilt):
            raise ValueError("rebuilt tables disagree on k/ref_pad")
        self.bidxs = rebuilt
        # the per-library combo ids (astart) must decode through each
        # engine's own postings arrays — the postings flattening is
        # independent of the bucket-count override, asserted here
        for e, b in zip(engines, rebuilt):
            if not np.array_equal(e.bidx.postings_row, b.postings_row):
                raise ValueError(
                    "postings flattening changed under the bucket-count "
                    "override; combo ids would not decode")

        def stack(attr, pad_value=0):
            arrs = [getattr(b, attr) for b in rebuilt]
            shape = tuple(
                max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim)
            )
            out = np.full((len(arrs),) + shape, pad_value,
                          dtype=arrs[0].dtype)
            for i, a in enumerate(arrs):
                sl = (i,) + tuple(slice(0, s) for s in a.shape)
                out[sl] = a
            return jnp.asarray(out)

        self._dev = dict(
            bkey_lo=stack("bkey_lo", 0xFFFFFFFF),
            bkey_hi=stack("bkey_hi", 0xFFFFFFFF),
            bkey_fp=stack("bkey_fp", 0),
            bstart=stack("bstart"),
            bcount=stack("bcount"),
            postings_row=stack("postings_row"),
            postings_off=stack("postings_off"),
            ref_codes_packed=stack("ref_codes_packed"),
            row_starts=stack("row_starts"),
            row_lengths=stack("row_lengths", 0),
        )
        self._scalars = (
            jnp.asarray(np.array([e.config.score_threshold for e in engines],
                                 dtype=np.int32)),
            jnp.asarray(np.array([e.config.num_mismatches for e in engines],
                                 dtype=np.int32)),
            jnp.asarray(np.array([e.config.discard_multiple_matches
                                  for e in engines], dtype=bool)),
            jnp.asarray(np.array([e.config.discard_nonzero_mismatch
                                  for e in engines], dtype=bool)),
        )
        self._s_min_cache: dict = {}
        # ONE shared pre-upload dedupe set serves every library: the score
        # map key is the read(+mate) bytes (`src/align.rs:574-579`), which
        # is library-independent, so a duplicate pair is a duplicate for
        # all libraries at once
        from nimble_tpu import native

        self._seen = native.make_dedupe_set()

        self.mesh = mesh
        self._data_shards = 1
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(mesh, PartitionSpec())
            self._dev = {
                k: jax.device_put(np.asarray(v), rep)
                for k, v in self._dev.items()
            }
            self._scalars = tuple(
                jax.device_put(np.asarray(s), rep) for s in self._scalars
            )
            self._data_shards = int(mesh.shape["data"])
            self._buf_sharding = NamedSharding(
                mesh, PartitionSpec(None, "data", None)
            )

    def _place_buf(self, buf3):
        """Device placement for an (n_sub, lb, nb) launch buffer: sharded
        over 'data' on a mesh, plain device array otherwise."""
        if self.mesh is None:
            return jnp.asarray(buf3)
        import jax

        return jax.device_put(buf3, self._buf_sharding)

    def _launch_B(self, m: int) -> int:
        """Padded batch size; on a mesh, rounded up so every sub-launch
        splits evenly over the data axis."""
        B = self.engines[0]._launch_B(m)
        d = self._data_shards
        while B % d:
            B *= 2
        return B

    def dedupe(self, mat, lens, mate_mat=None, mate_lens=None):
        """Drop already-seen read(+mate) pairs before upload (shared across
        libraries).  Returns (mat, lens, mate_mat, mate_lens, prededuped)."""
        from nimble_tpu.core.fast_count import dedupe_admit

        return dedupe_admit(self._seen, mat, lens, mate_mat, mate_lens)

    def _s_min_stack(self, bucket: int):
        t = self._s_min_cache.get(bucket)
        if t is None:
            t = np.stack([e._s_min_table(bucket) for e in self.engines])
            if self.mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec

                t = jax.device_put(t, NamedSharding(self.mesh, PartitionSpec()))
            else:
                t = jnp.asarray(t)
            self._s_min_cache[bucket] = t
        return t

    def dispatch(self, mat: np.ndarray, lens: np.ndarray):
        """Launch one multi-library pass per bucket sub-batch (async)."""
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
                Btot = self._launch_B(m)
                buf = DeviceAlignEngine._pack_reads(bmat, blens, bucket, Btot)
                n_sub = (Btot + lb - 1) // lb
                buf_dev = self._place_buf(
                    buf.reshape(n_sub, min(Btot, lb), buf.shape[1])
                )
                thr, nmm, dm, dn = self._scalars
                outs = [
                    probe_walk_filter_packed_multi_chunked(
                        buf_dev[i : i + 1],
                        self._dev["bkey_lo"], self._dev["bkey_hi"],
                        self._dev["bkey_fp"],
                        self._dev["bstart"], self._dev["bcount"],
                        self._dev["postings_row"], self._dev["postings_off"],
                        self._dev["ref_codes_packed"],
                        self._dev["row_starts"], self._dev["row_lengths"],
                        self._s_min_stack(bucket), thr, nmm, dm, dn,
                        k=self.k, max_probe=self.max_probe, c_max=self.c_max,
                        bucket_mask=self.n_buckets - 1,
                        p_limit=bucket - self.k + 1,
                        ref_pad=self.ref_pad, bucket=bucket,
                        phase_a=self.phase_a,
                    )
                    for i in range(n_sub)
                ]
                out_dev = finalize_launch_output(outs)
                launches.append((bucket, sel, m, out_dev, buf, blens))
        return {"n": n, "lens": lens, "needs_host": needs_host,
                "launches": launches}

    @property
    def uniform_trim(self) -> bool:
        """True when every library shares trim settings — the packed read
        buffer depends on the per-library MAXINFO trim lengths, so ONE
        upload can serve all libraries only in that case."""
        c0 = self.engines[0].config
        return all(
            e.config.trim_target_length == c0.trim_target_length
            and e.config.trim_strictness == c0.trim_strictness
            for e in self.engines
        )

    def full_dispatch(self, mat: np.ndarray, lens: np.ndarray,
                      active: np.ndarray):
        """One stacked full-output launch serving every library (the BAM
        consumer's per-batch alignment).  Requires :attr:`uniform_trim`.
        Returns opaque state for :meth:`full_collect`."""
        if not self.uniform_trim:
            raise ValueError("full_dispatch requires uniform trim settings")
        e0 = self.engines[0]
        n = mat.shape[0]
        lens = np.asarray(lens, dtype=np.int32)
        act = np.asarray(active, dtype=bool)
        host_rescue = act & (lens > self.buckets[-1])
        eligible = act & (lens >= MIN_READ_LENGTH) & ~host_rescue
        launches = []
        if eligible.any():
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
                # pre-upload dedupe, shared across libraries (the packed
                # row is library-independent; see
                # DeviceAlignEngine.full_dispatch)
                from nimble_tpu.models.aligner import dedupe_packed_rows

                buf_all = DeviceAlignEngine._pack_reads(
                    mat_z[sel], lens[sel], bucket, len(sel)
                )
                first, inv = dedupe_packed_rows(buf_all)
                m = len(first)
                B = self._launch_B(m)
                buf = np.zeros((B, buf_all.shape[1]), dtype=np.uint8)
                buf[:m] = buf_all[first]
                n_sub = (B + lb - 1) // lb
                buf_dev = self._place_buf(
                    buf.reshape(n_sub, min(B, lb), buf.shape[1])
                )
                outs = [
                    probe_walk_full_packed_multi_chunked(
                        buf_dev[i : i + 1],
                        self._dev["bkey_lo"], self._dev["bkey_hi"],
                        self._dev["bkey_fp"],
                        self._dev["bstart"], self._dev["bcount"],
                        self._dev["postings_row"], self._dev["postings_off"],
                        self._dev["ref_codes_packed"],
                        self._dev["row_starts"], self._dev["row_lengths"],
                        k=self.k, max_probe=self.max_probe, c_max=self.c_max,
                        bucket_mask=self.n_buckets - 1,
                        p_limit=bucket - self.k + 1,
                        ref_pad=self.ref_pad, bucket=bucket,
                        phase_a=self.phase_a,
                    )
                    for i in range(n_sub)
                ]
                out_dev = finalize_launch_output(outs)
                launches.append((sel, m, out_dev, buf, bucket, inv))
        return {"n": n, "mat": mat, "lens": lens, "active": act,
                "host_rescue": host_rescue, "launches": launches}

    def full_collect(self, state) -> List[dict]:
        """ONE fetch; per-library full results via each engine's exact host
        gates (`DeviceAlignEngine.full_collect` on that library's slice)."""
        L = len(self.engines)
        # fetch each bucket batch once: (n_sub, L, lb, 3)
        raws = [
            np.asarray(launch[2]) for launch in state["launches"]
        ]
        results = []
        for li, e in enumerate(self.engines):
            lib_state = dict(state)
            lib_state["launches"] = [
                (sel, m, np.ascontiguousarray(raw[:, li]), buf, bucket, inv)
                for (sel, m, _out, buf, bucket, inv), raw
                in zip(state["launches"], raws)
            ]
            results.append(e.full_collect(lib_state))
        return results

    def collect(self, state) -> List[dict]:
        """One fetch; per-library compact raw dicts (FastCounter format)."""
        n = state["n"]
        L = len(self.engines)
        outs = [
            {
                "astart": np.zeros(n, dtype=np.int64),
                "mask": np.zeros(n, dtype=np.int32),
                "passed": np.zeros(n, dtype=bool),
                "needs_host": state["needs_host"].copy(),
            }
            for _ in range(L)
        ]
        from nimble_tpu.models.aligner import entropy_pass_packed

        for bucket, sel, m, out_dev, buf, blens in state["launches"]:
            # (n_sub, L, lb, 2): one fetch per bucket batch
            raw = np.asarray(out_dev)
            raw = np.swapaxes(raw, 0, 1).reshape(L, -1, raw.shape[-1])
            nb = (bucket + 3) // 4
            ent_ok = entropy_pass_packed(buf, m, blens, nb)
            for li in range(L):
                out = unpack_compact(raw[li])
                dst = outs[li]
                ps = out["passed"][:m] & ent_ok
                nh = out["needs_host"][:m] & ent_ok
                if sel is None:
                    dst["astart"][:] = out["astart"][:m]
                    dst["mask"][:] = out["mask"][:m]
                    dst["passed"][:] = ps
                    dst["needs_host"][:] = nh
                else:
                    dst["astart"][sel] = out["astart"][:m]
                    dst["mask"][sel] = out["mask"][:m]
                    dst["passed"][sel] = ps
                    dst["needs_host"][sel] = nh
        return outs
