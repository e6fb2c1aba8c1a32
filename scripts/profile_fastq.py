#!/usr/bin/env python
"""Phase-level profile of the FASTQ bench workload on the live backend.

Breaks a bench round into: host packing, device upload, kernel dispatch,
result fetch, and the host counting tail — so optimization effort goes where
the time actually is.
"""
from __future__ import annotations

import os
import sys
import time

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import build_workload  # noqa: E402
from nimble_tpu.core.fast_count import FastCounter  # noqa: E402
from nimble_tpu.models.aligner import DeviceAlignEngine  # noqa: E402
from nimble_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

N_READS = 1 << 17
CHUNK = 1 << 16


def main():
    print("devices:", jax.devices(), flush=True)
    index, reference, cfg, mat, lens = build_workload(n_reads=N_READS)
    engine = DeviceAlignEngine(index, cfg)

    bounds = [(i * CHUNK, (i + 1) * CHUNK) for i in range(N_READS // CHUNK)]

    # --- warmup ---
    t0 = time.perf_counter()
    c = FastCounter(engine, reference, cfg)
    for lo, hi in bounds:
        c.process(c.dispatch(mat[lo:hi], lens[lo:hi]))
    c.finalize()
    print(f"warmup: {time.perf_counter()-t0:.1f}s", flush=True)

    # --- A: isolated upload cost ---
    for trial in range(3):
        t0 = time.perf_counter()
        for lo, hi in bounds:
            x = jax.device_put(mat[lo:hi])
            x.block_until_ready()
        print(f"A upload {mat[0:CHUNK].nbytes*len(bounds)/1e6:.1f}MB: "
              f"{time.perf_counter()-t0:.3f}s", flush=True)

    # --- B: kernel only (device_put'd inputs, fetch 1 element) ---
    reads_dev = []
    for lo, hi in bounds:
        r = np.zeros((CHUNK, 90), dtype=np.int8)
        r[:, :] = mat[lo:hi]
        reads_dev.append((jax.device_put(r), jax.device_put(lens[lo:hi])))
    jax.block_until_ready(reads_dev)
    for trial in range(3):
        t0 = time.perf_counter()
        outs = []
        for rd, ld in reads_dev:
            outs.append(engine._launch_fast_kernel(np.asarray(rd), np.asarray(ld), 90, 8))
        jax.block_until_ready(outs)
        print(f"B kernel+upload(np in): {time.perf_counter()-t0:.3f}s", flush=True)

    # B2: kernel with device-resident inputs
    from nimble_tpu.ops.engine_fast import probe_walk_filter
    def launch_dev(rd, ld, bucket, p_limit):
        cfgd = engine.config
        return probe_walk_filter(
            rd, ld,
            engine._dev_fast["bkey_lo"], engine._dev_fast["bkey_hi"],
            engine._dev_fast["bkey_fp"], engine._dev_fast["bstart"], engine._dev_fast["bcount"],
            engine._dev_fast["postings_row"], engine._dev_fast["postings_off"],
            engine._dev_fast["ref_codes_packed"], engine._dev_fast["row_starts"],
            engine._dev_fast["row_lengths"],
            jnp.asarray(engine._s_min_table(bucket)),
            jnp.int32(cfgd.score_threshold), jnp.int32(cfgd.num_mismatches),
            jnp.bool_(cfgd.discard_multiple_matches), jnp.bool_(cfgd.discard_nonzero_mismatch),
            k=engine.bidx.k, max_probe=engine.bidx.max_probe, c_max=engine.c_max,
            bucket_mask=engine.bidx.n_buckets - 1,
            p_limit=min(p_limit, bucket - engine.bidx.k + 1),
            ref_pad=engine.bidx.ref_pad, walk=engine.walk,
        )
    o = launch_dev(reads_dev[0][0], reads_dev[0][1], 90, 8)
    jax.block_until_ready(o)
    for trial in range(3):
        t0 = time.perf_counter()
        outs = [launch_dev(rd, ld, 90, 8) for rd, ld in reads_dev]
        jax.block_until_ready(outs)
        print(f"B2 kernel only: {time.perf_counter()-t0:.3f}s", flush=True)

    # --- C: fetch cost of the packed result ---
    for trial in range(3):
        t0 = time.perf_counter()
        got = [np.asarray(x) for x in outs]
        print(f"C fetch {sum(g.nbytes for g in got)/1e6:.1f}MB: "
              f"{time.perf_counter()-t0:.3f}s", flush=True)

    # --- D: full round with phase timers ---
    for trial in range(4):
        td = tc = th = 0.0
        t_round = time.perf_counter()
        counter = FastCounter(engine, reference, cfg)
        pending = None
        for lo, hi in bounds:
            t0 = time.perf_counter()
            handle = counter.dispatch(mat[lo:hi], lens[lo:hi])
            td += time.perf_counter() - t0
            if pending is not None:
                t0 = time.perf_counter()
                counter.process(pending)
                th += time.perf_counter() - t0
            pending = handle
        t0 = time.perf_counter()
        counter.process(pending)
        th += time.perf_counter() - t0
        t0 = time.perf_counter()
        res = counter.finalize()
        tf = time.perf_counter() - t0
        total = time.perf_counter() - t_round
        print(f"D round: total={total:.3f}s dispatch={td:.3f}s "
              f"process={th:.3f}s finalize={tf:.3f}s "
              f"-> {N_READS/total:,.0f} reads/s", flush=True)

    # --- E: host tail only (raw precomputed) ---
    raws = []
    for lo, hi in bounds:
        raws.append(engine.align_raw_compact_from_matrix(mat[lo:hi], lens[lo:hi]))
    for trial in range(3):
        counter = FastCounter(engine, reference, cfg)
        t0 = time.perf_counter()
        for (lo, hi), raw in zip(bounds, raws):
            counter._add_with_raw(mat[lo:hi], lens[lo:hi], None, None,
                                  dict(raw), None)
        counter.finalize()
        dt = time.perf_counter() - t0
        print(f"E host tail only: {dt:.3f}s -> {N_READS/dt:,.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
