#!/usr/bin/env python
"""Reference-scale BAM soak.

The reference's real-world fixture is a 427 MB, multi-million-record 10x
BAM (`tests/test-sequences/reads/sample.bam`, git-LFS).  This soak pushes
a synthetic BAM of that class (default 5.24M records / 655,360 UMI
groups) through the fast columnar pipeline end-to-end on the current
backend and asserts:

  * bounded RSS (peak < --rss-cap GiB, sampled every second);
  * monotone progress (the 1M-record progress prints keep advancing);
  * output invariants: row count == pairs - dropped-final-group + header,
    and the gzip member validates end-to-end.

Usage:
  python scripts/soak_bam.py [--groups 655360] [--pairs 4] [--cpu]
                             [--keep-bam PATH] [--rss-cap 8]
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / (1024 * 1024)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=655360)
    ap.add_argument("--pairs", type=int, default=4, help="pairs per group")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--keep-bam", default="/tmp/nimble_soak.bam",
                    help="BAM path (reused if it already exists)")
    ap.add_argument("--rss-cap", type=float, default=8.0, help="GiB")
    ap.add_argument("--cores", type=int, default=4)
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from bench import build_workload
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.pipeline.bam_fast import process_fast

    index, reference, cfg, _, _ = build_workload(n_reads=1)
    feats = reference.columns[1][0::2]

    bam = args.keep_bam
    n_records = 2 * args.pairs * args.groups
    marker = bam + f".{args.groups}x{args.pairs}.ok"
    if not (os.path.exists(bam) and os.path.exists(marker)):
        t0 = time.time()
        got = make_synthetic_bam(
            bam, feats, n_groups=args.groups, pairs_per_group=args.pairs,
            read_len=90, seed=1, mutate_every=5, stream=True,
        )
        assert got == n_records, (got, n_records)
        with open(marker, "w") as f:
            f.write(str(got))
        print(f"generated {got:,} records ({os.path.getsize(bam)/1e6:.0f} MB)"
              f" in {time.time()-t0:.0f}s", flush=True)
    else:
        print(f"reusing {bam}: {n_records:,} records "
              f"({os.path.getsize(bam)/1e6:.0f} MB)", flush=True)

    engine = DeviceAlignEngine(index, cfg)
    out = "/tmp/nimble_soak_out.tsv.gz"
    if os.path.exists(out):
        os.remove(out)

    peak = [rss_gib()]
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            peak[0] = max(peak[0], rss_gib())
            time.sleep(1.0)

    th = threading.Thread(target=sampler, daemon=True)
    th.start()

    t0 = time.time()
    process_fast([bam], [engine], [reference], [cfg], [out], args.cores,
                 False)
    wall = time.time() - t0
    stop.set()
    th.join(timeout=2)

    with gzip.open(out, "rb") as f:
        data = f.read()  # validates CRC32/ISIZE end-to-end
    n_rows = data.count(b"\n")
    expect = args.pairs * args.groups - args.pairs + 1  # -final group +header
    rps = n_records / wall
    print(f"soak: {n_records:,} records in {wall:.1f}s -> {rps:,.0f} rec/s; "
          f"peak RSS {peak[0]:.2f} GiB; rows {n_rows:,} (expect {expect:,})",
          flush=True)
    assert n_rows == expect, (n_rows, expect)
    assert peak[0] < args.rss_cap, f"RSS {peak[0]:.2f} GiB >= cap"
    print("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
