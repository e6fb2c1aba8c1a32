#!/usr/bin/env python
"""Producer-only decomposition of the BAM fast path.

When the NIMBLE_TIMING split shows the producer (ColumnarGroupStream) as
the BAM pipeline's wall (consumers starve), this finds the stage.
This times its stages standalone on the bench workload, no device, no
consumers:

  inflate      — BGZF decompress only (BgzfFile.read drain)
  + scan       — nimble_bam_scan over the decompressed chunks
  + meta       — nimble_bam_meta (38 fields, tags, seq2)
  + filters    — the Python keep/filter/_Col copies in _scan_chunk
  full stream  — ColumnarGroupStream.batches(16384) drained

Usage: python scripts/profile_bam_producer.py [--groups 16384]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np

    from bench import build_workload
    from nimble_tpu import native
    from nimble_tpu.io.bam import open_bgzf
    from nimble_tpu.io.bam_columnar import ColumnarGroupStream, read_bam_header
    from nimble_tpu.io.synth import make_synthetic_bam

    index, reference, cfg, _, _ = build_workload(n_reads=1)
    feats = reference.columns[1][0::2]
    td = tempfile.mkdtemp()
    bam = f"{td}/bench.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    print(f"{n_records} records, {os.path.getsize(bam)/1e6:.1f} MB BAM")

    def best(fn):
        b = 1e9
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            b = min(b, time.perf_counter() - t0)
        return b

    CHUNK = 4 << 20

    def inflate_only():
        f = open_bgzf(bam)
        read_bam_header(f)
        while f.read(CHUNK):
            pass
        f.close()

    t = best(inflate_only)
    print(f"inflate      : {t:6.3f}s ({n_records/t:10,.0f} rec/s)")

    def with_scan(run_meta=False, run_filters=False):
        f = open_bgzf(bam)
        read_bam_header(f)
        tail = b""
        pool: dict = {}
        while True:
            chunk = f.read(CHUNK)
            data = tail + chunk
            if not data:
                break
            res = native.bam_scan(data, len(data) // 36 + 1, pool=pool)
            (count, consumed, fixed, qname, seq, qual, aux, _cig) = res
            tail = data[consumed:]
            if count == 0:
                if not chunk:
                    break
                continue
            if run_meta:
                cols = native.bam_meta(count, fixed, qname, seq, qual, aux,
                                       pool=pool)
                if run_filters:
                    oflags = cols["oflags"]
                    keep = ((oflags & 4) != 0)
                    from nimble_tpu.io.bam_columnar import _COLS, _Col

                    for name in _COLS:
                        if name == "qname_raw":
                            offs, flat = qname
                        else:
                            offs, flat = cols[name]
                        offs = offs[: count + 1]
                        col = _Col(
                            np.ascontiguousarray(offs, dtype=np.int64),
                            flat[: offs[-1]],
                        )
                        col.filter(keep)
            if not chunk:
                break
        f.close()

    t = best(lambda: with_scan(False))
    print(f"+ scan       : {t:6.3f}s ({n_records/t:10,.0f} rec/s)")
    t = best(lambda: with_scan(True))
    print(f"+ meta       : {t:6.3f}s ({n_records/t:10,.0f} rec/s)")
    t = best(lambda: with_scan(True, True))
    print(f"+ filters    : {t:6.3f}s ({n_records/t:10,.0f} rec/s)")

    def full_stream():
        s = ColumnarGroupStream(bam, False)
        for _b in s.batches(16384):
            pass

    t = best(full_stream)
    print(f"full stream  : {t:6.3f}s ({n_records/t:10,.0f} rec/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
