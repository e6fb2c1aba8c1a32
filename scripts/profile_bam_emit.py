"""Standalone producer-half profile: ColumnarGroupStream.batches() only.

No device work, no consumers — times the scan half (via prefetch-off
inline calls) and the emission half (bam_runs + _add_emitted + emit_ready)
with per-phase counters, on the bench's synthetic BAM.  Pure host work, so
this runs identically with or without an accelerator.

    python scripts/profile_bam_emit.py [--groups 16384] [--rounds 3]
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, "/root/repo")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the emission half of one round")
    ap.add_argument("--prefetch", default="1")
    args = ap.parse_args()

    os.environ["NIMBLE_BAM_PREFETCH"] = args.prefetch

    import numpy as np  # noqa: F401

    from bench import build_workload
    from nimble_tpu.io.bam_columnar import ColumnarGroupStream
    from nimble_tpu.io.synth import make_synthetic_bam

    _, reference, _, _, _ = build_workload(n_reads=1)
    feats = reference.columns[1][0::2]
    td = tempfile.mkdtemp()
    bam = f"{td}/emit.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    print(f"BAM: {n_records} records / {args.groups} groups", flush=True)

    import contextlib

    def run_once() -> float:
        stream = ColumnarGroupStream(bam, False)
        t0 = time.time()
        n = 0
        with contextlib.redirect_stdout(io.StringIO()):
            for b in stream.batches(args.batch):
                n += len(b)
        dt = time.time() - t0
        assert n == n_records or n == n_records - 8, n
        return dt

    for r in range(args.rounds):
        dt = run_once()
        print(f"round {r}: {dt:.3f}s -> {n_records/dt:,.0f} rec/s "
              f"(producer only)", flush=True)

    if args.profile:
        os.environ["NIMBLE_BAM_PREFETCH"] = "0"
        pr = cProfile.Profile()
        pr.enable()
        run_once()
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
        print(s.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
