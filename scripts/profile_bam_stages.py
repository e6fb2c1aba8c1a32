"""One-process BAM stage profile: NIMBLE_TIMING splits over N rounds.

Prints, per round, the producer read time, each consumer's
prepare/collect/finish/queue-wait, and logger gzip time — the raw material
for deciding which stage is the wall on the current machine.

    python scripts/profile_bam_stages.py --rounds 4 [--groups 16384]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, "/root/repo")

os.environ["NIMBLE_TIMING"] = "1"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--groups", type=int, default=16384)
    ap.add_argument("--cores", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16384)
    args = ap.parse_args()

    from bench import build_workload
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.pipeline.bam_fast import process_fast

    index, reference, cfg, _, _ = build_workload(n_reads=1)
    engine = DeviceAlignEngine(index, cfg)
    feats = reference.columns[1][0::2]

    td = tempfile.mkdtemp()
    bam = f"{td}/prof.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    print(f"BAM: {n_records} records / {args.groups} groups", flush=True)

    import contextlib
    import io as _io

    def run_once() -> float:
        out = f"{td}/out.tsv.gz"
        if os.path.exists(out):
            os.unlink(out)
        t0 = time.time()
        with contextlib.redirect_stdout(_io.StringIO()):
            process_fast([bam], [engine], [reference], [cfg], [out],
                         num_cores=args.cores, force_bam_paired=False,
                         batch_records=args.batch)
        return time.time() - t0

    print(f"warmup: {run_once():.3f}s", flush=True)
    for r in range(args.rounds):
        c0 = time.process_time()
        dt = run_once()
        cpu = time.process_time() - c0
        print(f"round {r}: {dt:.3f}s wall, {cpu:.3f}s process-CPU "
              f"({cpu/dt:.2f} cores) -> {n_records/dt:,.0f} rec/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
