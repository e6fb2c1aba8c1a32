"""Same-process ABBA A/B for the threaded BAM pipeline.

One process, one synthetic BAM, one engine; the chosen knob alternates
per timed run in ABBA order so machine drift cancels.

    python scripts/ab_bam_inproc.py --knob batch --a 16384 --b 49152
    python scripts/ab_bam_inproc.py --knob cores --a 3 --b 4
    python scripts/ab_bam_inproc.py --knob gzip --a 6 --b 1
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", required=True,
                    choices=["batch", "cores", "gzip", "dispatch", "prefetch",
                             "gilswitch", "eager"])
    ap.add_argument("--a", type=int, required=True)
    ap.add_argument("--b", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--groups", type=int, default=16384)
    args = ap.parse_args()

    from bench import build_workload
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.pipeline.bam_fast import process_fast

    index, reference, cfg, _, _ = build_workload(n_reads=1)
    engine = DeviceAlignEngine(index, cfg)
    feats = reference.columns[1][0::2]

    td = tempfile.mkdtemp()
    bam = f"{td}/ab.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    print(f"BAM: {n_records} records / {args.groups} groups", flush=True)

    def run_once(val: int) -> float:
        batch, cores, gz = 16384, 3, None
        if args.knob == "batch":
            batch = val
        elif args.knob == "cores":
            cores = val
        elif args.knob == "gzip":
            gz = val
        if gz is not None:
            os.environ["NIMBLE_GZIP_LEVEL"] = str(gz)
        else:
            os.environ.pop("NIMBLE_GZIP_LEVEL", None)
        # dispatch: 0 = inline (default), 1 = NIMBLE_DISPATCH=worker
        # (read at submit_transaction call time, so runtime toggling works)
        if args.knob == "dispatch":
            if val:
                os.environ["NIMBLE_DISPATCH"] = "worker"
            else:
                os.environ.pop("NIMBLE_DISPATCH", None)
        if args.knob == "prefetch":
            os.environ["NIMBLE_BAM_PREFETCH"] = str(val)
        if args.knob == "eager":
            os.environ["NIMBLE_BAM_EAGER"] = str(val)
        if args.knob == "gilswitch":
            # value in MICROseconds; 0 -> interpreter default (5 ms)
            os.environ["NIMBLE_GIL_SWITCH"] = (
                str(val / 1e6) if val else "")
            if not val:
                import sys as _sys

                _sys.setswitchinterval(0.005)
        out = f"{td}/out.tsv.gz"
        if os.path.exists(out):
            os.unlink(out)
        t0 = time.time()
        process_fast([bam], [engine], [reference], [cfg], [out],
                     num_cores=cores, force_bam_paired=False,
                     batch_records=batch)
        return time.time() - t0

    for name, val in (("A", args.a), ("B", args.b)):
        print(f"warmup {name}: {run_once(val):.3f}s", flush=True)

    base = ["A", "B", "B", "A"]
    sched = (base * ((args.rounds + 3) // 4))[: args.rounds]
    res = {"A": [], "B": []}
    for name in sched:
        val = args.a if name == "A" else args.b
        dt = run_once(val)
        res[name].append(dt)
        print(f"{name}({val}): {dt:.3f}s -> {n_records/dt:,.0f} rec/s",
              flush=True)

    for name in ("A", "B"):
        ts = np.array(res[name])
        val = args.a if name == "A" else args.b
        print(f"{name} ({args.knob}={val}): n={len(ts)} "
              f"best={n_records/ts.min():,.0f} "
              f"median={n_records/np.median(ts):,.0f} rec/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
