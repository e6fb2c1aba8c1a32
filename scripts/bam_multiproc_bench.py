"""2-process BAM throughput vs single process on one host.

The single-process BAM fast pipeline is GIL-bound on the 4-core host
(a 4-core host reached ~1.7 cores of parallelism).  The framework
already shards BAM work across coordinated processes by contiguous
group ranges (`--num-processes`, round 2); two processes dodge the GIL
entirely.  This measures that, CPU backend held constant across both
arms (children set JAX_PLATFORMS=cpu like the multihost FASTQ
bench; the BAM device work is a small share of the wall).

    python scripts/bam_multiproc_bench.py [--groups 16384] [--rounds 3]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, "/root/repo")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    from bench import build_workload
    from nimble_tpu.io.synth import make_synthetic_bam

    _, reference, _, _, _ = build_workload(n_reads=1)
    feats = reference.columns[1][0::2]
    td = tempfile.mkdtemp()
    bam = f"{td}/mp.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    lib = f"{td}/lib.json"
    with open(lib, "w") as f:
        json.dump([
            {"score_percent": 0.33, "score_filter": 25,
             "score_threshold": 50, "num_mismatches": 1,
             "discard_multiple_matches": False,
             "require_valid_pair": False, "discard_multi_hits": 0,
             "intersect_level": 0, "max_hits_to_report": 10,
             "group_on": "", "trim_target_length": 0,
             "trim_strictness": 0.5},
            {"headers": ["sequence_name", "sequence"],
             "columns": [[f"f{i}" for i in range(len(feats))],
                         list(feats)]},
        ], f)
    print(f"BAM: {n_records} records / {args.groups} groups", flush=True)

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run_single() -> float:
        out = f"{td}/s.tsv.gz"
        if os.path.exists(out):
            os.unlink(out)
        t0 = time.time()
        rc = subprocess.run(
            [sys.executable, "-m", "nimble_tpu.cli", "-r", lib,
             "-i", bam, "-o", out],
            env=env, capture_output=True, timeout=600,
        )
        assert rc.returncode == 0, rc.stderr.decode()[-500:]
        return time.time() - t0

    def run_multi() -> float:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        outs = [f"{td}/m{h}.tsv.gz" for h in range(2)]
        for o in outs:
            if os.path.exists(o):
                os.unlink(o)
        t0 = time.time()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "nimble_tpu.cli", "-r", lib,
                 "-i", bam, "-o", outs[h],
                 "--num-processes", "2", "--process-id", str(h),
                 "--coordinator", f"127.0.0.1:{port}"],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE,
            )
            for h in range(2)
        ]
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err.decode()[-500:]
        return time.time() - t0

    print(f"warmup single: {run_single():.2f}s  "
          f"multi: {run_multi():.2f}s", flush=True)
    t1 = min(run_single() for _ in range(args.rounds))
    t2 = min(run_multi() for _ in range(args.rounds))
    print(f"single process : {t1:.2f}s -> {n_records/t1:,.0f} rec/s",
          flush=True)
    print(f"2 processes    : {t2:.2f}s -> {n_records/t2:,.0f} rec/s "
          f"(x{t1/t2:.2f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
