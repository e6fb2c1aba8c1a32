#!/usr/bin/env python
"""In-process same-window A/B of BAM pipeline knobs.

One synthetic BAM + one engine (compiles once), then interleaved timed runs
across (num_cores, gzip level, prefetch) configurations — avoids paying the
per-invocation warmup of serial bench.py A/Bs and lets drift cancel.

Usage: python scripts/ab_bam_knobs.py [--groups 16384] [--rounds 2]
"""

from __future__ import annotations

import argparse
import contextlib
import io as _io
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from nimble_tpu.utils import compile_cache

    compile_cache.enable()

    from bench import build_workload
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.pipeline.bam_fast import process_fast

    index, reference, cfg, _, _ = build_workload(n_reads=1)
    engine = DeviceAlignEngine(index, cfg)
    feats = reference.columns[1][0::2]
    td = tempfile.mkdtemp()
    bam = f"{td}/bench.bam"
    n_records = make_synthetic_bam(
        bam, feats, n_groups=args.groups, pairs_per_group=4,
        read_len=90, seed=1, mutate_every=5,
    )
    print(f"{n_records} records / {args.groups} groups", flush=True)

    def run(cores, gzip_level, prefetch, out, pipe=False):
        env = {"NIMBLE_GZIP_LEVEL": str(gzip_level),
               "NIMBLE_BAM_PREFETCH": "1" if prefetch else "0",
               "NIMBLE_BAM_PIPE": "1" if pipe else ""}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with contextlib.redirect_stdout(_io.StringIO()):
                process_fast([bam], [engine], [reference], [cfg], [out],
                             cores, False)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    run(4, 6, False, f"{td}/warm.tsv.gz")  # compiles

    configs = [
        ("cores4 gz6", 4, 6, False, False),
        ("cores3 gz6", 3, 6, False, False),
        ("cores3 gz1", 3, 1, False, False),
        ("cores3 gz6 pipe", 3, 6, False, True),
        ("cores2 gz6 pipe", 2, 6, False, True),
        ("cores2 gz1 pipe", 2, 1, False, True),
    ]
    best = {}
    for rnd in range(args.rounds):
        for name, c, gl, pf, pipe in configs:
            t0 = time.perf_counter()
            run(c, gl, pf, f"{td}/out.tsv.gz", pipe)
            dt = time.perf_counter() - t0
            best[name] = min(best.get(name, 1e9), dt)
            print(f"[{rnd}] {name:>16}: {dt:6.2f}s "
                  f"({n_records/dt:9,.0f} rec/s)", flush=True)
    print("\nbest-of:")
    for name, _, _, _, _ in configs:
        print(f"{name:>16}: {n_records/best[name]:9,.0f} rec/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
