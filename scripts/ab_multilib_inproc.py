"""Same-process ABBA A/B on the 4-library single-pass dispatcher.

Two kernel defaults shape the multi-library x4 run: the 92 read bucket
(90 bp reads pack to 23 B rows instead of 24) and the two-phase probe
boundary.  The bucket set is a constructor knob, so it A/Bs in one
process; phase_a is a per-engine static arg (models/aligner.py
`phase_a`), so it A/Bs in one process too.

    python scripts/ab_multilib_inproc.py --knob bucket92 [--rounds 8]
    python scripts/ab_multilib_inproc.py --knob phase_a --a 8 --b 16
"""

import argparse
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", required=True, choices=["bucket92", "phase_a"])
    ap.add_argument("--a", type=int, default=1)
    ap.add_argument("--b", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--reads", type=int, default=524288)
    ap.add_argument("--chunk", type=int, default=131072)
    ap.add_argument("--libraries", type=int, default=4)
    args = ap.parse_args()

    from concurrent.futures import ThreadPoolExecutor

    from bench import build_workload
    from nimble_tpu import native
    from nimble_tpu.core.fast_count import FastCounter
    from nimble_tpu.models.aligner import DEFAULT_BUCKETS, DeviceAlignEngine
    from nimble_tpu.models.multi_aligner import MultiLibraryDispatcher
    from nimble_tpu.pipeline.fastq_pipeline import _dispatch_multi

    L = args.libraries
    workloads = [build_workload(n_reads=args.reads, seed=s) for s in range(L)]
    refs = [w[1] for w in workloads]
    cfgs = [w[2] for w in workloads]
    per = args.reads // L
    mat = np.concatenate([w[3][:per] for w in workloads])
    lens = np.concatenate([w[4][:per] for w in workloads])
    n_reads = len(mat)

    no92 = tuple(b for b in DEFAULT_BUCKETS if b != 92)

    def make_variant(val: int):
        kw = {}
        if args.knob == "bucket92":
            kw["buckets"] = DEFAULT_BUCKETS if val else no92
        elif args.knob == "phase_a":
            kw["phase_a_positions"] = val
        engines = [
            DeviceAlignEngine(w[0], w[2], **kw) for w in workloads
        ]
        return MultiLibraryDispatcher(engines), engines

    variants = {}
    for name, val in (("A", args.a), ("B", args.b)):
        variants[name] = make_variant(val)

    fetcher = ThreadPoolExecutor(max_workers=1)
    dispatcher = ThreadPoolExecutor(max_workers=1)
    n_chunks = max(1, n_reads // args.chunk)
    bounds = [
        (i * n_reads // n_chunks, (i + 1) * n_reads // n_chunks)
        for i in range(n_chunks)
    ]

    def run_round(name: str) -> float:
        multi, engines = variants[name]
        multi._seen = native.make_dedupe_set()
        counters = [FastCounter(engines[i], refs[i], cfgs[i])
                    for i in range(L)]
        t0 = time.time()
        pending = None

        def drain(p):
            pmat, plens, _, _, fut, pdd = p.result()
            if not pmat.shape[0]:
                return
            for counter, raw in zip(counters, fut.result()):
                counter._add_with_raw(pmat, plens, None, None, raw, None,
                                      prededuped=pdd)

        for lo, hi in bounds:
            fut = dispatcher.submit(
                _dispatch_multi, multi, fetcher, mat[lo:hi], lens[lo:hi],
                None, None,
            )
            if pending is not None:
                drain(pending)
            pending = fut
        drain(pending)
        res = [c.finalize() for c in counters]
        dt = time.time() - t0
        assert all(len(r) for r in res)
        return dt

    for name in ("A", "B"):
        print(f"warmup {name}: {run_round(name):.3f}s", flush=True)

    base = ["A", "B", "B", "A"]
    sched = (base * ((args.rounds + 3) // 4))[: args.rounds]
    res = {"A": [], "B": []}
    for name in sched:
        dt = run_round(name)
        res[name].append(dt)
        print(f"{name}: {dt:.3f}s -> {n_reads/dt:,.0f} reads/s", flush=True)
    for name in ("A", "B"):
        ts = np.array(res[name])
        val = args.a if name == "A" else args.b
        print(f"{name} ({args.knob}={val}): best={n_reads/ts.min():,.0f} "
              f"median={n_reads/np.median(ts):,.0f} reads/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
