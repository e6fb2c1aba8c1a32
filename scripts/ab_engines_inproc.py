"""Same-process ABBA A/B between two engine/pipeline configurations.

Cross-process bench A/Bs compare two machines' moods as much as two
variants; this harness runs both variants in ONE process with an
ABBA-mirrored round schedule so drift cancels to first order.

    python scripts/ab_engines_inproc.py --knob launch_batch --a 8192 --b 16384
    python scripts/ab_engines_inproc.py --knob chunk --a 131072 --b 262144
    python scripts/ab_engines_inproc.py --knob depth --a 3 --b 5

The probe phase-A boundary is a per-engine STATIC kernel arg since
round 5 (`phase_a_positions`), so it A/Bs in one process too:

    python scripts/ab_engines_inproc.py --knob phase_a --a 8 --b 16
"""

import argparse
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", required=True,
                    choices=["launch_batch", "chunk", "depth", "phase_a"])
    ap.add_argument("--a", type=int, required=True)
    ap.add_argument("--b", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--reads", type=int, default=524288)
    ap.add_argument("--chunk", type=int, default=131072)
    ap.add_argument("--depth", type=int, default=3)
    args = ap.parse_args()

    from bench import build_workload
    from nimble_tpu.core.fast_count import FastCounter
    from nimble_tpu.models.aligner import DeviceAlignEngine

    index, reference, cfg, mat, lens = build_workload(n_reads=args.reads)

    def make_variant(val: int):
        """Returns (engine, chunk, depth) for one knob setting."""
        eng_kw = {}
        chunk, depth = args.chunk, args.depth
        if args.knob == "launch_batch":
            eng_kw["launch_batch"] = val
        elif args.knob == "phase_a":
            eng_kw["phase_a_positions"] = val
        elif args.knob == "chunk":
            chunk = val
        elif args.knob == "depth":
            depth = val
        engine = DeviceAlignEngine(index, cfg, **eng_kw)
        return engine, chunk, depth

    variants = {}
    for name, val in (("A", args.a), ("B", args.b)):
        variants[name] = make_variant(val)

    def run_round(name: str) -> float:
        engine, chunk, depth = variants[name]
        n_chunks = max(1, args.reads // chunk)
        bounds = [
            (i * args.reads // n_chunks, (i + 1) * args.reads // n_chunks)
            for i in range(n_chunks)
        ]
        t0 = time.time()
        counter = FastCounter(engine, reference, cfg)
        pending: list = []
        for lo, hi in bounds:
            pending.append(counter.dispatch_async(mat[lo:hi], lens[lo:hi]))
            if len(pending) >= depth:
                counter.process(pending.pop(0))
        while pending:
            counter.process(pending.pop(0))
        counter.finalize()
        return time.time() - t0

    for name in ("A", "B"):
        dt = run_round(name)
        print(f"warmup {name}: {dt:.3f}s", flush=True)

    base = ["A", "B", "B", "A"]
    sched = (base * ((args.rounds + 3) // 4))[: args.rounds]
    res = {"A": [], "B": []}
    for name in sched:
        dt = run_round(name)
        res[name].append(dt)
        print(f"{name}({args.a if name=='A' else args.b}): {dt:.3f}s -> "
              f"{args.reads/dt:,.0f} reads/s", flush=True)

    for name in ("A", "B"):
        ts = np.array(res[name])
        val = args.a if name == "A" else args.b
        print(f"{name} ({args.knob}={val}): n={len(ts)} "
              f"best={args.reads/ts.min():,.0f} "
              f"median={args.reads/np.median(ts):,.0f} reads/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
