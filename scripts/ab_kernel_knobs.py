#!/usr/bin/env python
"""Same-window A/B of full-kernel time across import-time kernel knobs.

Each configuration runs in a SUBPROCESS (the knobs are read at import) that
times the full 8192x96 kernel with async-batched launches on a
device-resident buffer and prints one number; this parent interleaves the
configs twice to catch drift.

Usage: python scripts/ab_kernel_knobs.py
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
import jax, jax.numpy as jnp
from functools import partial
from bench import build_workload
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.ops import engine_fast as ef

index, reference, cfg, mat, lens = build_workload(n_reads=8192)
eng = DeviceAlignEngine(index, cfg)
bucket, B = 96, 8192
bidx, dev = eng.bidx, eng._dev_fast
s_min = eng._s_min_dev(bucket)
thr, nmm, dm, dn = eng._dev_scalars
kw = dict(k=bidx.k, max_probe=bidx.max_probe, c_max=eng.c_max,
          bucket_mask=bidx.n_buckets - 1, p_limit=bucket - bidx.k + 1,
          ref_pad=bidx.ref_pad)
buf_dev = jax.device_put(jnp.asarray(
    DeviceAlignEngine._pack_reads(mat, lens, bucket, B)))
full = partial(
    ef.probe_walk_filter_packed,
    bkey_lo=dev["bkey_lo"], bkey_hi=dev["bkey_hi"], bkey_fp=dev["bkey_fp"],
    bstart=dev["bstart"], bcount=dev["bcount"],
    postings_row=dev["postings_row"], postings_off=dev["postings_off"],
    ref_codes_packed=dev["ref_codes_packed"],
    row_starts=dev["row_starts"], row_lengths=dev["row_lengths"],
    s_min_table=s_min, score_threshold=thr, num_mismatches=nmm,
    discard_multiple=dm, discard_nonzero=dn, bucket=bucket,
    walk=os.environ.get("NIMBLE_WALK_AB", "") or "packed", **kw)

@jax.jit
def v_full(packed):
    return full(packed).sum()

@jax.jit
def v_empty(packed):
    return packed[0, 0]

def timed(fn, reps=40):
    jax.block_until_ready(fn(buf_dev))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(buf_dev) for _ in range(reps)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best

te = timed(v_empty)
tf = timed(v_full)
print("RESULT empty=%%.3f full=%%.3f ms" %% (te * 1e3, tf * 1e3), flush=True)
"""


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_src = CHILD % {"repo": repo}
    configs = [
        ("baseline", {}),
        ("lane_t", {"NIMBLE_PROBE_LANE_T": "1"}),
    ]
    for rnd in (1, 2):
        for name, env in configs:
            e = dict(os.environ)
            e.update(env)
            try:
                out = subprocess.run(
                    [sys.executable, "-c", child_src], env=e,
                    capture_output=True, text=True, timeout=420,
                )
                line = [l for l in out.stdout.splitlines()
                        if l.startswith("RESULT")]
                msg = line[0] if line else f"NO RESULT rc={out.returncode} " \
                    + out.stderr.strip()[-200:]
            except subprocess.TimeoutExpired:
                msg = "TIMEOUT"
            print(f"[{rnd}] {name:>20}: {msg}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
