#!/usr/bin/env python
"""Long-running randomized differential campaign: every device engine path
must equal the pinned host oracle (`core/walk.py` + `core/filters.py`) on
generated corpora far broader than the CI adversarial tests.

Usage: python scripts/fuzz_differential.py [--minutes 30] [--seed 0]
Prints one line per trial block; exits nonzero on the first divergence with
a reproducer (seed, trial)."""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from nimble_tpu.config import AlignFilterConfig  # noqa: E402
from nimble_tpu.core.calls import HostAlignEngine  # noqa: E402
from nimble_tpu.index.build import build_index  # noqa: E402
from nimble_tpu.models.aligner import DeviceAlignEngine  # noqa: E402
from nimble_tpu.utils.dna import encode_bases, revcomp  # noqa: E402

BASES = np.array(list("ACGT"))


def rand_seq(rng, n):
    return "".join(rng.choice(BASES, size=n))


def make_library(rng):
    """Random library shapes, biased toward the nasty cases."""
    style = int(rng.integers(0, 5))
    feats = []
    if style == 0:  # plain random
        for _ in range(int(rng.integers(2, 10))):
            feats.append(rand_seq(rng, int(rng.integers(35, 400))))
    elif style == 1:  # heavy shared k-mer blocks (anchor ties, c_max stress)
        block = rand_seq(rng, int(rng.integers(30, 60)))
        for _ in range(int(rng.integers(3, 14))):
            feats.append(
                rand_seq(rng, int(rng.integers(0, 40))) + block
                + rand_seq(rng, int(rng.integers(0, 40)))
            )
    elif style == 2:  # internal repeats (same k-mer at multiple offsets)
        unit = rand_seq(rng, int(rng.integers(31, 50)))
        feats.append(unit * int(rng.integers(2, 4)))
        feats.append(rand_seq(rng, 120))
    elif style == 3:  # short features (< k -> no k-mers) mixed with normal
        feats.append(rand_seq(rng, int(rng.integers(5, 29))))
        feats.append(rand_seq(rng, int(rng.integers(100, 250))))
        feats.append(rand_seq(rng, 30))  # exactly one k-mer
    else:  # low-complexity / homopolymer-rich
        feats.append("A" * int(rng.integers(60, 150)))
        feats.append(("AC" * 100)[: int(rng.integers(60, 150))])
        feats.append(rand_seq(rng, 150))
    doubled = [x for f in feats for x in (f, revcomp(f))]
    return feats, doubled


def make_reads(rng, feats, n_reads):
    reads = []
    pool = [f for f in feats if len(f) >= 35] or feats
    for _ in range(n_reads):
        kind = int(rng.integers(0, 8))
        f = pool[int(rng.integers(0, len(pool)))]
        if kind <= 1:  # clean fragment (sometimes revcomp)
            L = min(len(f), int(rng.integers(35, 130)))
            s = int(rng.integers(0, max(1, len(f) - L + 1)))
            seq = f[s : s + L]
            if kind == 1:
                seq = revcomp(seq)
        elif kind == 2:  # mutated fragment
            L = min(len(f), int(rng.integers(40, 130)))
            s = int(rng.integers(0, max(1, len(f) - L + 1)))
            seq = list(f[s : s + L])
            for _ in range(int(rng.integers(1, 6))):
                p = int(rng.integers(0, len(seq)))
                seq[p] = "ACGT"[int(rng.integers(0, 4))]
            seq = "".join(seq)
        elif kind == 3:  # chimera
            g = pool[int(rng.integers(0, len(pool)))]
            L = int(rng.integers(40, 120))
            seq = f[: L // 2] + g[: L - L // 2]
        elif kind == 4:  # boundary lengths: 39/40/41 around MIN_READ_LENGTH
            L = int(rng.choice([39, 40, 41, 30, 69, 70]))
            s = int(rng.integers(0, max(1, len(f) - min(L, len(f)) + 1)))
            seq = (f + rand_seq(rng, L))[s : s + L]
        elif kind == 5:  # entropy boundary: mostly-homopolymer with salt
            L = int(rng.integers(40, 90))
            seq = list("A" * L)
            for _ in range(int(rng.integers(0, 12))):
                seq[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
            seq = "".join(seq)
        elif kind == 6:  # read longer than every feature
            seq = f + rand_seq(rng, int(rng.integers(10, 80)))
        else:  # junk
            seq = rand_seq(rng, int(rng.integers(35, 130)))
        reads.append(encode_bases(seq))
    return reads


def check_trial(rng, use_abs, use_mesh=False):
    feats, doubled = make_library(rng)
    if not any(len(f) >= 30 for f in doubled):
        return 0  # index would be empty; loader would reject upstream
    reads = make_reads(rng, feats, int(rng.integers(20, 80)))
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled),
        score_percent=float(rng.choice([0.05, 0.1, 0.33, 0.5, 0.9])),
        score_threshold=int(rng.choice([20, 30, 45, 60, 80])),
        num_mismatches=int(rng.integers(0, 5)),
        max_hits_to_report=int(rng.choice([1, 3, 10, 32])),
        discard_multiple_matches=bool(rng.integers(0, 2)),
    )
    index = build_index(doubled)
    host = HostAlignEngine(index, cfg)
    if use_mesh:
        from nimble_tpu.models.mesh_aligner import MeshAlignEngine

        dev = MeshAlignEngine(index, cfg)
    else:
        dev = DeviceAlignEngine(
            index, cfg, walk=("abs" if use_abs else "packed")
        )
    expected = host.align_batch(reads)
    got = dev.align_batch(reads)
    if got != expected:
        for i, (g, e) in enumerate(zip(got, expected)):
            if g != e:
                raise AssertionError(
                    f"DIVERGENCE read {i}: device={g} host={e} "
                    f"(abs={use_abs}, mesh={use_mesh}, "
                    f"cfg={cfg.__dict__})"
                )
    # columnar full-output path (the BAM fast consumer's align), plain
    # device engine only — mesh full-output rides the same decode
    if not use_mesh and not use_abs:
        n = len(reads)
        W = max(len(r) for r in reads)
        mat = np.zeros((n, W), dtype=np.int8)
        lens = np.zeros(n, dtype=np.int32)
        for i, r in enumerate(reads):
            mat[i, : len(r)] = r
            lens[i] = len(r)
        res = dev.full_collect(dev.full_dispatch(mat, lens,
                                                 np.ones(n, bool)))
        for i, (alignment, filt) in enumerate(expected):
            if alignment is not None:
                eq, norm, score = alignment
                assert res["reason"][i] == -1 and res["score"][i] == score \
                    and res["norm"][i] == norm, f"full path read {i}"
                key = int(res["eq_key"][i])
                got_eq = (res["rescued"][key] if key < -1
                          else dev.decode_combo(
                              key >> dev.c_max,
                              key & ((1 << dev.c_max) - 1)))
                assert list(got_eq) == list(eq), f"full path eq read {i}"
            else:
                assert res["reason"][i] >= 0, f"full path filter read {i}"
    return len(reads)


def repeat_rate_campaign(rng, minutes: float) -> None:
    """Measure how often linear vs colored-DBG eq classes actually differ
    on REPEAT-HEAVY libraries (the one documented divergence class,
    docs/SEMANTICS.md), and assert the containment invariants + the
    load-time detector on every trial.

    The models are the pinned host walk (`core/walk.py`) and the
    independently-derived `tests/cdbg_oracle.py`; divergences here are NOT
    failures — they are the documented class being exercised.  The output
    is the measured prevalence: of reads on repeat-heavy libraries, what
    fraction lands in the divergence class at all, split into
    subset-shaped divergences and DISJOINT ones (the round-4 refinement:
    inside the repeat class the containment invariants themselves can
    fail — the graph model cycles the repeat unitig past a positional row
    end; see docs/SEMANTICS.md 'Scope refinement').  Anchor agreement is
    still asserted on every read (both models anchor identically).
    """
    sys.path.insert(
        0,
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests"),
    )
    from cdbg_oracle import ColoredDbg, cdbg_map_read
    from nimble_tpu.core.walk import map_read_with_mismatch

    t_end = time.time() + minutes * 60
    trials = n_reads = n_anchored = n_diverged = n_disjoint = 0
    flagged_libs = 0
    while time.time() < t_end:
        # repeat-heavy library: tandem units of period 1..12, copy counts
        # chosen so some rows span long reads and some exhaust early
        period = int(rng.integers(1, 13))
        unit = rand_seq(rng, period)
        feats = [
            unit * int(rng.integers(3, 12)),
            unit * int(rng.integers(2, 6)) + rand_seq(rng, 40),
            rand_seq(rng, int(rng.integers(10, 30))) + unit
            * int(rng.integers(2, 8)),
            rand_seq(rng, 150),
        ]
        doubled = [x for f in feats for x in (f, revcomp(f))]
        if not any(len(f) >= 30 for f in doubled):
            continue
        import warnings as _w

        with _w.catch_warnings(record=True) as caught:
            _w.simplefilter("always")
            index = build_index(doubled)
        # detector check: a library whose repeat runs reach k+p MUST warn
        if len(index.repeat_rows):
            flagged_libs += 1
            assert any("tandem" in str(c.message) for c in caught), \
                "repeat rows flagged but no user warning emitted"
        graph = ColoredDbg(doubled)
        for _ in range(30):
            kind = int(rng.integers(0, 3))
            if kind == 0:  # in-phase repeat read
                read = unit * int(rng.integers(4, 20))
            elif kind == 1:  # out-of-phase repeat read
                s = int(rng.integers(0, period))
                read = (unit * int(rng.integers(5, 20)))[s:]
            else:  # repeat + unique tail
                read = unit * int(rng.integers(3, 8)) + rand_seq(rng, 20)
            if len(read) < 30:
                continue
            n_reads += 1
            lin = map_read_with_mismatch(encode_bases(read), index)
            g = cdbg_map_read(read, graph)
            assert (lin is None) == (g is None), f"anchor disagreement: {read[:40]}"
            if lin is None:
                continue
            n_anchored += 1
            eq_l, score_l, _ = lin
            eq_g, score_g, _ = g
            if list(eq_l) != sorted(eq_g):
                n_diverged += 1
                if not set(eq_l) <= set(eq_g):
                    n_disjoint += 1
        trials += 1
        if trials % 50 == 0:
            print(f"{trials} repeat libraries, {n_anchored} anchored reads, "
                  f"{n_diverged} diverged "
                  f"({100.0*n_diverged/max(1, n_anchored):.1f}%), "
                  f"{n_disjoint} non-subset", flush=True)
    print(
        f"REPEAT-RATE DONE: {trials} libraries ({flagged_libs} flagged by "
        f"the detector), {n_reads} reads, {n_anchored} anchored, "
        f"{n_diverged} diverged = "
        f"{100.0*n_diverged/max(1, n_anchored):.2f}% of anchored reads "
        f"({n_disjoint} of those non-subset-shaped; anchor agreement held "
        f"on every read)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--abs-every", type=int, default=5,
                    help="run every Nth trial with the unpacked abs walk")
    ap.add_argument("--repeat-rate", action="store_true",
                    help="repeat-heavy linear-vs-colored-DBG divergence "
                         "prevalence campaign (docs/SEMANTICS.md class)")
    args = ap.parse_args()
    if args.repeat_rate:
        repeat_rate_campaign(np.random.default_rng(args.seed), args.minutes)
        return
    rng = np.random.default_rng(args.seed)
    t_end = time.time() + args.minutes * 60
    trials = reads_total = 0
    while time.time() < t_end:
        use_abs = (args.abs_every
                   and trials % args.abs_every == args.abs_every - 1)
        use_mesh = trials % 11 == 7  # occasional 8-virtual-device mesh
        # per-trial child seed so a failure is reproducible from the log
        child = int(rng.integers(0, 2**63 - 1))
        try:
            reads_total += check_trial(np.random.default_rng(child),
                                       use_abs and not use_mesh, use_mesh)
        except AssertionError:
            print(f"FAILED at trial {trials} child_seed={child} "
                  f"abs={use_abs} mesh={use_mesh}", flush=True)
            raise
        trials += 1
        if trials % 25 == 0:
            print(f"{trials} trials, {reads_total} reads, all engines agree",
                  flush=True)
            # every trial compiles fresh shapes; the in-process XLA cache
            # grows unboundedly and eventually OOMs the box — drop it
            jax.clear_caches()
    print(f"DONE: {trials} trials, {reads_total} reads, zero divergences",
          flush=True)


if __name__ == "__main__":
    main()
