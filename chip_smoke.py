#!/usr/bin/env python
"""Smoke run of the counting path on the GPU, through the CLI.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the multi-device paths

One card, all in this process (a JAX process reserves most of the card):

0. preflight — card name and power limit, JAX devices (exit non-zero
   unless the platform is ``gpu``), the C++ host library, the compile cache;
1. oracle fixtures — every library x reads pair of the reference's
   integration tests through ``cli.main`` on the device engine, compared
   with the expected vectors, the golden forensic BAM through the fast BAM
   path, and the device engine vs the host oracle at launch_batch 8192;
2. FASTQ at real size — a 500 x 1,500 bp library against 4,000,000 90 bp
   reads end to end, then a 100,000-read sample on the device engine and
   the host oracle (byte-identical TSVs), and the same sample against two
   libraries (the stacked multi-library kernel) vs two host runs;
3. 10x BAM at real size — 1,000,000 records through the fast BAM path,
   then a 20,000-record BAM on the fast path vs the reference-port BAM
   pipeline with the host oracle (byte-identical decompressed TSVs);
4. one warmed ``probe_walk_full`` launch (8192 reads, bucket 92).

Every comparison is exact.  Any failure ends the run with a non-zero exit;
the last line of a passing run is one JSON object naming the device.  The
numbers printed on the way are for orientation, not benchmark metrics.

``--four-cards`` launches four CLI processes with ``--num-processes 4``,
each seeing one card (``CUDA_VISIBLE_DEVICES``), before this process
touches a card, then runs ``--engine mesh`` over all four cards here; both
are compared with the one-card device engine and the host oracle.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from nimble_tpu.utils.dna import revcomp

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

# the library config of a typical custom nimble library (KIR/MHC style)
LIBRARY_CONFIG = {
    "score_percent": 0.33, "score_filter": 25, "score_threshold": 50,
    "num_mismatches": 1, "discard_multiple_matches": False,
    "require_valid_pair": False, "discard_multi_hits": 0,
    "intersect_level": 0, "max_hits_to_report": 10, "group_on": "",
    "trim_target_length": 0, "trim_strictness": 0.5,
}


@dataclasses.dataclass(frozen=True)
class Sizes:
    features: int = 500
    feat_len: int = 1500
    read_len: int = 90
    reads: int = 4_000_000
    sample: int = 100_000
    bam_records: int = 1_000_000
    bam_compare_records: int = 20_000
    bam_cores: int = 4


FULL = Sizes()
# the same phases at a size the CPU test suite runs in seconds
TINY = Sizes(features=12, feat_len=300, reads=3000, sample=600,
             bam_records=400, bam_compare_records=240)


class SmokeFailure(RuntimeError):
    """A device result differed from its reference."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# --- inputs, generated from a seed ------------------------------------------


def random_features(n: int, length: int, seed: int) -> List[str]:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    return [row.tobytes().decode() for row in ACGT[codes]]


def write_library(path: str, names: Sequence[str],
                  seqs: Sequence[str]) -> str:
    with open(path, "w") as f:
        json.dump([LIBRARY_CONFIG,
                   {"headers": ["sequence_name", "sequence"],
                    "columns": [list(names), list(seqs)]}], f)
    return path


def simulate_reads(feats: Sequence[str], n: int, read_len: int,
                   seed: int) -> np.ndarray:
    """(n, read_len) uint8 codes drawn from the revcomp-doubled library:
    ~20% carry one substitution, ~5% are random junk (bench.py's salting)."""
    rng = np.random.default_rng(seed)
    rows = np.stack([
        np.frombuffer(s.encode(), dtype=np.uint8)
        for f in feats for s in (f, revcomp(f))
    ])
    lut = np.zeros(256, dtype=np.uint8)
    lut[ACGT] = np.arange(4, dtype=np.uint8)
    rows = lut[rows]
    feat_len = rows.shape[1]
    r = rng.integers(0, rows.shape[0], n)
    s = rng.integers(0, feat_len - read_len + 1, n)
    mat = rows[r[:, None], s[:, None] + np.arange(read_len)]
    mutate = rng.random(n) < 0.2
    pos = rng.integers(0, read_len, n)
    delta = rng.integers(1, 4, n).astype(np.uint8)
    mat[mutate, pos[mutate]] = (mat[mutate, pos[mutate]] + delta[mutate]) % 4
    junk = rng.random(n) < 0.05
    mat[junk] = rng.integers(0, 4, (int(junk.sum()), read_len),
                             dtype=np.uint8)
    return mat


def write_fastq(path: str, mat: np.ndarray, slab: int = 500_000) -> str:
    n, L = mat.shape
    with open(path, "wb") as f:
        for lo in range(0, n, slab):
            m = mat[lo : lo + slab]
            k = m.shape[0]
            body = np.concatenate([
                np.tile(np.frombuffer(b"@r\n", dtype=np.uint8), (k, 1)),
                ACGT[m],
                np.tile(np.frombuffer(b"\n+\n", dtype=np.uint8), (k, 1)),
                np.full((k, L), ord("I"), dtype=np.uint8),
                np.full((k, 1), ord("\n"), dtype=np.uint8),
            ], axis=1)
            f.write(body.tobytes())
    return path


@dataclasses.dataclass
class Inputs:
    feats_a: List[str]
    lib_a: str
    lib_b: str
    reads: np.ndarray
    fastq: str
    sample: str


def make_inputs(work: str, sizes: Sizes, seed: int,
                write_full: bool = True) -> Inputs:
    """Library A (``features`` x ``feat_len``), library B (half of A's
    features plus as many new ones), the full FASTQ (unless
    ``write_full`` is False) and a seeded sample of it."""
    feats_a = random_features(sizes.features, sizes.feat_len, seed)
    half = sizes.features // 2
    feats_new = random_features(sizes.features - half, sizes.feat_len,
                                seed + 1)
    lib_a = write_library(os.path.join(work, "lib_a.json"),
                          [f"f{i}" for i in range(len(feats_a))], feats_a)
    lib_b = write_library(
        os.path.join(work, "lib_b.json"),
        [f"f{i}" for i in range(half, sizes.features)]
        + [f"g{i}" for i in range(len(feats_new))],
        feats_a[half:] + feats_new,
    )
    reads = simulate_reads(feats_a, sizes.reads, sizes.read_len, seed + 2)
    fastq = os.path.join(work, "reads.fastq")
    if write_full:
        write_fastq(fastq, reads)
    pick = np.sort(np.random.default_rng(seed + 3).choice(
        sizes.reads, sizes.sample, replace=False))
    sample = write_fastq(os.path.join(work, "sample.fastq"), reads[pick])
    return Inputs(feats_a, lib_a, lib_b, reads, fastq, sample)


# --- running the CLI in this process ----------------------------------------


class CompileMeter:
    """Seconds and names of XLA compilations, from JAX's monitoring events."""

    def __init__(self):
        self.seconds = 0.0
        self.names: List[str] = []
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **kw) -> None:
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration
            if event.endswith("backend_compile_duration"):
                self.names.append(str(kw.get("fun_name", "?")))

    def mark(self):
        return self.seconds, len(self.names)


def run_cli(argv: Sequence[str]) -> float:
    """``cli.main`` in this process, its chatter captured; wall seconds."""
    from nimble_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}: {buf.getvalue()[-2000:]}")
    return dt


def output_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def fresh(path: str) -> str:
    """The CLI appends to an existing TSV: start every run from nothing."""
    if os.path.exists(path):
        os.remove(path)
    return path


def same_outputs(a: str, b: str, what: str) -> None:
    ba, bb = output_bytes(a), output_bytes(b)
    if ba != bb:
        la, lb = ba.splitlines(), bb.splitlines()
        first = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                     min(len(la), len(lb)))
        raise SmokeFailure(
            f"{what}: {a} != {b} ({len(la)} vs {len(lb)} lines); first "
            f"difference at line {first}:\n  {la[first][:300] if first < len(la) else ''}"
            f"\n  {lb[first][:300] if first < len(lb) else ''}")
    check(len(ba.splitlines()) > 1, f"{what}: {a} has no result rows")


# --- phases -----------------------------------------------------------------


@dataclasses.dataclass
class PhaseResult:
    name: str
    seconds: float
    items: int
    unit: str


def phase_oracle_fixtures(work: str) -> PhaseResult:
    """The reference's integration fixtures through the CLI on the device
    engine (`tests/test_oracle_alignment.py`, `tests/test_cli.py`)."""
    basic = [["A02-0", "A02-1", "A02-2", "A02-LC"], ["A02-0", "A02-LC"],
             ["A02-1"]]
    cases = []
    for lib in ("basic.json", "basic-rev.json"):
        for mm, a02_1 in ((0, 1), (1, 1), (2, 2)):
            cases.append((lib, "basic.fastq", mm,
                          [(basic[0], 1), (basic[1], 1), (basic[2], a02_1)]))
    for mm, count in ((0, 1), (1, 2)):
        cases.append(("mismatch.json", "mismatch.fastq", mm,
                      [(["gene"], count)]))
    t0 = time.perf_counter()
    for lib, reads, mm, expected in cases:
        with open(os.path.join(DATA, "libraries", lib)) as f:
            spec = json.load(f)
        spec[0]["num_mismatches"] = mm
        lib_path = os.path.join(work, f"{lib}.mm{mm}.json")
        with open(lib_path, "w") as f:
            json.dump(spec, f)
        out = fresh(os.path.join(work, f"{lib}.mm{mm}.tsv"))
        run_cli(["-r", lib_path, "-i", os.path.join(DATA, "reads", reads),
                 "-o", out, "-f", "none", "--engine", "device"])
        want = "feature\tscore\n" + "".join(
            "\t".join(feats) + f"\t{n}\n" for feats, n in expected)
        got = output_bytes(out).decode()
        check(got == want, f"{lib} x {reads} mm={mm}: {got!r} != {want!r}")
    check_golden_forensic(work)
    return PhaseResult("oracle_fixtures", time.perf_counter() - t0,
                       len(cases) + 1, "cases")


def forensic_workload():
    """The frozen workload of tests/data/golden/forensic.bam (pinned by
    tests/test_golden_forensic.py): 5 random 180 bp features, seed 12345."""
    from nimble_tpu.config import AlignFilterConfig
    from nimble_tpu.index.build import build_index
    from nimble_tpu.library import Reference

    rng = np.random.default_rng(12345)
    feats = ["".join(rng.choice(list("ACGT"), size=180)) for _ in range(5)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    names = [n for i in range(5) for n in (f"F{i}", f"F{i}§rev")]
    reference = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0, sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=10, score_percent=0.25, score_threshold=40,
        num_mismatches=2, max_hits_to_report=8,
    )
    return reference, build_index(doubled), cfg


def check_golden_forensic(work: str) -> None:
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.pipeline.bam_fast import process_fast

    reference, index, cfg = forensic_workload()
    out = fresh(os.path.join(work, "forensic.tsv.gz"))
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast([os.path.join(DATA, "golden", "forensic.bam")],
                     [DeviceAlignEngine(index, cfg)], [reference], [cfg],
                     [out], 2, False, parity_quirks=True)
    with open(os.path.join(DATA, "golden", "forensic_quirks.tsv"), "rb") as f:
        want = f.read()
    check(output_bytes(out) == want, "forensic.bam: fast path != golden TSV")


def check_engine_matches_host(launch_batch: int = 8192, n_reads: int = 20_000,
                              seed: int = 7) -> int:
    """Device engine vs host oracle per read and through the counting path,
    at the production launch shape; returns the number of reads compared."""
    from nimble_tpu.config import AlignFilterConfig
    from nimble_tpu.core.calls import (HostAlignEngine, get_calls,
                                       sort_score_vector)
    from nimble_tpu.core.fast_count import fast_count_calls_matrix
    from nimble_tpu.index.build import build_index
    from nimble_tpu.library import Reference
    from nimble_tpu.models.aligner import DeviceAlignEngine

    feats = random_features(50, 500, seed)
    doubled = [x for s in feats for x in (s, revcomp(s))]
    reference = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[[n for i in range(50) for n in (f"f{i}", f"f{i}§rev")],
                 doubled],
        sequence_name_idx=0, sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled), score_percent=0.33,
        score_threshold=50, num_mismatches=1, max_hits_to_report=10,
    )
    index = build_index(doubled)
    # three read lengths: three buckets, each at the fixed launch shape
    mats = [simulate_reads(feats, n_reads // 3, L, seed + L)
            for L in (60, 90, 150)]
    reads = [row.astype(np.int8) for m in mats for row in m]
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    mat = np.zeros((len(reads), 150), dtype=np.int8)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = r
    dev = DeviceAlignEngine(index, cfg, launch_batch=launch_batch)
    host = HostAlignEngine(index, cfg)
    got, want = dev.align_batch(reads), host.align_batch(reads)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    check(not bad, f"align_batch: {len(bad)} reads differ, first {bad[:5]}")
    strip = lambda res: [(f, e[0]) for f, e in res]  # noqa: E731
    counted = strip(fast_count_calls_matrix(mat, lens, None, None, dev,
                                            reference, cfg))
    oracle = strip(sort_score_vector(
        get_calls(reads, None, [], host, reference, cfg)[0]))
    check(counted == oracle, "fast counting path != host get_calls")
    return len(reads)


def phase_fastq(work: str, inp: Inputs, sizes: Sizes) -> List[PhaseResult]:
    """The whole FASTQ on the device engine, then the sample on the device
    engine vs the host oracle."""
    out = fresh(os.path.join(work, "reads.device.tsv"))
    full = run_cli(["-r", inp.lib_a, "-i", inp.fastq, "-o", out])
    check(len(output_bytes(out).splitlines()) > 1, "full FASTQ: no results")
    dev = fresh(os.path.join(work, "sample.device.tsv"))
    t_dev = run_cli(["-r", inp.lib_a, "-i", inp.sample, "-o", dev])
    host = fresh(os.path.join(work, "sample.host.tsv"))
    t_host = run_cli(["-r", inp.lib_a, "-i", inp.sample, "-o", host,
                      "--engine", "host"])
    same_outputs(dev, host, "FASTQ sample: device vs host")
    return [PhaseResult("fastq_full_device", full, sizes.reads, "reads"),
            PhaseResult("fastq_sample_device", t_dev, sizes.sample, "reads"),
            PhaseResult("fastq_sample_host", t_host, sizes.sample, "reads")]


def phase_two_libraries(work: str, inp: Inputs,
                        sizes: Sizes) -> List[PhaseResult]:
    """The sample against two libraries in one device run (the stacked
    multi-library kernel) vs one host run per library."""
    outs = [fresh(os.path.join(work, f"two.{n}.device.tsv")) for n in "ab"]
    t_dev = run_cli(["-r", inp.lib_a, "-r", inp.lib_b, "-i", inp.sample,
                     "-o", outs[0], "-o", outs[1]])
    t_host = 0.0
    for lib, out, n in zip((inp.lib_a, inp.lib_b), outs, "ab"):
        host = fresh(os.path.join(work, f"two.{n}.host.tsv"))
        t_host += run_cli(["-r", lib, "-i", inp.sample, "-o", host,
                           "--engine", "host"])
        same_outputs(out, host, f"two libraries, library {n}: device vs host")
    return [PhaseResult("two_libraries_device", t_dev, sizes.sample, "reads"),
            PhaseResult("two_libraries_host", t_host, sizes.sample, "reads")]


def phase_bam(work: str, inp: Inputs, sizes: Sizes,
              seed: int) -> List[PhaseResult]:
    """A 10x BAM of ``bam_records`` records through the fast BAM path, then
    a ``bam_compare_records`` BAM on the fast path vs the reference-port
    pipeline with the host oracle."""
    from nimble_tpu.io.synth import make_synthetic_bam

    results = []
    for name, n_records, compare in (
        ("bam_full", sizes.bam_records, False),
        ("bam_compare", sizes.bam_compare_records, True),
    ):
        bam = os.path.join(work, f"{name}.bam")
        t0 = time.perf_counter()
        n = make_synthetic_bam(
            bam, inp.feats_a, n_groups=max(1, n_records // 8),
            pairs_per_group=4, read_len=sizes.read_len, seed=seed + n_records,
            mutate_every=5, stream=True,
        )
        print(f"  wrote {name}.bam: {n} records in "
              f"{time.perf_counter() - t0:.1f} s")
        dev = fresh(os.path.join(work, f"{name}.device.tsv.gz"))
        t_dev = run_cli(["-r", inp.lib_a, "-i", bam, "-o", dev,
                         "-c", str(sizes.bam_cores)])
        check(len(output_bytes(dev).splitlines()) > 1, f"{name}: no rows")
        results.append(PhaseResult(f"{name}_device", t_dev, n, "records"))
        if compare:
            # -c 2: ONE consumer thread.  With more, the reference-port
            # pipeline (like the reference) writes groups in the order its
            # consumers finish them; the fast path's order is fixed.
            host = fresh(os.path.join(work, f"{name}.host.tsv.gz"))
            t_host = run_cli(["-r", inp.lib_a, "-i", bam, "-o", host,
                              "-c", "2", "--engine", "host"])
            same_outputs(dev, host, f"{name}: fast path vs host pipeline")
            results.append(PhaseResult(f"{name}_host", t_host, n, "records"))
    return results


def time_probe_walk_full(inp: Inputs, launch_batch: int = 8192,
                         bucket: int = 92, repeats: int = 20) -> Dict:
    """Device time of one warmed ``probe_walk_full`` launch (launch_batch
    reads in the given bucket), timed with ``block_until_ready``."""
    import jax
    import jax.numpy as jnp

    from nimble_tpu.config import LibraryChemistry
    from nimble_tpu.index.build import build_index
    from nimble_tpu.library import (get_reference_sequence_data,
                                    load_reference_library)
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.ops.engine_fast import probe_walk_full

    cfg, ref = load_reference_library(inp.lib_a, LibraryChemistry.UNSTRANDED)
    eng = DeviceAlignEngine(
        build_index(get_reference_sequence_data(ref)[0]), cfg)
    m = inp.reads[:launch_batch]
    reads = np.zeros((launch_batch, bucket), dtype=np.int8)
    reads[: m.shape[0], : m.shape[1]] = m
    lens = np.full(launch_batch, m.shape[1], dtype=np.int32)
    d = eng._dev_fast
    x, xl = jnp.asarray(reads), jnp.asarray(lens)

    def launch():
        return probe_walk_full(
            x, xl, d["bkey_lo"], d["bkey_hi"], d["bkey_fp"], d["bstart"],
            d["bcount"], d["postings_row"], d["postings_off"],
            d["ref_codes_packed"], d["row_starts"], d["row_lengths"],
            k=eng.bidx.k, max_probe=eng.bidx.max_probe, c_max=eng.c_max,
            bucket_mask=eng.bidx.n_buckets - 1,
            p_limit=bucket - eng.bidx.k + 1, ref_pad=eng.bidx.ref_pad,
            phase_a=eng.phase_a_positions,
        )

    jax.block_until_ready(launch())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(launch())
        times.append(time.perf_counter() - t0)
    return {"min_ms": min(times) * 1e3,
            "median_ms": float(np.median(times)) * 1e3,
            "launch_batch": launch_batch, "bucket": bucket}


# --- reporting --------------------------------------------------------------


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if lines else "nvidia-smi reported no card"


def device_summary(n_expected: int) -> Optional[Dict]:
    """The JAX device summary, or None (after saying why) when the run must
    not go on: no GPU, or fewer GPUs than the mode needs."""
    import jax

    devices = jax.devices()
    print(f"jax devices: {devices}")
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return None
    if len(devices) < n_expected:
        print(f"chip_smoke: needs {n_expected} GPUs, found {len(devices)}",
              file=sys.stderr)
        return None
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def report(res: PhaseResult, compile_s: float, n_compiled: int,
           card: str) -> None:
    rate = res.items / res.seconds if res.seconds > 0 else float("nan")
    print(f"phase {res.name}: {res.seconds:.3f} s wall, {res.items} "
          f"{res.unit}, {rate:.1f} {res.unit}/s, compile {compile_s:.3f} s "
          f"({n_compiled} executables) | {card}")


def preflight(n_devices: int):
    card = card_line()
    print(f"card: {card}")
    dev = device_summary(n_devices)
    if dev is None:
        return None
    from nimble_tpu import native
    from nimble_tpu.utils import compile_cache

    check(native.available(), "the C++ host library did not build or load")
    print(f"native host library: loaded | compile cache: "
          f"{compile_cache.enable()}")
    return card, dev


def one_card(sizes: Sizes, seed: int) -> int:
    pre = preflight(1)
    if pre is None:
        return 2
    card, dev = pre
    import jax

    meter = CompileMeter()

    def timed(fn, *a):
        c0, n0 = meter.mark()
        results = fn(*a)
        c1, n1 = meter.mark()
        results = results if isinstance(results, list) else [results]
        for r in results:
            report(r, c1 - c0, n1 - n0, card)
        print(f"  compiled: {sorted(set(meter.names[n0:n1]))}")
        return results

    with tempfile.TemporaryDirectory(prefix="nimble_smoke_") as work:
        timed(phase_oracle_fixtures, work)
        t0 = time.perf_counter()
        n = check_engine_matches_host(launch_batch=8192)
        print(f"engine vs host at launch_batch 8192: {n} reads identical "
              f"({time.perf_counter() - t0:.3f} s) | {card}")
        t0 = time.perf_counter()
        inp = make_inputs(work, sizes, seed)
        print(f"inputs: {sizes.reads} reads + {sizes.sample}-read sample, "
              f"{sizes.features} x {sizes.feat_len} bp library, generated in "
              f"{time.perf_counter() - t0:.1f} s")
        timed(phase_fastq, work, inp, sizes)
        timed(phase_two_libraries, work, inp, sizes)
        timed(phase_bam, work, inp, sizes, seed)
        walk = time_probe_walk_full(inp)
        print(f"probe_walk_full launch: {walk['min_ms']:.4f} ms min, "
              f"{walk['median_ms']:.4f} ms median ({walk['launch_batch']} "
              f"reads, bucket {walk['bucket']}) | {card}")
    print(f"compile total: {meter.seconds:.3f} s ({len(meter.names)} "
          f"executables) | {card}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes "
          f"| {card}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


# --- four cards ---------------------------------------------------------------


def four_card_children(lib: str, reads: str, out: str, n: int = 4,
                       environ: Optional[Dict[str, str]] = None):
    """(argv, env) of ``n`` CLI processes of one multi-process run, each
    seeing exactly one card."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if environ is None else environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    children = []
    for i in range(n):
        env = dict(base, CUDA_VISIBLE_DEVICES=str(i))
        argv = [sys.executable, "-m", "nimble_tpu.cli", "-r", lib, "-i",
                reads, "-o", out, "--num-processes", str(n),
                "--process-id", str(i), "--coordinator", f"localhost:{port}"]
        children.append((argv, env))
    return children


def run_children(children, work: str, timeout: float = 900) -> float:
    t0 = time.perf_counter()
    procs = []
    for i, (argv, env) in enumerate(children):
        log = open(os.path.join(work, f"child{i}.log"), "wb")
        procs.append((subprocess.Popen(argv, env=env, stdout=log,
                                       stderr=subprocess.STDOUT, cwd=REPO),
                      log))
    try:
        for i, (p, log) in enumerate(procs):
            rc = p.wait(timeout=timeout)
            log.close()
            if rc != 0:
                with open(log.name, "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
                raise SmokeFailure(f"process {i} exited {rc}:\n{tail}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return time.perf_counter() - t0


def four_cards(sizes: Sizes, seed: int) -> int:
    # everything before the children must stay off the cards
    card = card_line()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory(prefix="nimble_smoke4_") as work:
        t0 = time.perf_counter()
        inp = make_inputs(work, sizes, seed, write_full=False)
        print(f"inputs: {sizes.sample}-read sample generated in "
              f"{time.perf_counter() - t0:.1f} s")
        multi = os.path.join(work, "sample.4proc.tsv")
        t = run_children(four_card_children(inp.lib_a, inp.sample, multi),
                         work)
        print(f"phase cli_4_processes: {t:.3f} s wall, {sizes.sample} reads "
              f"| {card}")

        dev = device_summary(4)
        if dev is None:
            return 2
        from nimble_tpu.utils import compile_cache

        print(f"compile cache: {compile_cache.enable()}")
        meter = CompileMeter()

        def tsv(tag: str) -> str:
            return fresh(os.path.join(work, f"{tag}.tsv"))

        libs = [("a", inp.lib_a), ("b", inp.lib_b)]
        runs = {}
        for engine in ("device", "host", "mesh"):
            out = tsv(f"one.{engine}")
            c0, _ = meter.mark()
            runs[engine, "one"] = run_cli(["-r", inp.lib_a, "-i", inp.sample,
                                           "-o", out, "--engine", engine])
            print(f"phase sample_{engine}: {runs[engine, 'one']:.3f} s wall, "
                  f"compile {meter.mark()[0] - c0:.3f} s | {card}")
            outs = [tsv(f"two.{n}.{engine}") for n, _ in libs]
            argv = [a for _, lib in libs for a in ("-r", lib)]
            argv += ["-i", inp.sample] + [a for o in outs for a in ("-o", o)]
            if engine == "host":
                # the oracle runs one library at a time
                for (n, lib), o in zip(libs, outs):
                    run_cli(["-r", lib, "-i", inp.sample, "-o", fresh(o),
                             "--engine", "host"])
            else:
                c0, _ = meter.mark()
                t = run_cli(argv + ["--engine", engine])
                print(f"phase two_libraries_{engine}: {t:.3f} s wall, "
                      f"compile {meter.mark()[0] - c0:.3f} s | {card}")
        one = os.path.join(work, "one.device.tsv")
        same_outputs(one, os.path.join(work, "one.host.tsv"),
                     "one card vs host")
        same_outputs(os.path.join(work, "one.mesh.tsv"), one,
                     "mesh (4 cards) vs one card")
        same_outputs(multi, one, "4-process CLI vs one card")
        for n, _ in libs:
            ref = os.path.join(work, f"two.{n}.host.tsv")
            for engine in ("device", "mesh"):
                same_outputs(os.path.join(work, f"two.{n}.{engine}.tsv"), ref,
                             f"two libraries, library {n}: {engine} vs host")
        print("four-card comparisons: mesh, 4-process CLI, one card and host "
              f"identical | {card}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device paths, on four cards")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.four_cards:
        return four_cards(FULL, args.seed)
    return one_card(FULL, args.seed)


if __name__ == "__main__":
    sys.exit(main())
