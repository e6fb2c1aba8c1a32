"""Multi-host scaffolding: content-hash routing + count merge equal the
single-process results — simulated in-process, and for real with TWO jax
processes over `jax.distributed` on CPU."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from nimble_tpu.config import LibraryChemistry
from nimble_tpu.core.fast_count import FastCounter, pack_matrix
from nimble_tpu.index.build import build_index
from nimble_tpu.io.fastq import read_fastq_codes
from nimble_tpu.library import get_reference_sequence_data, load_reference_library
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.parallel import multihost

from conftest import library_path, reads_path


def _setup():
    cfg, ref = load_reference_library(library_path("basic.json"), LibraryChemistry.NONE)
    cfg.num_mismatches = 1
    index = build_index(get_reference_sequence_data(ref)[0])
    return cfg, ref, index


def _local_allgather_factory(per_host_payloads):
    """Shim: 'allgather' over simulated hosts executing in one process."""

    def allgather(arrays):
        return per_host_payloads

    return allgather


def test_simulated_two_host_merge_equals_single():
    cfg, ref, index = _setup()
    engine = DeviceAlignEngine(index, cfg)
    reads = read_fastq_codes(reads_path("basic.fastq")) * 6  # 24 reads, dups
    mat, lens = pack_matrix(reads)

    # single-process truth
    single = FastCounter(engine, ref, cfg)
    single.add(mat, lens)
    expected = [(cs, e[0]) for cs, e in single.finalize()]

    # simulate 2 hosts: contiguous record split, content-hash routing
    n_hosts = 2
    shards = [
        (mat[lo:hi], lens[lo:hi])
        for lo, hi in (
            multihost.host_record_range(mat.shape[0], n_hosts, h)
            for h in range(n_hosts)
        )
    ]
    payloads = [
        (multihost._pack2bit(m), l, multihost._read_owner_hash(m, l, n_hosts))
        for m, l in shards
    ]
    allgather = _local_allgather_factory(payloads)

    local_results = []
    for h in range(n_hosts):
        own_mat, own_lens = multihost.exchange_reads_by_content(
            shards[h][0], shards[h][1], n_hosts, h, allgather=allgather
        )
        counter = FastCounter(engine, ref, cfg)
        counter.add(own_mat, own_lens)
        local_results.append(counter.finalize())

    # ownership is disjoint and covers every read exactly once
    owned_total = sum(
        multihost.exchange_reads_by_content(
            shards[h][0], shards[h][1], n_hosts, h, allgather=allgather
        )[0].shape[0]
        for h in range(n_hosts)
    )
    assert owned_total == mat.shape[0]

    blobs = []
    import pickle

    for res in local_results:
        blobs.append(pickle.dumps([(tuple(cs), e[0]) for cs, e in res]))
    merged = multihost.merge_host_results(
        local_results[0], allgather_bytes=lambda payload: blobs
    )
    assert [(cs, e[0]) for cs, e in merged] == expected


_WORKER = textwrap.dedent("""
    import os, sys, pickle
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    proc_id = int(sys.argv[1]); n_proc = int(sys.argv[2]); port = sys.argv[3]
    out_path = sys.argv[4]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc, process_id=proc_id,
    )
    sys.path.insert(0, "/root/repo")
    sys.path.insert(0, "/root/repo/tests")
    from conftest import library_path, reads_path
    from nimble_tpu.config import LibraryChemistry
    from nimble_tpu.index.build import build_index
    from nimble_tpu.library import get_reference_sequence_data, load_reference_library
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.parallel import multihost
    cfg, ref = load_reference_library(library_path("basic.json"), LibraryChemistry.NONE)
    cfg.num_mismatches = 1
    index = build_index(get_reference_sequence_data(ref)[0])
    engine = DeviceAlignEngine(index, cfg)
    merged = multihost.process_fastq_multihost(
        reads_path("basic.fastq"), engine, ref, cfg, None,
        n_hosts=n_proc, host_id=proc_id,
    )
    if proc_id == 0:
        with open(out_path, "wb") as f:
            pickle.dump([(cs, e[0]) for cs, e in merged], f)
""")


def test_real_two_process_distributed_cpu(tmp_path):
    """Two actual jax processes, coordinated via jax.distributed, produce
    counts identical to the single-process run (VERDICT r1 item 4)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    out_path = str(tmp_path / "merged.pkl")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(i), "2", port, out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in outs:
        assert rc == 0, stderr.decode()[-2000:]

    import pickle

    with open(out_path, "rb") as f:
        merged = pickle.load(f)

    cfg, ref, index = _setup()
    engine = DeviceAlignEngine(index, cfg)
    reads = read_fastq_codes(reads_path("basic.fastq"))
    mat, lens = pack_matrix(reads)
    counter = FastCounter(engine, ref, cfg)
    counter.add(mat, lens)
    expected = [(cs, e[0]) for cs, e in counter.finalize()]
    assert merged == expected


def test_simulated_two_host_paired_merge_equals_single():
    """Paired-end routing: all copies of a PAIR land on one owner host and
    the merged counts equal the single-process paired run."""
    cfg, ref, index = _setup()
    engine = DeviceAlignEngine(index, cfg)
    reads = read_fastq_codes(reads_path("basic.fastq"))
    # mates = reversed list so pairs are non-trivial; duplicate the pairs
    r1 = (reads * 6)[:20]
    r2 = (list(reversed(reads)) * 6)[:20]
    m1, l1 = pack_matrix(r1)
    m2, l2 = pack_matrix(r2)

    single = FastCounter(engine, ref, cfg)
    single.add(m1, l1, m2, l2)
    expected = [(cs, e[0]) for cs, e in single.finalize()]

    n_hosts = 2
    ranges = [multihost.host_record_range(m1.shape[0], n_hosts, h)
              for h in range(n_hosts)]
    payloads = [
        (
            multihost._pack2bit(m1[lo:hi]), l1[lo:hi],
            multihost._pack2bit(m2[lo:hi]), l2[lo:hi],
            multihost._read_owner_hash(
                m1[lo:hi], l1[lo:hi], n_hosts, m2[lo:hi], l2[lo:hi]
            ),
        )
        for lo, hi in ranges
    ]

    local_results = []
    owned_total = 0
    for h in range(n_hosts):
        lo, hi = ranges[h]
        om, ol, om2, ol2 = multihost.exchange_reads_by_content(
            m1[lo:hi], l1[lo:hi], n_hosts, h,
            allgather=lambda arrays: payloads,
            mate_mat=m2[lo:hi], mate_lens=l2[lo:hi],
        )
        owned_total += om.shape[0]
        assert om.shape[0] == om2.shape[0]
        counter = FastCounter(engine, ref, cfg)
        counter.add(om, ol, om2, ol2)
        local_results.append(counter.finalize())
    assert owned_total == m1.shape[0]

    import pickle

    blobs = [
        pickle.dumps([(tuple(cs), e[0]) for cs, e in res])
        for res in local_results
    ]
    merged = multihost.merge_host_results(
        local_results[0], allgather_bytes=lambda payload: blobs
    )
    assert [(cs, e[0]) for cs, e in merged] == expected


def test_real_two_process_cli(tmp_path):
    """The CLI's --num-processes/--process-id/--coordinator surface: two
    real processes produce the same TSV as the single-process CLI."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "/root/repo"

    single_out = str(tmp_path / "single.tsv")
    rc = subprocess.run(
        [sys.executable, "-m", "nimble_tpu.cli",
         "-r", library_path("basic.json"), "-i", reads_path("basic.fastq"),
         "-o", single_out, "--engine", "device"],
        env=env, capture_output=True, timeout=150,
    )
    assert rc.returncode == 0, rc.stderr.decode()[-2000:]

    outs = [str(tmp_path / f"mh{i}.tsv") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nimble_tpu.cli",
             "-r", library_path("basic.json"),
             "-i", reads_path("basic.fastq"), "-o", outs[i],
             "--engine", "device",
             "--num-processes", "2", "--process-id", str(i),
             "--coordinator", f"127.0.0.1:{port}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed CLI timed out")
        assert p.returncode == 0, stderr.decode()[-2000:]

    with open(single_out, "rb") as f:
        expected_bytes = f.read()
    with open(outs[0], "rb") as f:
        assert f.read() == expected_bytes  # process 0 writes the table
    assert not os.path.exists(outs[1]) or open(outs[1], "rb").read() in (
        b"", expected_bytes
    )


# --- BAM multi-host (group-range sharding) -------------------------------

def _bam_workload(tmp_path, n_groups=12):
    from nimble_tpu.config import AlignFilterConfig
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.library import Reference
    from nimble_tpu.utils.dna import revcomp

    rng = np.random.default_rng(17)
    feats = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(6)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    names = [n for i in range(6) for n in (f"feat{i}", f"feat{i}§rev")]
    reference = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0, sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=12, score_percent=0.2, score_threshold=40,
        num_mismatches=1, max_hits_to_report=8,
    )
    index = build_index(doubled)
    bam = str(tmp_path / "mh.bam")
    make_synthetic_bam(bam, feats, n_groups=n_groups, pairs_per_group=3,
                       read_len=80, seed=17, mutate_every=4)
    return bam, reference, index, cfg


@pytest.mark.parametrize("quirks", [True, False])
def test_simulated_two_host_bam_equals_single(tmp_path, quirks):
    """Two simulated hosts (threads + a real rendezvous barrier) produce a
    multi-member gzip whose decompressed bytes equal the single-host fast
    pipeline's output exactly."""
    import contextlib
    import gzip
    import io
    import threading

    from nimble_tpu import native
    from nimble_tpu.pipeline.bam_fast import process_fast

    if not native.available():
        pytest.skip("native library required")
    bam, reference, index, cfg = _bam_workload(tmp_path)

    single_out = str(tmp_path / "single.tsv.gz")
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(
            [bam], [DeviceAlignEngine(index, cfg)], [reference], [cfg],
            [single_out], 2, False, parity_quirks=quirks,
        )
    expected = gzip.open(single_out, "rb").read()

    bar = threading.Barrier(2, timeout=120)

    def ag_bytes(payload):
        bar.wait()
        return [payload, payload]

    mh_out = str(tmp_path / "mh.tsv.gz")
    errors = []

    def run_host(hid):
        try:
            multihost.process_bam_multihost(
                bam, [DeviceAlignEngine(index, cfg)], [reference], [cfg],
                [mh_out], False, n_hosts=2, host_id=hid,
                parity_quirks=quirks, batch_records=64,
                allgather_bytes=ag_bytes,
            )
        except Exception as e:  # surfaced below
            errors.append(e)
            try:
                bar.abort()
            except Exception:
                pass

    threads = [threading.Thread(target=run_host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    assert gzip.open(mh_out, "rb").read() == expected


def test_real_two_process_cli_bam(tmp_path):
    """--num-processes with a BAM input: two real jax.distributed processes
    produce decompressed bytes identical to the single-process CLI."""
    import gzip

    from nimble_tpu import native

    if not native.available():
        pytest.skip("native library required")
    bam, reference, index, cfg = _bam_workload(tmp_path)
    # library JSON for the CLI
    import json

    feats = reference.columns[1][0::2]
    names = reference.columns[0][0::2]
    lib = [
        {"score_percent": 0.2, "score_filter": 25, "score_threshold": 40,
         "num_mismatches": 1, "discard_multiple_matches": False,
         "require_valid_pair": False, "discard_multi_hits": 0,
         "intersect_level": 0, "max_hits_to_report": 8, "group_on": "",
         "trim_target_length": 0, "trim_strictness": 0.5},
        {"headers": ["sequence_name", "sequence"],
         "columns": [list(names), list(feats)]},
    ]
    libp = str(tmp_path / "lib.json")
    with open(libp, "w") as f:
        json.dump(lib, f)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "/root/repo"

    single_out = str(tmp_path / "single.tsv.gz")
    rc = subprocess.run(
        [sys.executable, "-m", "nimble_tpu.cli",
         "-r", libp, "-i", bam, "-o", single_out, "-c", "2"],
        env=env, capture_output=True, timeout=150,
    )
    assert rc.returncode == 0, rc.stderr.decode()[-2000:]
    expected = gzip.open(single_out, "rb").read()

    mh_out = str(tmp_path / "mh.tsv.gz")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nimble_tpu.cli",
             "-r", libp, "-i", bam, "-o", mh_out, "-c", "2",
             "--num-processes", "2", "--process-id", str(i),
             "--coordinator", f"127.0.0.1:{port}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed BAM CLI timed out")
        assert p.returncode == 0, stderr.decode()[-2000:]

    assert gzip.open(mh_out, "rb").read() == expected


def test_simulated_two_host_bam_empty_output(tmp_path):
    """A BAM whose reads hit nothing produces the single-host pipeline's
    empty-content gzip (no header) in multi-host mode too."""
    import contextlib
    import gzip
    import io
    import threading

    from nimble_tpu import native
    from nimble_tpu.config import AlignFilterConfig
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.library import Reference
    from nimble_tpu.pipeline.bam_fast import process_fast
    from nimble_tpu.utils.dna import revcomp

    if not native.available():
        pytest.skip("native library required")
    rng = np.random.default_rng(23)
    feats = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(2)]
    junk = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(2)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    names = [n for i in range(2) for n in (f"f{i}", f"f{i}§rev")]
    reference = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0, sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=4, score_percent=0.2, score_threshold=40,
        num_mismatches=0, max_hits_to_report=8,
    )
    index = build_index(doubled)
    bam = str(tmp_path / "junk.bam")
    make_synthetic_bam(bam, junk, n_groups=4, pairs_per_group=2, read_len=80,
                       seed=23)

    single_out = str(tmp_path / "single.tsv.gz")
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(
            [bam], [DeviceAlignEngine(index, cfg)], [reference], [cfg],
            [single_out], 2, False,
        )
    expected = gzip.open(single_out, "rb").read()
    assert expected == b""  # no rows, no header — the single-host quirk

    bar = threading.Barrier(2, timeout=120)

    def ag_bytes(payload):
        bar.wait()
        return [payload, payload]

    mh_out = str(tmp_path / "mh.tsv.gz")
    errors = []

    def run_host(hid):
        try:
            multihost.process_bam_multihost(
                bam, [DeviceAlignEngine(index, cfg)], [reference], [cfg],
                [mh_out], False, n_hosts=2, host_id=hid,
                batch_records=64, allgather_bytes=ag_bytes,
            )
        except Exception as e:
            errors.append(e)
            try:
                bar.abort()
            except Exception:
                pass

    threads = [threading.Thread(target=run_host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    assert gzip.open(mh_out, "rb").read() == expected


def test_owner_hash_native_matches_fallback_and_pad_invariant():
    """Ownership must depend only on read CONTENT: the native hash, the
    NumPy fallback, and any pad width must all agree (a pad-width-dependent
    hash would route two copies of one read to different owners and defeat
    the global dedupe)."""
    import unittest.mock as um

    from nimble_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    n = 2000
    mat = rng.integers(0, 4, (n, 90)).astype(np.int8)
    lens = rng.integers(40, 91, n).astype(np.int32)
    mat[np.arange(90)[None, :] >= lens[:, None]] = 0
    m2 = rng.integers(0, 4, (n, 77)).astype(np.int8)
    l2 = rng.integers(40, 78, n).astype(np.int32)
    m2[np.arange(77)[None, :] >= l2[:, None]] = 0

    nat = multihost._read_owner_hash(mat, lens, 5, m2, l2)
    with um.patch.object(native, "owner_hash", lambda *a, **k: None):
        fb = multihost._read_owner_hash(mat, lens, 5, m2, l2)
    assert (nat == fb).all()

    wide = np.zeros((n, 128), dtype=np.int8)
    wide[:, :90] = mat
    assert (multihost._read_owner_hash(wide, lens, 5, m2, l2) == nat).all()

    single_end = multihost._read_owner_hash(mat, lens, 3)
    with um.patch.object(native, "owner_hash", lambda *a, **k: None):
        assert (multihost._read_owner_hash(mat, lens, 3) == single_end).all()


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(8)
    for L in (1, 3, 40, 90, 91):
        mat = rng.integers(0, 4, (37, L)).astype(np.int8)
        u = multihost._unpack2bit(multihost._pack2bit(mat))
        assert u.shape[1] >= L and (u[:, :L] == mat).all()
        assert (u[:, L:] == 0).all()


def _exchanging_allgather(n):
    """Simulated allgather that actually exchanges per-host payloads."""
    import threading

    cond = threading.Condition()
    state = {"items": [], "result": None, "gen": 0}

    def ag(payload):
        with cond:
            gen = state["gen"]
            state["items"].append(payload)
            if len(state["items"]) == n:
                state["result"] = list(state["items"])
                state["items"] = []
                state["gen"] += 1
                cond.notify_all()
                return list(state["result"])
            while state["gen"] == gen:
                if not cond.wait(timeout=120):
                    raise RuntimeError("simulated allgather timed out")
            return list(state["result"])

    return ag


def test_two_host_bam_ignores_stale_part_files(tmp_path):
    """Part files left behind by a crashed previous run must not leak into
    the merged output (each host clears its own parts before writing)."""
    import contextlib
    import gzip
    import io
    import threading

    from nimble_tpu import native
    from nimble_tpu.pipeline.bam_fast import process_fast

    if not native.available():
        pytest.skip("native library required")
    bam, reference, index, cfg = _bam_workload(tmp_path)

    single_out = str(tmp_path / "single.tsv.gz")
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(
            [bam], [DeviceAlignEngine(index, cfg)], [reference], [cfg],
            [single_out], 2, False,
        )
    expected = gzip.open(single_out, "rb").read()

    mh_out = str(tmp_path / "mh.tsv.gz")
    # stale parts from a hypothetical earlier crashed run
    for h in (0, 1):
        with gzip.open(f"{mh_out}.part{h}", "wb") as f:
            f.write(b"STALE ROWS FROM A PREVIOUS RUN\n")

    ag = _exchanging_allgather(2)
    errors = []

    def run_host(hid):
        try:
            multihost.process_bam_multihost(
                bam, [DeviceAlignEngine(index, cfg)], [reference], [cfg],
                [mh_out], False, n_hosts=2, host_id=hid,
                batch_records=64, allgather_bytes=ag,
            )
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run_host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    got = gzip.open(mh_out, "rb").read()
    assert b"STALE" not in got
    assert got == expected


def test_two_host_bam_peer_failure_aborts_merge(tmp_path):
    """If one host fails during alignment, the surviving host must abort
    (no plausible-but-incomplete merged output) instead of deadlocking at
    the post-merge rendezvous."""
    import contextlib
    import io
    import threading

    from nimble_tpu import native

    if not native.available():
        pytest.skip("native library required")
    bam, reference, index, cfg = _bam_workload(tmp_path)
    mh_out = str(tmp_path / "mh.tsv.gz")

    import nimble_tpu.pipeline.bam_fast as bf

    real = bf._finish_batch
    fail_thread = {}

    def flaky(ctx, workers, collected=None):
        if threading.current_thread().name == fail_thread.get("name"):
            raise ValueError("injected device failure on host 1")
        return real(ctx, workers, collected)

    ag = _exchanging_allgather(2)
    results = {}

    def run_host(hid):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                multihost.process_bam_multihost(
                    bam, [DeviceAlignEngine(index, cfg)], [reference], [cfg],
                    [mh_out], False, n_hosts=2, host_id=hid,
                    batch_records=64, allgather_bytes=ag,
                )
            results[hid] = None
        except Exception as e:
            results[hid] = e

    bf._finish_batch = flaky
    try:
        threads = [
            threading.Thread(target=run_host, args=(h,), name=f"mh-host-{h}")
            for h in (0, 1)
        ]
        fail_thread["name"] = "mh-host-1"
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive(), "multihost run deadlocked"
    finally:
        bf._finish_batch = real

    assert isinstance(results.get(1), ValueError)           # its own error
    assert isinstance(results.get(0), RuntimeError)          # peer-abort
    assert "failed" in str(results[0])
    assert not os.path.exists(mh_out)                        # nothing merged
