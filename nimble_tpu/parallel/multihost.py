"""Multi-host (multi-process) execution scaffolding.

The reference is a single-node CLI; this design (SURVEY.md §2c) scales the
FASTQ counting workload across processes (hosts, or one process per device
on one host):

  * each host reads a disjoint RECORD RANGE of the input file(s);
  * reads are routed to an OWNER host by content hash (exact global
    dedupe: the score map is keyed by read bytes, `src/align.rs:574-579`,
    and a duplicate read must count once no matter which host parsed it);
  * each host aligns + counts its owned reads with the normal engine /
    FastCounter stack (chips inside a host via the mesh engine);
  * per-callset counts merge across hosts (disjoint read ownership means
    counts simply add), and every host deterministically derives the same
    final sorted table; process 0 writes it.

Process bootstrap is `jax.distributed.initialize`; cross-process data moves
through `multihost_utils.process_allgather`.  The routing exchange
broadcasts the (packed) chunk and filters locally — the same routing could
ride `jax.lax.all_to_all`, but allgather is exact, simple, and the FASTQ
payloads (2-bit packed) are small next to the alignment work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """`jax.distributed.initialize` wrapper (no-op when single-process)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_record_range(n_records: int, n_hosts: int, host_id: int) -> Tuple[int, int]:
    """[lo, hi) of the records this host parses (balanced contiguous split)."""
    lo = host_id * n_records // n_hosts
    hi = (host_id + 1) * n_records // n_hosts
    return lo, hi


def _read_owner_hash(mat: np.ndarray, lens: np.ndarray, n_hosts: int,
                     mate_mat: Optional[np.ndarray] = None,
                     mate_lens: Optional[np.ndarray] = None) -> np.ndarray:
    """Owner host per read(-pair) from its exact content bytes (FNV-1a over
    each row's lens[i] bytes — NEVER the padded tail, so hosts holding the
    same read at different pad widths agree — with the length mixed in).
    Paired reads hash BOTH mates: the score-map key is the pair
    (`src/align.rs:574-579`), so all copies of a pair must share an owner.
    Native C++ (threaded) with a masked-NumPy fallback.
    """
    from nimble_tpu import native

    got = native.owner_hash(mat, lens, n_hosts, mate_mat, mate_lens)
    if got is not None:
        return got

    def mix(h, m, ls):
        ls = np.asarray(ls, dtype=np.uint64)
        for j in range(m.shape[1]):
            live = np.uint64(j) < ls
            hx = (h ^ m[:, j].astype(np.uint8).astype(np.uint64)) * np.uint64(
                0x100000001B3)
            h = np.where(live, hx, h)
        return (h ^ ls) * np.uint64(0x100000001B3)

    h = np.full(mat.shape[0], 0x811C9DC5, dtype=np.uint64)
    h = mix(h, mat, lens)
    if mate_mat is not None:
        h = mix(h, mate_mat, mate_lens)
    return (h % np.uint64(n_hosts)).astype(np.int64)


def _stack_owned(mats: List[np.ndarray], lens_list: List[np.ndarray]):
    """Concatenate per-host owned (mat, lens) shards, re-padding widths."""
    width = max((m.shape[1] for m in mats if m.shape[0]), default=1)
    total = sum(m.shape[0] for m in mats)
    out = np.zeros((total, width), dtype=np.int8)
    out_lens = np.zeros(total, dtype=np.int32)
    at = 0
    for m, l in zip(mats, lens_list):
        if not m.shape[0]:
            continue
        out[at : at + m.shape[0], : m.shape[1]] = m
        out_lens[at : at + m.shape[0]] = l
        at += m.shape[0]
    return out, out_lens


def _pack2bit(mat: np.ndarray) -> np.ndarray:
    """(n, L) int8 codes -> (n, ceil(L/4)) uint8 (wire format: 4x smaller
    collectives; code matrices are zero-padded beyond the read length).

    Strided slice ops only — fancy-index variants promote to int64 and run
    ~100x slower on multi-million-read shards."""
    n, L = mat.shape
    nb = (max(L, 1) + 3) // 4
    m = np.zeros((n, nb * 4), dtype=np.uint8)
    m[:, :L] = mat.astype(np.uint8, copy=False)
    m3 = m.reshape(n, nb, 4)
    return (m3[:, :, 0] | (m3[:, :, 1] << 2) | (m3[:, :, 2] << 4)
            | (m3[:, :, 3] << 6))


def _unpack2bit(packed: np.ndarray) -> np.ndarray:
    n, nb = packed.shape
    out = np.empty((n, nb * 4), dtype=np.uint8)
    out[:, 0::4] = packed & 3
    out[:, 1::4] = (packed >> 2) & 3
    out[:, 2::4] = (packed >> 4) & 3
    out[:, 3::4] = packed >> 6
    return out.view(np.int8)


def exchange_reads_by_content(
    mat: np.ndarray,
    lens: np.ndarray,
    n_hosts: int,
    host_id: int,
    allgather=None,
    mate_mat: Optional[np.ndarray] = None,
    mate_lens: Optional[np.ndarray] = None,
    local_seen=None,
):
    """Route reads to content-hash owners; returns this host's owned reads
    — ``(mat, lens)`` single-end, ``(mat, lens, mate_mat, mate_lens)``
    paired.

    ``allgather(list_of_arrays) -> list over hosts`` defaults to
    `multihost_utils.process_allgather` with padding to a common shape; a
    test shim can inject a local implementation.

    Wire discipline: reads are LOCALLY deduped first (``local_seen``, a
    native dedupe set — dropping a host-local duplicate cannot change the
    global score map) and travel 2-bit packed (4x smaller collectives).
    """
    paired = mate_mat is not None
    if n_hosts <= 1:
        return (mat, lens, mate_mat, mate_lens) if paired else (mat, lens)
    if allgather is None:
        allgather = _process_allgather_padded

    if local_seen is not None:
        from nimble_tpu.core.fast_count import dedupe_admit

        mat, lens, mate_mat, mate_lens, _ = dedupe_admit(
            local_seen, mat, lens, mate_mat, mate_lens
        )

    owner = _read_owner_hash(mat, lens, n_hosts, mate_mat, mate_lens)
    if paired:
        payload = [_pack2bit(mat), lens, _pack2bit(mate_mat), mate_lens,
                   owner]
    else:
        payload = [_pack2bit(mat), lens, owner]
    gathered = allgather(payload)
    picks = [g[-1] == host_id for g in gathered]
    out, out_lens = _stack_owned(
        [_unpack2bit(g[0][p]) for g, p in zip(gathered, picks)],
        [g[1][p] for g, p in zip(gathered, picks)],
    )
    if paired:
        out2, out2_lens = _stack_owned(
            [_unpack2bit(g[2][p]) for g, p in zip(gathered, picks)],
            [g[3][p] for g, p in zip(gathered, picks)],
        )
        return out, out_lens, out2, out2_lens
    return out, out_lens


def _process_allgather_padded(arrays: Sequence[np.ndarray]):
    """allgather a per-host array list across processes.

    Arrays are matched positionally across hosts; index 0's leading dim is
    the host's record count.  Hosts may hold different record counts and
    2-D widths; everything is padded to the global maximum before the
    collective and trimmed after.  1-D int64 arrays pad with -1 (owner ids
    must not collide with a real host id); everything else pads with 0.
    """
    from jax.experimental import multihost_utils as mh

    n = arrays[0].shape[0]
    widths = [a.shape[1] if a.ndim == 2 else 0 for a in arrays]
    dims = np.asarray(
        mh.process_allgather(np.array([n] + widths, dtype=np.int64))
    ).reshape(-1, 1 + len(arrays))
    n_max = int(dims[:, 0].max())

    per_host: List[List[np.ndarray]] = [[] for _ in range(dims.shape[0])]
    for ai, a in enumerate(arrays):
        if a.ndim == 2:
            w_max = int(dims[:, 1 + ai].max())
            pad = np.zeros((n_max, w_max), dtype=a.dtype)
            pad[:n, : a.shape[1]] = a
        else:
            fill = -1 if a.dtype == np.int64 else 0
            pad = np.full(n_max, fill, dtype=a.dtype)
            pad[:n] = a
        g = np.asarray(mh.process_allgather(pad))
        for h in range(dims.shape[0]):
            per_host[h].append(g[h, : int(dims[h, 0])])
    return [tuple(x) for x in per_host]


def merge_host_results(
    local_results,
    allgather_bytes=None,
):
    """Merge per-host FastCounter results into the global sorted table.

    ``local_results`` is `FastCounter.finalize()` output over this host's
    OWNED reads (disjoint across hosts), so per-callset counts add.  Every
    host computes the identical merged table (deterministic), process 0
    writes it.  ``allgather_bytes(payload: bytes) -> list[bytes]`` defaults
    to a process_allgather of the pickled payload.
    """
    import pickle

    payload = pickle.dumps(
        [(tuple(callset), entry[0]) for callset, entry in local_results]
    )
    if allgather_bytes is None:
        allgather_bytes = _allgather_bytes
    merged: dict = {}
    for blob in allgather_bytes(payload):
        for callset, count in pickle.loads(blob):
            merged[callset] = merged.get(callset, 0) + count
    out = [(list(cs), (count, [], [])) for cs, count in merged.items()]
    from nimble_tpu.core.calls import sort_score_vector

    return sort_score_vector(out)


def _allgather_bytes(payload: bytes):
    from jax.experimental import multihost_utils as mh

    n = len(payload)
    sizes = np.asarray(mh.process_allgather(np.array([n], dtype=np.int64)))
    n_max = int(sizes.max())
    buf = np.zeros(n_max, dtype=np.uint8)
    buf[:n] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(mh.process_allgather(buf))
    sizes = sizes.reshape(-1)
    return [gathered[h, : int(sizes[h])].tobytes() for h in range(gathered.shape[0])]


def barrier(allgather_bytes=None) -> int:
    """Cross-process rendezvous; returns the number of participants."""
    if allgather_bytes is None:
        allgather_bytes = _allgather_bytes
    return len(allgather_bytes(b"\x00"))


def host_group_range(n_groups: int, n_hosts: int, host_id: int) -> Tuple[int, int]:
    """[lo, hi) of the UMI x CB groups this host aligns (contiguous split —
    the BAM stream's group order is semantic, `src/parse/bam.rs:178`, so
    shards must be contiguous runs of it)."""
    return host_record_range(n_groups, n_hosts, host_id)


def process_bam_multihost(
    input_path: str,
    engines,
    references,
    configs,
    output_paths,
    force_bam_paired: bool,
    *,
    n_hosts: Optional[int] = None,
    host_id: Optional[int] = None,
    parity_quirks: bool = True,
    batch_records: int = 16384,
    allgather_bytes=None,
):
    """Multi-host BAM forensic pipeline: group-range sharding.

    Every host scans the stream once to count UMI x CB groups (C++ scan,
    no alignment), takes a contiguous group range, aligns + packages only
    its range on a second pass, and writes ``{out}.part{host_id}`` — a
    complete gzip member.  After a barrier, process 0 concatenates the
    parts (multi-member gzip is a valid gzip stream): the decompressed
    bytes equal the single-host pipeline's output exactly, group order
    preserved.  The dropped-final-group quirk applies to the GLOBAL last
    group.  Requires the native library (columnar fast path).
    """
    import gzip as _gzip

    import jax

    from nimble_tpu.io.bam_columnar import ColumnarGroupStream
    from nimble_tpu.pipeline.bam_fast import (
        _LibraryWorker,
        _finish_batch,
        _prepare_batch,
    )
    from nimble_tpu.pipeline.bam_pipeline import log_header, validate_gzip

    if n_hosts is None:
        n_hosts = jax.process_count()
    if host_id is None:
        host_id = jax.process_index()
    if allgather_bytes is None and n_hosts > 1:
        if jax.process_count() != n_hosts:
            raise RuntimeError(
                f"--num-processes={n_hosts} but this jax job has "
                f"{jax.process_count()} process(es); jax.distributed is not "
                "initialized across the hosts")

    # pass 1: count groups (scan only — no device work)
    total_groups = 0
    _count_stream = ColumnarGroupStream(input_path, force_bam_paired)
    for b in _count_stream.batches(batch_records):
        total_groups += b.n_groups
    effective = total_groups
    if parity_quirks and _count_stream.final_open_group_pending:
        effective -= 1  # the reference never sends the final open group
    lo, hi = host_group_range(effective, n_hosts, host_id)

    workers = [
        _LibraryWorker(e, r, c)
        for e, r, c in zip(engines, references, configs)
    ]
    import os
    import shutil

    # part files open lazily on the first row block (the single-host logger
    # writes nothing at all — not even the header — for a library with no
    # rows, `src/process/bam.rs:90-101`; no part file = no content).  Each
    # host clears ITS OWN part files first: a crashed previous run can leave
    # stale parts behind, and lazy creation would otherwise let the merge
    # concatenate them into this run's output.
    parts = [f"{p}.part{host_id}" for p in output_paths]
    for p in parts:
        if os.path.exists(p):
            os.remove(p)
    files: list = [None] * len(parts)
    header = (log_header() + "\n").encode()

    def write_rows(i: int, blob: bytes) -> None:
        if files[i] is None:
            files[i] = _gzip.open(parts[i], "wb", compresslevel=6)
        files[i].write(blob)

    ag = allgather_bytes if allgather_bytes is not None else _allgather_bytes
    ok = False
    try:
        # pass 2: align + package only this host's groups (dispatch N+1's
        # device work before packaging N, like the threaded consumer)
        g_seen = 0
        pending = None
        for b in ColumnarGroupStream(input_path, force_bam_paired).batches(
            batch_records
        ):
            b_lo, b_hi = g_seen, g_seen + b.n_groups
            g_seen = b_hi
            if b_hi <= lo or b_lo >= hi:
                continue
            sub = b.slice_groups(lo - b_lo, hi - b_lo)
            if not len(sub):
                continue
            ctx = _prepare_batch(sub, workers)
            if pending is not None:
                for i, rows in enumerate(_finish_batch(pending, workers)):
                    for blob in rows:
                        write_rows(i, blob)
            pending = ctx
        if pending is not None:
            for i, rows in enumerate(_finish_batch(pending, workers)):
                for blob in rows:
                    write_rows(i, blob)
        for f in files:
            if f is not None:
                f.close()
        ok = True
    finally:
        # reach the rendezvous even on failure so peer hosts don't block
        # forever in the collective — and carry this host's status so
        # surviving peers ABORT instead of merging an output that silently
        # misses the failed host's group range (and then deadlocking at the
        # post-merge rendezvous this host would never reach)
        if ok:
            statuses = ag(b"\x01")
        else:
            try:
                ag(b"\x00")
            except Exception:
                pass  # keep the original exception propagating
    if any(s != b"\x01" for s in statuses):
        failed = [h for h, s in enumerate(statuses) if s != b"\x01"]
        raise RuntimeError(
            f"multi-host BAM run aborted: host(s) {failed} failed during "
            "alignment; no merged output was written"
        )
    if host_id == 0:
        for out in output_paths:
            # header member iff any host produced rows (single-host parity:
            # an empty run yields an empty-content gzip, no header)
            any_rows = any(
                os.path.exists(f"{out}.part{h}") for h in range(n_hosts)
            )
            with _gzip.open(out, "wb", compresslevel=6) as dst_gz:
                if any_rows:
                    dst_gz.write(header)
            if any_rows:
                with open(out, "ab") as dst:
                    for h in range(n_hosts):
                        part = f"{out}.part{h}"
                        if not os.path.exists(part):
                            continue
                        with open(part, "rb") as sf:
                            shutil.copyfileobj(sf, dst)
            validate_gzip(out)
    barrier(allgather_bytes)
    for p in parts:
        if os.path.exists(p):
            os.remove(p)


def process_fastq_multihost(
    input_path: str,
    engine,
    reference,
    config,
    output_path: Optional[str],
    *,
    mate_path: Optional[str] = None,
    n_hosts: Optional[int] = None,
    host_id: Optional[int] = None,
    chunk_reads: int = 1 << 16,
    allgather=None,
    allgather_bytes=None,
):
    """Multi-host FASTQ counting: per-host record ranges -> content-hash
    routing -> local align/count -> global merge.  Paired-end when
    ``mate_path`` is given (pairs are routed and counted as units).

    Returns the merged results (every host); only process 0 (or the caller)
    should write ``output_path``.
    """
    import os

    import jax

    from nimble_tpu.core.fast_count import FastCounter
    from nimble_tpu.io.fastq import (
        is_gzip,
        read_fastq_matrix,
        read_fastq_matrix_byterange,
    )

    if n_hosts is None:
        n_hosts = jax.process_count()
    if host_id is None:
        host_id = jax.process_index()
    if allgather is None and allgather_bytes is None and n_hosts > 1:
        # running on the REAL collectives: the jax job must actually span
        # the claimed hosts, else every allgather silently returns only the
        # local shard and ~owned/n_hosts of the counts vanish
        if jax.process_count() != n_hosts:
            raise RuntimeError(
                f"--num-processes={n_hosts} but this jax job has "
                f"{jax.process_count()} process(es); jax.distributed is not "
                "initialized across the hosts")

    import sys
    import time as _time

    from nimble_tpu import native

    _timing = bool(os.environ.get("NIMBLE_TIMING"))
    _t0 = _time.time()

    local_seen = native.make_dedupe_set()
    if mate_path is None and not is_gzip(input_path):
        # scaling feed: each host READS AND PARSES only ~1/n of the file
        # (byte range snapped to record boundaries); content-hash routing
        # makes the final counts partition-independent
        size = os.path.getsize(input_path)
        mat, lens = read_fastq_matrix_byterange(
            input_path, size * host_id // n_hosts,
            size * (host_id + 1) // n_hosts,
        )
        lo, hi = 0, mat.shape[0]
    else:
        # gzip streams aren't seekable and mates pair by record index:
        # fall back to a full parse sliced by record range
        mat, lens = read_fastq_matrix(input_path)
        lo, hi = host_record_range(mat.shape[0], n_hosts, host_id)
    _t_parse = _time.time() - _t0
    _t0 = _time.time()
    if mate_path is not None:
        mate_mat, mate_lens = read_fastq_matrix(mate_path)
        if mate_mat.shape[0] < mat.shape[0]:
            raise ValueError(
                "Error -- read and reverse read files do not have matching "
                "lengths: "
            )
        own_mat, own_lens, own_m2, own_l2 = exchange_reads_by_content(
            mat[lo:hi], lens[lo:hi], n_hosts, host_id, allgather=allgather,
            mate_mat=mate_mat[lo:hi], mate_lens=mate_lens[lo:hi],
            local_seen=local_seen,
        )
    else:
        own_mat, own_lens = exchange_reads_by_content(
            mat[lo:hi], lens[lo:hi], n_hosts, host_id, allgather=allgather,
            local_seen=local_seen,
        )
        own_m2 = own_l2 = None
    _t_exch = _time.time() - _t0
    _t0 = _time.time()

    counter = FastCounter(engine, reference, config)
    pending = None
    for clo in range(0, own_mat.shape[0], chunk_reads):
        chunk = counter.dispatch(
            own_mat[clo : clo + chunk_reads],
            own_lens[clo : clo + chunk_reads],
            own_m2[clo : clo + chunk_reads] if own_m2 is not None else None,
            own_l2[clo : clo + chunk_reads] if own_l2 is not None else None,
        )
        if pending is not None:
            counter.process(pending)
        pending = chunk
    if pending is not None:
        counter.process(pending)
    local = counter.finalize()
    _t_align = _time.time() - _t0
    _t0 = _time.time()

    merged = merge_host_results(local, allgather_bytes=allgather_bytes)
    if _timing:
        print(
            f"[multihost host {host_id}] parse {_t_parse:.2f}s "
            f"exchange {_t_exch:.2f}s align {_t_align:.2f}s "
            f"merge {_time.time() - _t0:.2f}s "
            f"({own_mat.shape[0]} owned reads)",
            file=sys.stderr,
        )
    if output_path is not None and host_id == 0:
        from nimble_tpu.io.writers import write_to_tsv

        write_to_tsv(
            [(features, entry[0]) for features, entry in merged], output_path
        )
    return merged
