"""Byte-level golden test of the 84-column BAM forensic TSV.

The fixtures pin the full output bytes (value formatting, r1/r2 swap
quirks, zero rows, dropped-final-group behavior) for a frozen synthetic
BAM, in both quirk modes, across the slow pipeline (host + device engines)
and the columnar fast pipeline.  Any regression in `format_log_row`, the
metadata field derivation, or the quirk handling breaks these bytes.

Fixture provenance: tests/data/golden/forensic.bam was generated by
`make_synthetic_bam(seed=99)` over a 5-feature random library (seed 12345);
the expected TSVs are the decompressed slow-pipeline outputs at the time
the behavior was verified against the reference's format
(`src/process/bam.rs:90-121`).
"""

import contextlib
import gzip
import io
import os

import pytest

from chip_smoke import forensic_workload as _workload
from nimble_tpu.core.calls import HostAlignEngine
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.pipeline import bam_pipeline

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "golden")
BAM = os.path.join(GOLDEN_DIR, "forensic.bam")


def _expected(quirks: bool) -> bytes:
    name = "forensic_quirks.tsv" if quirks else "forensic_noquirks.tsv"
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("engine_kind", ["host", "device", "fast"])
def test_forensic_tsv_bytes(tmp_path, quirks, engine_kind):
    reference, index, cfg = _workload()
    out = str(tmp_path / "out.tsv.gz")
    if engine_kind == "fast":
        from nimble_tpu.pipeline.bam_fast import process_fast

        engine = DeviceAlignEngine(index, cfg)
        with contextlib.redirect_stdout(io.StringIO()):
            process_fast([BAM], [engine], [reference], [cfg], [out], 2, False,
                         parity_quirks=quirks)
    else:
        engine = (HostAlignEngine(index, cfg) if engine_kind == "host"
                  else DeviceAlignEngine(index, cfg))
        with contextlib.redirect_stdout(io.StringIO()):
            bam_pipeline.process([BAM], [engine], [reference], [cfg], [out],
                                 2, False, parity_quirks=quirks)
    with gzip.open(out, "rb") as f:
        got = f.read()
    assert got == _expected(quirks)


def test_golden_header_is_84_columns():
    header = _expected(True).split(b"\n", 1)[0]
    assert len(header.split(b"\t")) == 84
