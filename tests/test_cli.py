"""CLI end-to-end: FASTQ and BAM dispatch, trim overrides, error paths."""

import gzip
import json

import pytest

from nimble_tpu.cli import main
from nimble_tpu.io.synth import make_synthetic_bam

from conftest import library_path, reads_path


def test_cli_fastq_host_engine(tmp_path, capsys):
    out = str(tmp_path / "out.tsv")
    rc = main([
        "-r", library_path("basic.json"),
        "-i", reads_path("basic.fastq"),
        "-o", out,
        "-f", "none",
        "--engine", "host",
    ])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert lines[0] == "feature\tscore"
    assert lines[1:] == [
        "A02-0\tA02-1\tA02-2\tA02-LC\t1",
        "A02-0\tA02-LC\t1",
        "A02-1\t1",
    ]


def test_cli_bam(tmp_path):
    lib = json.load(open(library_path("mismatch.json")))
    gene = lib[1]["columns"][3][0]
    bam = str(tmp_path / "in.bam")
    make_synthetic_bam(bam, [gene], n_groups=3, pairs_per_group=1, seed=5)
    out = str(tmp_path / "out.tsv.gz")
    rc = main([
        "-r", library_path("mismatch.json"),
        "-i", bam,
        "-o", out,
        "-c", "2",
        "--engine", "host",
    ])
    assert rc == 0
    with gzip.open(out, "rt") as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("nimble_features\tnimble_score\tr1_QNAME")
    assert any(ln.startswith("gene\t1") for ln in lines[1:])


def test_cli_trim_count_mismatch(tmp_path):
    with pytest.raises(SystemExit, match="number of trim options"):
        main([
            "-r", library_path("basic.json"),
            "-i", reads_path("basic.fastq"),
            "-o", str(tmp_path / "o.tsv"),
            "-t", "40:0.9,50:0.5",
            "--engine", "host",
        ])


def test_cli_unsupported_format(tmp_path):
    bad = tmp_path / "reads.txt"
    bad.write_text("hi")
    with pytest.raises(SystemExit, match="Unsupported file format: txt"):
        main([
            "-r", library_path("basic.json"),
            "-i", str(bad),
            "-o", str(tmp_path / "o.tsv"),
            "--engine", "host",
        ])


def test_cli_bad_strand_filter(tmp_path):
    with pytest.raises(ValueError, match="Could not parse strand_filter"):
        main([
            "-r", library_path("basic.json"),
            "-i", reads_path("basic.fastq"),
            "-o", str(tmp_path / "o.tsv"),
            "-f", "bogus",
            "--engine", "host",
        ])


def test_cli_fastq_mesh_engine(tmp_path):
    """--engine mesh on the 8-virtual-device CPU mesh: byte-exact TSV."""
    out = str(tmp_path / "mesh.tsv")
    rc = main([
        "-r", library_path("basic.json"),
        "-i", reads_path("basic.fastq"),
        "-o", out,
        "--engine", "mesh",
    ])
    assert rc == 0
    assert open(out).read().splitlines() == [
        "feature\tscore",
        "A02-0\tA02-1\tA02-2\tA02-LC\t1",
        "A02-0\tA02-LC\t1",
        "A02-1\t1",
    ]


def test_cli_fastq_mesh_two_libraries(tmp_path):
    """--engine mesh with two libraries takes the mesh-sharded stacked
    dispatcher over the CLI's default mesh; each TSV equals the host
    oracle's single-library run."""
    libs = [library_path("basic.json"), library_path("basic-rev.json")]
    mesh_outs = [str(tmp_path / f"mesh{i}.tsv") for i in range(2)]
    rc = main(["-r", libs[0], "-r", libs[1], "-i", reads_path("basic.fastq"),
               "-o", mesh_outs[0], "-o", mesh_outs[1], "--engine", "mesh"])
    assert rc == 0
    for lib, got in zip(libs, mesh_outs):
        want = str(tmp_path / "host.tsv")
        assert main(["-r", lib, "-i", reads_path("basic.fastq"), "-o", want,
                     "--engine", "host"]) == 0
        assert open(got).read() == open(want).read()
        assert len(open(got).read().splitlines()) > 1
        (tmp_path / "host.tsv").unlink()
