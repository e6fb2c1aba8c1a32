"""chip_smoke.py and the GPU bring-up surface, checked on the CPU.

The smoke's phase functions run here at a tiny size with the same exact
device-vs-host comparisons they make on the card; tests marked ``gpu``
skip here and run their bodies on the card through ``python chip_smoke.py``.
"""

import types

import pytest

import bench
import chip_smoke
from nimble_tpu.config import AlignFilterConfig
from nimble_tpu.index.build import build_index
from nimble_tpu.models.aligner import WALK_MODES, DeviceAlignEngine
from nimble_tpu.utils import compile_cache


@pytest.mark.parametrize("env_value", ["/somewhere/else/cache", None])
def test_compile_cache_dir(monkeypatch, env_value):
    if env_value is None:
        monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
        want = str(compile_cache.DEFAULT_DIR)
        # one fixed directory inside the checkout, from the package path
        assert compile_cache.DEFAULT_DIR.parent == (
            compile_cache.pathlib.Path(chip_smoke.REPO))
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
    else:
        monkeypatch.setenv(compile_cache.CACHE_ENV, env_value)
        want = env_value
    assert compile_cache.cache_dir() == want
    assert compile_cache.cache_dir() == want  # stable across calls


def test_chip_smoke_refuses_cpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert "card:" in out  # the nvidia-smi line comes first, card or not


@pytest.fixture(scope="module")
def tiny_inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    return work, chip_smoke.make_inputs(work, chip_smoke.TINY, seed=5)


def test_smoke_fastq_phase_tiny(tiny_inputs):
    work, inp = tiny_inputs
    results = chip_smoke.phase_fastq(work, inp, chip_smoke.TINY)
    assert [r.name for r in results] == [
        "fastq_full_device", "fastq_sample_device", "fastq_sample_host"]


def test_smoke_two_library_phase_tiny(tiny_inputs):
    work, inp = tiny_inputs
    results = chip_smoke.phase_two_libraries(work, inp, chip_smoke.TINY)
    assert [r.items for r in results] == [chip_smoke.TINY.sample] * 2


def test_smoke_bam_phase_tiny(tiny_inputs):
    work, inp = tiny_inputs
    results = chip_smoke.phase_bam(work, inp, chip_smoke.TINY, seed=5)
    assert [(r.name, r.items) for r in results] == [
        ("bam_full_device", chip_smoke.TINY.bam_records),
        ("bam_compare_device", chip_smoke.TINY.bam_compare_records),
        ("bam_compare_host", chip_smoke.TINY.bam_compare_records),
    ]


def test_smoke_oracle_fixtures_phase(tmp_path):
    result = chip_smoke.phase_oracle_fixtures(str(tmp_path))
    assert result.items == 9  # 8 library x reads x mismatch cases + golden


def test_smoke_mismatch_is_reported(tmp_path):
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    a.write_text("feature\tscore\nx\t1\n")
    b.write_text("feature\tscore\nx\t2\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="device vs host"):
        chip_smoke.same_outputs(str(a), str(b), "device vs host")


def test_four_card_children_get_one_card_each(tmp_path):
    children = chip_smoke.four_card_children(
        "lib.json", "reads.fastq", str(tmp_path / "out.tsv"),
        environ={"CUDA_VISIBLE_DEVICES": "0,1,2,3", "PATH": "/bin"})
    cards = [env["CUDA_VISIBLE_DEVICES"] for _, env in children]
    assert cards == ["0", "1", "2", "3"]
    for i, (argv, env) in enumerate(children):
        assert argv[argv.index("--process-id") + 1] == str(i)
        assert argv[argv.index("--num-processes") + 1] == "4"
        assert env["PATH"] == "/bin"
    # one coordinator for the whole run
    assert len({argv[argv.index("--coordinator") + 1]
                for argv, _ in children}) == 1


def _tiny_engine_args():
    feats = chip_smoke.random_features(3, 120, seed=1)
    cfg = AlignFilterConfig(reference_genome_size=3, score_percent=0.3,
                            score_threshold=30, num_mismatches=1,
                            max_hits_to_report=4)
    return build_index(feats), cfg


@pytest.mark.parametrize("walk", [True, False, "fused", "pallas", "rel"])
def test_device_engine_rejects_removed_walk_modes(walk):
    index, cfg = _tiny_engine_args()
    with pytest.raises(ValueError, match="not a walk mode"):
        DeviceAlignEngine(index, cfg, walk=walk)


def test_device_engine_walk_modes():
    index, cfg = _tiny_engine_args()
    assert WALK_MODES == ("packed", "abs")
    for walk in WALK_MODES:
        assert DeviceAlignEngine(index, cfg, walk=walk).walk == walk


@pytest.mark.parametrize("platform,ok", [("cpu", False), ("gpu", True)])
def test_bench_requires_gpu(monkeypatch, platform, ok):
    import jax

    devices = [types.SimpleNamespace(platform=platform, device_kind="x")]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    if ok:
        assert bench.accelerator_devices() == devices
    else:
        with pytest.raises(SystemExit, match="no GPU found"):
            bench.accelerator_devices()


def test_bench_main_fails_without_gpu():
    with pytest.raises(SystemExit) as exc:
        bench.main(["--reads", "1024"])
    assert exc.value.code not in (0, None)


@pytest.mark.gpu
def test_oracle_fixtures_on_gpu(gpu_device, tmp_path):
    chip_smoke.phase_oracle_fixtures(str(tmp_path))


@pytest.mark.gpu
def test_engine_matches_host_at_launch_batch_8192(gpu_device):
    assert chip_smoke.check_engine_matches_host(launch_batch=8192) > 0
