"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on host CPU devices
(xla_force_host_platform_device_count).  Tests marked ``gpu`` need a card
and skip here (see the ``gpu_device`` fixture); ``python chip_smoke.py``
runs their bodies on the GPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: kernel shapes recompile once per machine,
# not once per test run.  NOTE: do NOT set
# JAX_PERSISTENT_CACHE_ENABLE_XLA_CACHES=all here — serializing the
# XLA-internal caches segfaulted intermittently during long test runs
# (round 4: crashes inside put/get_executable_and_time with zstandard on
# the stack) and poisoned entries then crashed READERS of the shared
# cache, including bench.py.  The plain executable cache is stable.
from nimble_tpu.utils.compile_cache import cache_dir  # noqa: E402

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", cache_dir())
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import pathlib

import jax
import pytest

DATA_DIR = pathlib.Path(__file__).parent / "data"

# XLA:CPU maps each live compiled executable as ~3-4 small anonymous
# regions (r-x/r--/rw code pages).  A full suite run compiles enough
# distinct kernels to blow past vm.max_map_count (65530 here) and the
# process segfaults — observed inside the persistent-cache serializer,
# but the cache was the victim, not the cause (round-4 debugging:
# /proc/PID/maps hit 65087 right before RC=139, and clear_caches()
# demonstrably unmaps the regions).  Dropping the in-memory executable
# caches whenever the map count climbs keeps the process far from the
# limit; recompiles after a clear mostly hit the persistent disk cache.
_MAPS_FILE = "/proc/self/maps"  # NOT pid-pinned: forked workers must
# read their OWN map count or the cap never fires in the child
_MAPS_SOFT_LIMIT = 25000


@pytest.fixture(autouse=True)
def _cap_jit_code_maps():
    yield
    try:
        with open(_MAPS_FILE) as fh:
            n = sum(1 for _ in fh)
    except OSError:
        return
    if n > _MAPS_SOFT_LIMIT:
        jax.clear_caches()


@pytest.fixture
def data_dir() -> pathlib.Path:
    return DATA_DIR


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none.

    Decided here, at run time, never at import or collection: the suite
    runs under xdist, whose workers must all collect the same tests.
    """
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run on the card via python chip_smoke.py)")
    return devices[0]


def library_path(name: str) -> str:
    return str(DATA_DIR / "libraries" / name)


def reads_path(name: str) -> str:
    return str(DATA_DIR / "reads" / name)
