"""Where the persistent XLA compilation cache lives.

Kernel shapes are fixed per (library geometry, bucket, launch size), so
compiled executables are worth keeping across runs.  The rule:

* ``JAX_COMPILATION_CACHE_DIR`` set -> that directory, verbatim;
* otherwise one fixed directory inside the checkout (``<repo>/.jax_cache``,
  listed in ``.gitignore``), derived from this package's own path.  A fixed
  path matters: the directory is part of the cache key, so a temporary or
  per-process name would never hit.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping, Optional

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The compilation-cache directory for ``environ`` (default os.environ)."""
    env = os.environ if environ is None else environ
    return env.get(CACHE_ENV) or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Applied through ``jax.config`` because JAX reads its environment once,
    at import.  Returns the directory in use.
    """
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
