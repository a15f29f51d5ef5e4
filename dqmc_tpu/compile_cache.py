"""Persistent XLA compilation cache for the heavyweight engine programs.

The multiword parity engines and the measured bin programs take minutes
to compile; without a persistent cache every process — the CLI driver,
``bench.py``, ``chip_smoke.py``, the tools — pays it again.  The
reference has no analogue (C++ compiles once at build time,
CMakeLists.txt:7); here it is JAX's persistent compilation cache, which
this module turns on with one call.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and this
  module sets no directory of its own;
- otherwise one fixed directory inside the checkout, ``.jax_cache/``
  (listed in .gitignore).  The path is part of what makes a later process
  find an entry again, so it never depends on a temporary name, a pid or
  the time.

The cache is keyed on (HLO, compiler version, device kind), so stale
entries are never served; it is safe to delete the directory at any time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent compilation cache (idempotent); returns the
    directory in use."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took real compile effort; tiny programs
    # recompile faster than they deserialize
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
