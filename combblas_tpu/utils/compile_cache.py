"""Where JAX keeps its persistent compilation cache.

Every entry point (``bench.py``, ``chip_smoke.py``, the CLI and the tests)
calls :func:`enable_compile_cache`, so all of them share one cache: the
directory ``JAX_COMPILATION_CACHE_DIR`` names when it is set, else
``<repo>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the shared directory and
    return it."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO_CACHE)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
