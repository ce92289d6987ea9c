"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench.py, bench_suite.py, chip_smoke.py,
the app CLIs): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it; otherwise the cache lives at the
fixed path ``<checkout>/.jax_cache``. The path is part of the cache key's
neighbourhood — a directory that moves between runs never hits — so it is
never derived from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
