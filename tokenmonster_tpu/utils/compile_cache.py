"""JAX's persistent compilation cache, kept at one fixed place.

The path is fixed so that a later run finds what an earlier one compiled; a
temporary or per-run directory would start empty every time.
``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it
itself and nothing else is changed); otherwise the cache lives under the
checkout at ``.tmp/jaxcache``, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".tmp", "jaxcache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
