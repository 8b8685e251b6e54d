"""Persistent XLA compilation cache.

The tracking and BA programs at full fr1 capacity take minutes to compile;
the persistent cache lets every process after the first reuse them.
Enabled automatically when a :class:`VisualOdometry` system is constructed
(idempotent).

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing is set in code), otherwise the fixed
directory :data:`DEFAULT_CACHE_DIR` inside the checkout (git-ignored).  The
directory is part of the cache key, so it must not depend on the working
directory or the user's home.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_compilation_cache() -> None:
    global _enabled
    if _enabled or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    try:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    except OSError:  # read-only checkout: the cache is an optimization only
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    _enabled = True
