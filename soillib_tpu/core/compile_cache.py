"""Where JAX keeps its persistent compilation cache.

A cached program is found again only under the directory it was written
to, so the directory is fixed: `JAX_COMPILATION_CACHE_DIR` when the
environment sets it (JAX reads that variable itself), otherwise
`<checkout>/.jax_cache` (listed in .gitignore). It is never built from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
