"""Where JAX's persistent compile cache lives.

A cold compile of a large batched step takes tens of seconds; the cache lets
the next process skip it. The cache key includes the directory, so the
directory must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory
    and nothing is changed here. Otherwise the cache goes to the fixed path
    `<repo>/.jax_cache`."""
    configured = os.environ.get(ENV_VAR)
    if configured:
        return configured
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
