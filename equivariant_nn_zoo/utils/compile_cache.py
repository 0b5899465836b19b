"""Persistent XLA compilation cache, at one place per checkout.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing is changed here.  Otherwise the cache lives at ``<repo>/.jax_cache``
(listed in ``.gitignore``).  The path is fixed because it is part of the
cache key: a directory named after a process or a time would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def setup_compile_cache(repo_root: str = REPO_ROOT) -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(repo_root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
