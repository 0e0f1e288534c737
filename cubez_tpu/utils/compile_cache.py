"""JAX's persistent compilation cache, at one fixed place.

A solve compiles one executable per configuration, which at 512^3 can take
longer than the solve itself.  ``enable()`` lets later processes reuse it:

* if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  sets nothing;
* otherwise the cache goes to ``<checkout>/.jax_cache`` (listed in
  .gitignore).  The path is fixed: it is part of the cache key, so a path
  that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
