"""Persistent XLA compile cache at a fixed place.

A fresh process otherwise recompiles every tower, kernel and the 7B
verifier from cold. Entry points (the CLI, bench.py, chip_smoke.py) call
`enable_compile_cache()` before their first compile:

  - with JAX_COMPILATION_CACHE_DIR set, JAX already uses that directory
    and nothing is set in code;
  - otherwise the cache goes to `.jax_cache/` at the checkout root (listed
    in .gitignore). The path is fixed so that a second run of the same
    checkout finds what the first one wrote.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    import jax

    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
