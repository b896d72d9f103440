"""Persistent XLA compilation cache.

Every entry point (cli.py, bench.py, chip_smoke.py) enables JAX's
persistent compilation cache, so a repeat run with the same shapes skips
compilation. The directory is JAX_COMPILATION_CACHE_DIR when that is set
(JAX reads it itself; nothing else is set here), and otherwise a fixed
directory inside the checkout: the path is part of what makes a cached
program found again, so it must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir() -> str:
    """The cache directory this process uses (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at compilation_cache_dir()."""
    import jax

    path = compilation_cache_dir()
    if path == DEFAULT_DIR:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
