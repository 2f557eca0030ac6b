"""Persistent XLA compilation cache.

The engine's larger programs take seconds to minutes to compile; a
persistent on-disk cache lets every later process reuse them. Enabled by
the engines, the CLI and the benchmark harness.

Location: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory. Otherwise the cache lives at one fixed
path inside the checkout, `CACHE_DIR` (``<repo>/.jax_cache``, git-ignored),
so every process of the same checkout finds it again. The CPU backend runs
uncached — see `enable_compilation_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory,
    or "" on the CPU backend.

    XLA:CPU serializes AOT machine code whose feature fingerprint includes
    pseudo-features (+prefer-no-gather/+prefer-no-scatter) the loader then
    fails to match against the host, and a mismatched deserialization
    segfaults (cpu_aot_loader logs the mismatch right before the crash).
    CPU compiles of this codebase are seconds-scale, so the CPU backend
    runs with the cache switched off, even when the environment names a
    directory."""
    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return ""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
