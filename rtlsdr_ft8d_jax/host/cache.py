"""Persistent compilation cache — the FFTW-wisdom analogue.

The reference persists FFTW plans to fftw_wisdom.dat so restarts skip
planning (/root/reference/rtlsdr_ft8d.c:314-319,342-345). The JAX
equivalent is the persistent compilation cache: first-run XLA compiles
of the decode graphs are written to disk and reloaded on restart.

Placement: where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
and nothing is set here; otherwise the cache lives in DEFAULT_DIR, a
fixed directory inside the checkout that .gitignore lists.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def resolve_cache_dir(cache_dir: str | None = None) -> str | None:
    """The directory to configure, or None when JAX_COMPILATION_CACHE_DIR
    is set (JAX then places the cache itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return cache_dir or DEFAULT_DIR


def enable_compilation_cache(cache_dir: str | None = None):
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    target = resolve_cache_dir(cache_dir)
    if target is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    os.makedirs(target, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", target)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return target
