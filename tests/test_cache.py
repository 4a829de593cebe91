"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins and nothing is
set in code; otherwise one fixed, git-ignored directory in the checkout."""

import os

import pytest

from rtlsdr_ft8d_jax.host import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "/elsewhere/jax-cache"])
def test_cache_dir_rule(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.resolve_cache_dir() == cache.DEFAULT_DIR
        assert cache.resolve_cache_dir("/x") == "/x"
        assert os.path.dirname(cache.DEFAULT_DIR) == ROOT
        with open(os.path.join(ROOT, ".gitignore")) as f:
            ignored = f.read().split()
        assert os.path.basename(cache.DEFAULT_DIR) + "/" in ignored
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cache.resolve_cache_dir() is None
        assert cache.resolve_cache_dir("/x") is None
        assert cache.enable_compilation_cache() == env
