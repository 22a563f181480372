"""The entry points' persistent compile cache (utils/compile_cache.py)."""

import os

import jax

from monoorbslam3_tpu.utils import compile_cache


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # nothing set in code: the config keeps whatever JAX read itself
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        _restore(prev)


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        first = compile_cache.enable_compile_cache()
        second = compile_cache.enable_compile_cache()
        assert first == second == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == first
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert first == os.path.join(root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        _restore(prev)
