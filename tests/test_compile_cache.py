"""Where the persistent compilation cache goes (utils/compile_cache.py)."""
import os

import pytest

import jax

from oadg_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    try:
        chosen = compile_cache.enable_compile_cache()
        if env_dir is None:
            # a fixed, ignored directory inside the checkout
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert chosen == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == chosen
            with open(os.path.join(repo, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
        else:
            # the environment names the directory: the code sets nothing
            assert chosen is None
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
