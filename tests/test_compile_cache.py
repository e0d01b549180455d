"""Placement of the persistent compilation cache."""

import os
import socket

import jax

from visual_sgraphs.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_means_no_cache_dir_in_code(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.cache_dir() is None
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_unset_gives_one_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    assert first == second == compile_cache.cache_dir()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == os.path.join(checkout, ".jax_cache")
    assert socket.gethostname() not in first
    assert str(os.getpid()) not in first
    assert calls == [("jax_compilation_cache_dir", first)] * 2


def test_cache_dir_is_ignored_by_git():
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
