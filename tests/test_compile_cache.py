"""The persistent compilation cache sits at one fixed directory."""

import os

import jax

from soillib_tpu.core import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv(cc.ENV_VAR, "/some/cache")
    assert cc.enable_compile_cache() == "/some/cache"
    assert calls == []


def test_default_is_the_checkout_cache_dir(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_default_path_is_stable_and_ignored(monkeypatch):
    """Two calls give the same path (no temp name, pid or time in it),
    and git ignores it."""
    _record_updates(monkeypatch)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.enable_compile_cache() == cc.enable_compile_cache()
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
