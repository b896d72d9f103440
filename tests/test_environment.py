"""What the program needs from its environment: where the compilation
cache lives, and the native WAV library built from committed source."""

import os
import shutil

import pytest

from phase_vocoder.io import native
from phase_vocoder.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_cache_dir_from_environment(monkeypatch, tmp_path, config_updates):
    """JAX_COMPILATION_CACHE_DIR wins, and nothing else is set in code
    (JAX reads the variable itself)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compilation_cache_dir() == str(tmp_path)
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert config_updates == []


@pytest.mark.parametrize("value", [None, ""])
def test_cache_dir_default_inside_checkout(monkeypatch, config_updates, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert cache.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
    assert config_updates == [("jax_compilation_cache_dir", cache.DEFAULT_DIR)]
    assert os.path.isdir(cache.DEFAULT_DIR)


def test_generated_paths_are_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert {".jax_cache/", "native/libpvwav.so", "chiprun_out/"} <= ignored


def test_native_library_builds_from_source(monkeypatch, tmp_path):
    """With no library present, first use runs `make -C native` on the
    committed source and loads the result."""
    src = tmp_path / "native"
    src.mkdir()
    for name in ("pvwav.cpp", "Makefile"):
        shutil.copy(os.path.join(REPO, "native", name), src)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(native, "_LIB_PATH", str(src / "libpvwav.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert native.available()
    assert (src / "libpvwav.so").exists()
