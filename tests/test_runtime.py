"""Process set-up helpers (utils/runtime.py): the compile-cache directory,
the card description and the GPU requirement of the measuring scripts."""

import os

import jax
import pytest

from cpu_ray_tracer_tpu.utils import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_honours_the_environment(tmp_path, monkeypatch, restore_cache_dir):
    target = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert runtime.enable_compile_cache() == str(target)
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(target)


def test_cache_dir_defaults_to_the_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(runtime.REPO, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


def test_card_description_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on this PATH
    assert "nvidia-smi" in runtime.card_description()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        runtime.require_gpu()
    assert e.value.code == 2
