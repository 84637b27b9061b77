"""Process-level helpers: the compile cache, the memory budget, and the
GPU requirement of chip_smoke.py."""

import os
import sys

import jax
import pytest

from gpvecchia_tpu.utils import runtime

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_env_variable(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.compile_cache_dir() == str(tmp_path)
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other path is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch,
                                                       restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(_ROOT, ".jax_cache")
    assert runtime.compile_cache_dir() == want
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,limit", [
    (None, runtime.DEFAULT_MEMORY_LIMIT),
    ({"bytes_in_use": 0}, runtime.DEFAULT_MEMORY_LIMIT),
    ({"bytes_limit": 64 * 2 ** 30}, 64 * 2 ** 30)])
def test_memory_budget_shares(stats, limit):
    dev = _FakeDevice(stats)
    assert runtime.device_memory_limit(dev) == limit
    b = runtime.memory_budget(dev)
    assert b == dict(pdist_cache=limit // 32, u_chunk=limit // 36,
                     leaf_chunk=limit // 20, selinv_chunk=limit // 40)


def test_memory_budget_on_cpu_uses_default():
    assert jax.default_backend() == "cpu"
    assert runtime.device_memory_limit() == runtime.DEFAULT_MEMORY_LIMIT


def test_chip_smoke_refuses_a_cpu_process():
    sys.path.insert(0, _ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(_ROOT)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
    assert "GPU" in str(exc.value.code)
