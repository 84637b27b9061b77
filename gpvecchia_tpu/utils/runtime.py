"""Process-level runtime settings: the compile cache and the memory budget."""

from __future__ import annotations

import os

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache", "device_memory_limit",
           "memory_budget", "DEFAULT_MEMORY_LIMIT"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# device memory assumed where the backend reports no limit (the CPU)
DEFAULT_MEMORY_LIMIT = 16 * 2 ** 30


def compile_cache_dir():
    """$JAX_COMPILATION_CACHE_DIR if set, else `<checkout>/.jax_cache`."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compile_cache():
    """Turn on JAX's persistent compile cache at `compile_cache_dir()`.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
    path is set here.  The fallback path is fixed, because the directory is
    part of the cache key: a path that moves never hits.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_memory_limit(device=None):
    """Bytes the allocator may use on `device` (default: the first device);
    DEFAULT_MEMORY_LIMIT where the backend reports none."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    return int(stats.get("bytes_limit") or DEFAULT_MEMORY_LIMIT)


def memory_budget(device=None):
    """Byte budgets of the large intermediates, as shares of device memory.

    pdist_cache: largest packed pair-distance cache kept on the device;
    u_chunk:     covariance build of one U-entries row chunk;
    leaf_chunk:  localized element columns of one multifrontal leaf chunk;
    selinv_chunk: selected-inverse fronts of one deepest-level node chunk.
    """
    limit = device_memory_limit(device)
    return dict(pdist_cache=limit // 32, u_chunk=limit // 36,
                leaf_chunk=limit // 20, selinv_chunk=limit // 40)
