"""Scatter/gather helpers for -1-padded index maps.

JAX's `mode="drop"` drops only *out-of-bounds* indices; -1 is in-bounds
(NumPy wrap semantics) and would silently corrupt the last element.  These
helpers rewrite negative pad indices to an out-of-bounds sentinel first.

`pair_sum` is the replacement for scatter-add with colliding
indices (which XLA serializes): the host transposes each scatter map into
per-target gather lists padded by count class (plan.py _build_pair_sum), so
the device does gathers + dense reductions + unique-index writes only.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["oob", "scatter_add", "scatter_set", "scatter_set_unique",
           "gather0", "pair_sum"]


def oob(idx, size):
    """Map negative pad indices to `size` (out of bounds -> dropped)."""
    idx = jnp.asarray(idx)
    return jnp.where(idx < 0, size, idx)


def scatter_add(arr, idx, vals):
    """arr.at[idx].add(vals), dropping entries where idx < 0."""
    return arr.at[oob(idx, arr.shape[0])].add(vals, mode="drop")


def scatter_set(arr, idx, vals):
    """arr.at[idx].set(vals), dropping entries where idx < 0."""
    return arr.at[oob(idx, arr.shape[0])].set(vals, mode="drop")


def scatter_set_unique(arr, idx, vals):
    """scatter_set for index maps known to be collision-free."""
    return arr.at[oob(idx, arr.shape[0])].set(vals, mode="drop",
                                              unique_indices=True)


def gather(arr, idx):
    """arr[idx], lifting 1-D index arrays to 2-D first.

    XLA compiles long chains of rank-1 gathers pathologically slowly
    (hundreds of ms each); the same gather with a 2-D index array is fine.
    """
    idx = jnp.asarray(idx)
    if idx.ndim == 1:
        return arr[idx[None]][0]
    return arr[idx]


def gather0(arr, idx):
    """arr[idx] with idx < 0 yielding 0."""
    idx = jnp.asarray(idx)
    return jnp.where(idx >= 0, gather(arr, jnp.clip(idx, 0)), 0.0)


def pair_sum(A, B, sched, dtype=None):
    """out[t] = sum_c A[pa[t,c]] * B[pb[t,c]], scatter-free.

    `sched` is (buckets, gather_map) from plan._build_pair_sum: each bucket
    computes a contiguous count-class segment; the concatenation (plus a
    zero sentinel) is recombined into target order by one static gather.
    """
    buckets, gmap = sched
    dt = dtype if dtype is not None else A.dtype
    parts = [jnp.sum(gather0(A, pa) * gather0(B, pb), axis=1)
             for pa, pb in buckets]
    cat = jnp.concatenate(parts + [jnp.zeros(1, dt)]) if parts else \
        jnp.zeros(1, dt)
    return gather(cat, gmap)
