"""Takahashi selected inverse on the V factor (JAX, level-scheduled).

Computes Z = (V V^T)^{-1} restricted to the sparsity pattern of V: the
posterior-variance path (reference SelInv -> sparseinv::Takahashi_Davis,
/root/reference/R/vecchia_prediction.R:193-197).  The classic recursion is
sequential column-by-column; here columns are grouped by elimination-tree
level (ancestors first), levels are bucketed, and each bucket runs as one
lax.scan of batched gather/compute/scatter steps:

  for column j with pattern s_j = [j, a_1, ..., a_F]:
    offd_i = - (sum_k V[a_k, j] * Z[a_k, a_i]) / V[j,j]          (i = 1..F)
    Z[a_i, j] = offd_i
    Z[j, j]   = 1/V[j,j]^2 - (sum_k V[a_k, j] * offd_k) / V[j,j]

All Z entries needed live in ancestor columns (already computed) thanks to
the fill property of the symbolic pattern.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .sparse import scatter_set

__all__ = ["SelInvLevel", "build_selinv_levels", "selected_inverse"]


@dataclasses.dataclass
class SelInvLevel:
    """A bucket of consecutive levels (ancestors first)."""
    F: int
    slots: np.ndarray       # (nlev, L, F) v/z flat slots of column j (diag first), -1 pad
    pair_slots: np.ndarray  # (nlev, L, F-1, F-1) z-flat slots of Z[a_k, a_i], -1 -> 0


def build_selinv_levels(plan):
    """Host-side: bucket-grouped slot maps for the Takahashi recursion.

    All slot indices are in the plan's PHYSICAL V layout (Z values share
    that layout, so v/z reads and z writes use the same maps).
    """
    colptr = plan.v_colptr
    rows = plan.v_rows.astype(np.int64)
    v_perm = plan.v_perm
    n = plan.n_lat
    # (row, col) -> PHYSICAL slot lookup over the V column storage
    col_of = np.repeat(np.arange(n), np.diff(colptr))
    keys = rows * n + col_of
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    slot_of = v_perm[order]

    def lookup(r, c):
        q = r.astype(np.int64) * n + c.astype(np.int64)
        pos = np.searchsorted(sorted_keys, q)
        pos_c = np.clip(pos, 0, sorted_keys.size - 1)
        ok = sorted_keys[pos_c] == q
        return np.where(ok, slot_of[pos_c], -1)

    # reuse the (already bucketed) backward levels: ancestors first
    out = []
    for blk in plan.bwd_blocks:
        nlev, L = blk.cols.shape
        cols_b = blk.cols.astype(np.int64)
        valid = cols_b >= 0
        cols_c = np.where(valid, cols_b, 0)
        widths = np.where(valid, colptr[cols_c + 1] - colptr[cols_c], 0)
        F = int(widths.max())
        ar = np.arange(F)[None, None, :]
        wmask = ar < widths[:, :, None]
        lslots = np.where(wmask, colptr[cols_c][:, :, None] + ar, 0)
        slots = np.where(wmask, v_perm[lslots], -1)
        if F > 1:
            anc = np.where(wmask[:, :, 1:], rows[lslots[:, :, 1:]], -1)
            av = anc >= 0
            aa = np.where(av, anc, 0)
            hi = np.maximum(aa[:, :, :, None], aa[:, :, None, :])
            lo = np.minimum(aa[:, :, :, None], aa[:, :, None, :])
            ps = lookup(hi.ravel(), lo.ravel()).reshape(nlev, L, F - 1, F - 1)
            ok = av[:, :, :, None] & av[:, :, None, :]
            ps = np.where(ok, ps, -1)
        else:
            ps = np.empty((nlev, L, 0, 0), dtype=np.int64)
        out.append(SelInvLevel(F=F, slots=slots.astype(np.int32),
                               pair_slots=ps.astype(np.int32)))
    return out


def selected_inverse(v_flat, levels, n_nnz):
    """Z values on the V pattern (flat, column storage) from V values."""

    def body(z_flat, xs):
        slots, ps = xs
        ok = slots >= 0
        vvals = jnp.where(ok, v_flat[jnp.clip(slots, 0)], 0.0)
        diag = jnp.where(ok[:, 0], vvals[:, 0], 1.0)
        if ps.shape[-1] > 0:
            Zsub = jnp.where(ps >= 0, z_flat[jnp.clip(ps, 0)], 0.0)
            lcol = vvals[:, 1:]
            offd = -jnp.einsum("bki,bk->bi", Zsub, lcol,
                               precision=jax.lax.Precision.HIGHEST
                               ) / diag[:, None]
            offd = jnp.where(ok[:, 1:], offd, 0.0)
            # Z[j,j] = 1/L_jj^2 - (1/L_jj) sum_k L[a_k,j] Z[a_k,j]
            zdiag = 1.0 / (diag * diag) - jnp.sum(lcol * offd, axis=1) / diag
            zcol = jnp.concatenate([zdiag[:, None], offd], axis=1)
        else:
            zcol = (1.0 / (diag * diag))[:, None]
        z_flat = scatter_set(z_flat, slots, jnp.where(ok, zcol, 0.0))
        return z_flat, None

    z_flat = jnp.zeros(n_nnz, v_flat.dtype)
    for lv in levels:
        xs = (jnp.asarray(lv.slots), jnp.asarray(lv.pair_slots))
        if lv.slots.shape[0] == 1:
            z_flat, _ = body(z_flat, jax.tree.map(lambda a: a[0], xs))
        else:
            z_flat, _ = jax.lax.scan(body, z_flat, xs)
    return z_flat
