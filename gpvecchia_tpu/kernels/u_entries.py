"""Batched U-column entries: the replacement for the reference's hot kernel.

For every ordered point k, build the (m+1)x(m+1) covariance of [self +
conditioning set] (response-conditioned neighbors get their nugget added on
the diagonal), then compute the normalized first column of its inverse:

    x = C^{-1} e_self,   col = x / sqrt(x_self)

col[0] is the U diagonal (1/conditional-sd, positive), col[j] the U entry at
neighbor j's row.  This equals the reference's per-row upper-Cholesky
back-solve (/root/reference/src/U_NZentries.cpp:25-118); the OpenMP row loop
becomes the batch dimension.

The small matrices are kept as a packed upper triangle, a (P, n) array with
P = (m+1)(m+2)/2 (batch last), and solved by XLA's batched cholesky /
cho_solve on the unpacked (n, m+1, m+1) matrices (cuSOLVER/cuBLAS on the
GPU, LAPACK on the CPU).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .covariance import _safe_dist

__all__ = ["u_entries", "build_cov_packed", "packed_pair_dist"]


def _packed_index(mp1):
    """(iu, ju, pk): packed position p holds C[iu[p], ju[p]] (iu <= ju, the
    row-major upper triangle); pk[i, j] is the position of C[i, j]."""
    iu, ju = np.triu_indices(mp1)
    pk = np.zeros((mp1, mp1), np.int32)
    pk[iu, ju] = np.arange(iu.size)
    pk[ju, iu] = np.arange(iu.size)
    return iu, ju, pk


def packed_pair_dist(locs, NN):
    """Parameter-free packed pairwise distances (n, P) for the U kernel.

    Computed ONCE per spec and cached on the device arrays: the locs[NN]
    gather of d-wide rows and the pair differences never change across
    parameter evaluations.
    """
    mp1 = NN.shape[1]
    iu, ju, _ = _packed_index(mp1)
    pts = locs[NN]                           # (n, m+1, d)
    diff = pts[:, iu, :] - pts[:, ju, :]
    return _safe_dist(jnp.sum(diff * diff, axis=-1))       # (n, P)


def build_cov_packed(locs, NN, valid, cond, nug_point, kernel_fn, covparms,
                     covmat=None, sel=None, pdist=None, nbr_pts=None):
    """Packed upper-triangle covariance blocks, batch-last: (P, n).

    P = (m+1)(m+2)/2 positions (iu, ju) of the conditioning-set covariance;
    response-conditioned neighbors carry their nugget on the diagonal,
    invalid (padded) slots are identity-extended.

    covmat: optional full (n_all, n_all) covariance to gather from instead of
    evaluating a kernel (reference's U_NZentries_mat,
    /root/reference/src/U_NZentries.cpp:126-197).
    sel: optional (flat_selected_values, (n, m+1, m+1) pair_slots) for
    hierarchical conditioning (reference createUcppM, R/createU.R:89-139).
    pdist: optional precomputed packed distances from packed_pair_dist
    (skips the locs[NN] gather in the hot path).
    """
    mp1 = NN.shape[1]
    iu, ju, _ = _packed_index(mp1)
    # geometry is parameter-free: never differentiate through the location /
    # distance gathers (their cotangent scatters materialize O(n * P * d)
    # intermediates that OOM the grad compile at the n=1e6/m=40 config)
    if pdist is not None:
        pdist = jax.lax.stop_gradient(pdist)
    if nbr_pts is not None:
        nbr_pts = jax.lax.stop_gradient(nbr_pts)
    locs = jax.lax.stop_gradient(locs)
    if sel is not None:
        flat_vals, pair_slots = sel
        ps = pair_slots[:, iu, ju]
        Cp = jnp.where(ps >= 0, flat_vals[jnp.clip(ps, 0)], 0.0)
    elif covmat is not None:
        Cp = covmat[NN[:, iu], NN[:, ju]]
    elif getattr(kernel_fn, "takes_locs", False):
        # user covariance over location pairs (reference createU.R:93-108)
        pts = nbr_pts if nbr_pts is not None else locs[NN]
        Cp = kernel_fn(pts[:, iu, :], pts[:, ju, :], covparms)
    else:
        if pdist is not None:
            dist = pdist
        else:
            pts = nbr_pts if nbr_pts is not None else locs[NN]
            diff = pts[:, iu, :] - pts[:, ju, :]
            dist = _safe_dist(jnp.sum(diff * diff, axis=-1))
        Cp = kernel_fn(dist, covparms)
    # response-conditioned neighbors contribute their nugget on the diagonal;
    # the packed diagonal slots are exactly the positions with iu == ju, so
    # this is a static-mask add (scatter-free): at slot (j, j), iu = j
    nug_nb = jnp.where(valid & ~cond, nug_point[NN], 0.0)   # (n, m+1)
    dmask = jnp.asarray(iu == ju)
    Cp = Cp + jnp.where(dmask[None, :], nug_nb[:, iu], 0.0)
    # identity-pad invalid slots
    vv = valid[:, iu] & valid[:, ju]
    Cp = jnp.where(vv, Cp, dmask[None, :].astype(Cp.dtype))
    return Cp.T       # (P, n) batch-last


def _postprocess(col, valid):
    """Per-row numerical-failure handling: a non-SPD conditioning matrix
    poisons its row with NaN/Inf — replace with e0 (zero quadform terms,
    zero logdet contribution), like the reference's per-row try/catch
    (/root/reference/src/U_NZentries.cpp:60-66); then zero padded slots.

    Returns (col, bad): callers must exclude bad rows from the W assembly
    (the e0 stand-in must not inject a unit element there) and surface
    sum(bad) to the user; the count is threaded out as a value rather than
    printed, so it survives jit and grad."""
    mp1 = col.shape[1]
    bad = ~jnp.all(jnp.isfinite(col), axis=1)
    e0row = jnp.zeros((1, mp1), col.dtype).at[0, 0].set(1.0)
    col = jnp.where(bad[:, None], e0row, col)
    return jnp.where(valid, col, 0.0), bad


def u_entries(locs, NN, valid, cond, nug_point, kernel_fn, covparms,
              covmat=None, sel=None, pdist=None, nbr_pts=None, row_chunks=1):
    """(col, bad): U-column coefficients (n, m+1) aligned with NNarray
    (self first), and the per-row Cholesky-failure mask (see _postprocess).

    row_chunks > 1 processes the rows in that many sequential chunks
    (lax.map) so the (n, (m+1)(m+2)/2) covariance intermediates never
    materialize at once — required to fit large-n problems in device memory
    (the n=1e6, m=40 configuration needs ~3.4 GB per live f32 intermediate
    otherwise).
    """
    with jax.named_scope("u_entries"):
        col = _u_entries_col(locs, NN, valid, cond, nug_point, kernel_fn,
                             covparms, covmat, sel, pdist, nbr_pts,
                             row_chunks)
        return _postprocess(col, valid)


def _solve_e0(Cp, F):
    """x = C^{-1} e0 for packed batch-last SPD blocks: (P, n) -> (n, F).

    Batched cholesky + cho_solve on the unpacked (n, F, F) matrices; a
    non-SPD matrix surfaces as NaN in its own row only.
    """
    _, _, pk = _packed_index(F)
    # packed -> full via a static (F, F) gather (the equivalent scatter
    # formulation compiles pathologically slowly on XLA:CPU)
    C = Cp.T[:, jnp.asarray(pk)]
    e0 = jnp.zeros((C.shape[0], F, 1), C.dtype).at[:, 0].set(1.0)
    with jax.default_matmul_precision("highest"):
        chol = jnp.linalg.cholesky(C)
        return jax.scipy.linalg.cho_solve((chol, True), e0)[..., 0]


def _u_entries_col(locs, NN, valid, cond, nug_point, kernel_fn, covparms,
                   covmat=None, sel=None, pdist=None, nbr_pts=None,
                   row_chunks=1):
    """Raw (pre-masking) U columns via the XLA covariance build."""
    mp1 = NN.shape[1]
    n = NN.shape[0]
    if row_chunks > 1 and covmat is None and sel is not None:
        row_chunks = 1      # selected-matrix path is small; keep simple
    if row_chunks > 1 and covmat is None:
        pad = (-n) % row_chunks

        def padrow(a, fill):
            if a is None:
                return None
            if pad:
                w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
                a = jnp.pad(a, w, constant_values=fill)
            return a.reshape((row_chunks, -1) + a.shape[1:])

        stacked = dict(NN=padrow(NN, 0), valid=padrow(valid, False),
                       cond=padrow(cond, False))
        if pdist is not None and not getattr(kernel_fn, "takes_locs", False):
            stacked["pdist"] = padrow(pdist, 0.0)
        else:
            pts = nbr_pts if nbr_pts is not None else locs[NN]
            stacked["nbr_pts"] = padrow(pts, 0.0)

        def body(ch):
            return _u_entries_col(locs, ch["NN"], ch["valid"], ch["cond"],
                                  nug_point, kernel_fn, covparms,
                                  pdist=ch.get("pdist"),
                                  nbr_pts=ch.get("nbr_pts"))

        # checkpoint: the scan VJP would otherwise stash every chunk's
        # covariance-build residuals stacked over chunks (~40 GB at
        # n=1e6/m=40 — a dozen (chunks, n/chunks, 861) arrays); remat
        # recomputes them per chunk during the backward instead
        col = jax.lax.map(jax.checkpoint(body), stacked)
        return col.reshape(-1, mp1)[:n]
    Cp = build_cov_packed(locs, NN, valid, cond, nug_point, kernel_fn,
                          covparms, covmat, sel, pdist=pdist,
                          nbr_pts=nbr_pts)
    x = _solve_e0(Cp, mp1)                   # (n, m+1)
    col = x / jnp.sqrt(x[:, :1])
    # per-row numerical-failure handling (non-SPD conditioning covariance)
    # and padding masks are applied by _postprocess in u_entries; chunked
    # recursion comes back through here so masking happens exactly once
    return col
