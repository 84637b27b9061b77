"""Vecchia posterior prediction: means, variances, linear combinations.

Mirrors /root/reference/R/vecchia_prediction.R on the padded-dense
representation: posterior mean via two level-scheduled triangular solves with
V, variances via the Takahashi selected inverse (or exactly via per-column
solves), lincombs and the dense joint covariance for diagnostics.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.covariance import make_kernel_fn
from ..kernels.u_entries import u_entries
from ..linalg.multifrontal import mf_backward, mf_forward, mf_selinv_diag
from ..linalg.selinv import build_selinv_levels, selected_inverse
from ..linalg.sparse import pair_sum
from ..linalg.trisolve import backward_solve, forward_solve
from ..plan import ensure_v, get_plan
from .likelihood import (_device_arrays, _dispatch_covmodel, _mf_denominator,
                         _nugget_vectors, compute_v_factor)

__all__ = ["vecchia_prediction", "vecchia_lincomb", "V2covmat"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _posterior_core(plan, kernel_fn, covmat, dev, z, covparms, nuggets,
                    sel=None):
    """Returns (mu over latent vars in ordered sequence, v_flat, col, nug_ord)."""
    dt = plan.dtype
    z = jnp.asarray(z, dt)
    covparms = jnp.asarray(covparms, dt)
    nuggets = jnp.broadcast_to(jnp.asarray(nuggets, dt), z.shape)

    nug_ord, nug_point = _nugget_vectors(plan, dev, nuggets, dt)
    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, kernel_fn, covparms, covmat=covmat,
                         sel=sel, pdist=dev.get("pdist"),
                         nbr_pts=dev.get("nbr_pts"),
                         row_chunks=plan.compiled.get("u_row_chunks", 1))
    # a dropped (non-SPD) row contributes NOTHING to the posterior precision
    # W/V assembly — zeroing here mirrors col_w in _loglik_core so likelihood
    # and prediction imply the same model when drops occur (the e0 stand-in
    # in `col` would otherwise inject a spurious unit element)
    col_w = jnp.where(bad[:, None], 0.0, col)
    from ..linalg.sparse import gather
    zord = gather(z, dev["ord_z"])

    znb = zord[dev["nb_obs_pos"]]
    z1L = jnp.sum(jnp.where(dev["nb_resp"], col * znb, 0.0), axis=1)
    z1L = jnp.where(dev["has_col"], z1L, 0.0)
    z1Z = zord / jnp.sqrt(nug_ord)

    if plan.use_mf:
        # mean = -W^{-1} z2 through the multifrontal factor (the ordering of
        # the factorization is free; the solution vector is not)
        fac = _mf_denominator(plan, dev, col_w, z1L, zord, nug_ord, dt)
        mu_lat = -mf_backward(plan.compiled["mf_static"], dev["mf"], fac)
        if "known_pt" in dev:
            # exact (zero-nugget) observations: posterior mean is the datum
            mu_ord = jnp.zeros(plan.n_all, dt).at[dev["vert_pt"]].set(mu_lat)
            mu_ord = mu_ord.at[dev["known_pt"]].set(
                zord[dev["known_obs"]])
            return mu_ord, fac, col, nug_ord
        # vertices are latent ranks; in 'chol' mode without exact
        # observations every ordered point is latent, so rank order ==
        # ordered sequence
        return mu_lat, fac, col, nug_ord

    ucat_z = jnp.concatenate([col_w.ravel(), jnp.ones(1, dt)])
    zcat = jnp.concatenate([z1L, -z1Z / jnp.sqrt(nug_ord)])
    z2 = pair_sum(ucat_z, zcat, dev["z2_sched"], dt)

    v_flat = compute_v_factor(plan, dev, col_w, nug_ord, dt)
    temp = forward_solve(v_flat, z2[::-1], dev["fwd"],
                         x_perm=dev["fwd_x_perm"], x_size=plan.fwd_x_size)
    mu_rev = -backward_solve(v_flat, temp, dev["bwd"],
                             x_perm=dev["bwd_x_perm"], x_size=plan.bwd_x_size)
    mu_ord = mu_rev[::-1]       # over latent vars in ordered sequence
    return mu_ord, v_flat, col, nug_ord


def _pred_fns(spec, covmodel, dtype=None):
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    plan = get_plan(spec, dtype)
    key = ("pred", str(covmodel), np.dtype(dtype).name)
    if key in plan.compiled:
        return plan.compiled[key], plan
    covmat, sel, kernel_fn = _dispatch_covmodel(spec, covmodel, dtype)
    dev = _device_arrays(plan)

    @jax.jit
    def _mean_fn(dev, z, covparms, nuggets):
        mu, v_flat, col, nug_ord = _posterior_core(
            plan, kernel_fn, covmat, dev, z, covparms, nuggets, sel=sel)
        return mu, v_flat

    def mean_fn(z, covparms, nuggets):
        return _mean_fn(dev, z, covparms, nuggets)

    if plan.use_mf:
        static = plan.compiled["mf_static"]

        @jax.jit
        def _var_fn(dev, fac):
            d = mf_selinv_diag(static, dev["mf"], fac)
            if "known_pt" in dev:
                # exact observations have zero posterior variance
                full = jnp.zeros(plan.n_all, d.dtype).at[dev["vert_pt"]].set(d)
                return full
            return d

        def var_fn(fac):
            return _var_fn(dev, fac)
    else:
        selinv_levels = plan.compiled.get("selinv_levels")
        if selinv_levels is None:
            selinv_levels = build_selinv_levels(plan)
            plan.compiled["selinv_levels"] = selinv_levels

        @jax.jit
        def var_fn(v_flat):
            z_flat = selected_inverse(v_flat, selinv_levels, plan.v_phys_size)
            diag_rev = z_flat[jnp.asarray(plan.v_diag_slots)]
            return diag_rev[::-1]   # variances over latent vars, ordered seq

    fns = (mean_fn, var_fn)
    plan.compiled[key] = fns
    return fns, plan


def _extract(spec, values_ord, known_vals=None):
    """Latent ordered-sequence values -> (obs part, pred part) original order.

    Accepts either one value per ordered location (the usual case) or one
    per latent variable when the zero-nugget variant removed latents — then
    the known locations are filled from `known_vals` (aligned with
    np.flatnonzero(spec.known_pts))."""
    n = spec.n_obs
    n_locs = spec.ord.shape[0]
    values_ord = np.asarray(values_ord, dtype=np.float64)
    if values_ord.shape[0] != n_locs:
        off = spec.n_all - n_locs       # zy layout: latent twin of loc j is n+j
        vals = np.full(n_locs, np.nan)
        vals[spec.latent_point - off] = values_ord
        kn = np.flatnonzero(spec.known_pts)
        vals[kn - off] = known_vals
        values_ord = vals
    out = np.empty(n_locs, dtype=np.float64)
    out[spec.ord] = values_ord
    return out[:n], out[n:]


def vecchia_prediction(z, spec, covparms, nuggets, var_exact=None,
                       covmodel="matern", return_values="all"):
    """Posterior mean/variance at observed and prediction locations.

    Mirrors /root/reference/R/vecchia_prediction.R:17-56.  Returns a dict
    with mu_obs, mu_pred and (for 'meanvar'/'all') var_obs, var_pred.
    """
    nuggets = np.broadcast_to(np.asarray(nuggets, np.float64), (spec.n_obs,))
    from .likelihood import zero_nugget_variant
    spec = zero_nugget_variant(spec, np.nan_to_num(nuggets, nan=1.0))
    (mean_fn, var_fn), plan = _pred_fns(spec, covmodel)
    z = np.asarray(z, np.float64)
    # NA handling: mean-fill with inflated nuggets (R/vecchia_likelihood.R:45-58)
    if np.any(np.isnan(z)):
        nuggets = nuggets.copy()
        zv = np.nanvar(z, ddof=1) * 1e8
        nuggets = np.where(np.isnan(z), zv, nuggets)
        z = np.where(np.isnan(z), np.nanmean(z), z)
    # infinite nuggets (unobserved pseudo-data) pass through harmlessly

    known_mu = None
    if spec.known_pts is not None and spec.known_pts.any():
        # exact observations: posterior mean is the datum, variance 0
        kn = np.flatnonzero(spec.known_pts)
        zord = z[spec.ord_z]
        known_mu = zord[spec.obs_pos[spec.NNarray[kn, 0]]]
    mu_ord, v_flat = mean_fn(z, np.asarray(covparms, np.float64), nuggets)
    mu_obs, mu_pred = _extract(spec, np.asarray(mu_ord), known_mu)
    out = {"mu_obs": mu_obs, "mu_pred": mu_pred,
           "var_obs": None, "var_pred": None, "V": None}
    if return_values in ("meanmat", "all"):
        out["V"] = v_flat if isinstance(v_flat, dict) else np.asarray(v_flat)
        out["_plan"] = plan

    if return_values in ("meanvar", "all"):
        if var_exact is None:
            # the chunked multi-RHS solves keep memory bounded, so default to
            # the exact path well past the reference's 4e4 auto-threshold
            var_exact = spec.n_pred < 2e5
        vars_ord = np.asarray(var_fn(v_flat))
        var_obs, var_pred = _extract(
            spec, vars_ord,
            0.0 if known_mu is None else np.zeros_like(known_mu))
        if var_exact and spec.ordering_pred == "obspred" and spec.n_pred > 0:
            # exact path recomputes prediction variances by per-column solves;
            # obs variances stay from the selected inverse (as in the
            # reference, R/vecchia_prediction.R:224-244)
            var_pred = np.asarray(_exact_pred_vars(spec, plan, v_flat))
        out["var_obs"] = var_obs
        out["var_pred"] = var_pred
    return out


def _exact_pred_vars(spec, plan, v_flat):
    """Exact prediction variances via per-column forward solves.

    var_i = || V^{-1} e_{rev(i)} ||^2 (identity lincomb, reference
    vecchia_lincomb at R/vecchia_prediction.R:164-178); computed only for
    prediction latent variables, returned in original pred order.
    """
    n = plan.n_lat
    # ordered-sequence positions of prediction points -> latent ranks ->
    # rev positions (ranks shift when the zero-nugget variant removes
    # known latents, so go through latent_rank rather than assuming
    # location position == rank)
    pred_seq = np.flatnonzero(spec.ord >= spec.n_obs)  # positions in ordered seq
    off = spec.n_all - spec.ord.shape[0]
    ranks = spec.latent_rank[pred_seq + off]
    assert np.all(ranks >= 0)
    rev_pos = n - 1 - ranks

    def one(p):
        b = jnp.zeros(n, v_flat.dtype).at[p].set(1.0)
        x = forward_solve(v_flat, b, plan.fwd_blocks)
        return jnp.sum(x * x)

    # chunked batched solves: a flat vmap would materialize an
    # (n_pred, n_lat) solve workspace; lax.map over fixed-size chunks keeps
    # memory bounded so large n_pred no longer needs the selected-inverse
    # fallback (reference exact path, R/vecchia_prediction.R:224-244)
    npred = rev_pos.size
    # don't pad tiny prediction sets up to a full chunk of wasted solves
    chunk = min(1024, max(int(npred), 1))
    pad = (-npred) % chunk
    rp = np.concatenate([rev_pos, np.zeros(pad, np.int64)])
    rp = jnp.asarray(rp.reshape(-1, chunk))
    vars_chunks = jax.lax.map(lambda idx: jax.vmap(one)(idx), rp)
    vars_pred_seq = vars_chunks.reshape(-1)[:npred]
    # back to original pred order
    out = np.empty(spec.n_pred)
    out[spec.ord[pred_seq] - spec.n_obs] = np.asarray(vars_pred_seq)
    return out


def vecchia_lincomb(H, spec, v_flat, cov_mat=False):
    """Variance (or covariance matrix) of H @ y under the posterior.

    H: (k, n_locs) dense or scipy-sparse matrix over the stacked original
    ordering [obs; pred].  Mirrors R/vecchia_prediction.R:164-178.
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    plan = get_plan(spec, dtype)
    H = np.asarray(H.todense()) if hasattr(H, "todense") else np.asarray(H)
    if isinstance(v_flat, dict):
        # multifrontal factor: ||L^{-1} h||^2 = h^T W^{-1} h is invariant to
        # the factor's ordering, and cross inner products likewise
        if np.asarray(plan.known_pts).any():
            # a factor built under the zero-nugget variant spec has fewer
            # vertices and latent ranks that are no longer the ordered
            # sequence — the H column mapping below would silently misalign
            raise NotImplementedError(
                "vecchia_lincomb with a multifrontal factor requires all "
                "latents free (no zero-nugget/known points)")
        from .likelihood import _device_arrays as _da
        dev = _da(plan)
        static = plan.compiled["mf_static"]
        if static.n_vert != int(np.sum(plan.has_latent_pts)):
            raise ValueError(
                "multifrontal factor does not match this spec's plan "
                "(was it produced under a derived zero-nugget spec?)")
        Hv = H[:, spec.ord]                 # columns -> latent rank order

        def one(h):
            ys, _ = mf_forward(static, dev["mf"], v_flat, jnp.asarray(h))
            return jnp.concatenate([y.reshape(-1) for y in ys])

        temp = jax.vmap(one)(jnp.asarray(Hv, dtype))
        if cov_mat:
            return np.asarray(jnp.matmul(temp, temp.T, precision=_HIGHEST))
        return np.asarray(jnp.sum(temp * temp, axis=1))

    # columns to reversed latent order: rev of ordered sequence
    ensure_v(plan)
    Ht = H[:, spec.ord[::-1]]          # (k, n_lat)
    v_flat = jnp.asarray(v_flat)

    def one(b):
        return forward_solve(v_flat, jnp.asarray(b), plan.fwd_blocks)

    temp = jax.vmap(one)(jnp.asarray(Ht))   # (k, n_lat)
    if cov_mat:
        return np.asarray(jnp.matmul(temp, temp.T, precision=_HIGHEST))
    return np.asarray(jnp.sum(temp * temp, axis=1))


def V2covmat(spec, v_flat):
    """Dense joint posterior covariance (diagnostics; small n only).

    Mirrors /root/reference/R/vecchia_prediction.R:265-288.
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    plan = get_plan(spec, dtype)
    n = plan.n_lat
    if isinstance(v_flat, dict):
        # multifrontal factor: Sigma = W^{-1} by batched column solves
        from ..linalg.multifrontal import mf_solve
        from .likelihood import _device_arrays as _da
        dev = _da(plan)
        static = plan.compiled["mf_static"]
        eye = jnp.eye(n, dtype=dtype)
        cols = jax.vmap(lambda c: mf_solve(static, dev["mf"], v_flat, c))(eye)
        Sigma_ord = np.asarray(cols).T
        out = np.empty((spec.ord.size, spec.ord.size))
        out[np.ix_(spec.ord, spec.ord)] = Sigma_ord
        n_obs = spec.n_obs
        return {"Sigma_obs": out[:n_obs, :n_obs],
                "Sigma_pred": out[n_obs:, n_obs:]}
    ensure_v(plan)
    V = np.zeros((n, n))
    cp = plan.v_colptr
    vf = np.asarray(v_flat)[plan.v_perm]     # physical -> logical col-major
    for j in range(n):
        V[plan.v_rows[cp[j]:cp[j + 1]], j] = vf[cp[j]:cp[j + 1]]
    Sigma_rev = np.linalg.inv(V @ V.T)
    Sigma_ord = Sigma_rev[::-1, ::-1]
    out = np.empty((spec.ord.size, spec.ord.size))
    out[np.ix_(spec.ord, spec.ord)] = Sigma_ord
    n_obs = spec.n_obs
    return {"Sigma_obs": out[:n_obs, :n_obs], "Sigma_pred": out[n_obs:, n_obs:]}
