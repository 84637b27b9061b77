"""Vecchia marginal likelihood (JAX, jit + grad capable).

Implements the general-Vecchia Gaussian loglikelihood
(/root/reference/R/vecchia_likelihood.R:63-99) on the padded-dense
representation: numerator from response columns of U, denominator through the
reverse-ordered factor V of W = U_y U_y^T + D.  Unlike the reference, the
whole computation is differentiable in the covariance parameters and nuggets.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.covariance import make_kernel_fn
from ..kernels.u_entries import u_entries
from ..linalg.multifrontal import mf_device_arrays, mf_factor
from ..linalg.sparse import gather, gather0, pair_sum
from ..plan import ensure_v, get_mf_plan, get_plan
from ..linalg.trisolve import forward_solve
from ..utils.runtime import memory_budget

__all__ = ["vecchia_likelihood", "loglik_fn", "loglik_core",
           "compute_v_factor"]


def _device_arrays(plan):
    """Device copies of the plan's index arrays (cached).

    These are passed to the jitted kernels as ARGUMENTS (one shared buffer),
    never captured as closure constants: constants get baked into the
    executable and XLA constant-folds gathers like locs[NN] into
    O(n * (m+1)^2) materialized arrays at compile time.
    """
    if "dev" in plan.compiled:
        return plan.compiled["dev"]
    dt = plan.dtype
    dev = {
        "locs": jnp.asarray(plan.locs, dt),
        "NN": jnp.asarray(plan.NN),
        "valid": jnp.asarray(plan.valid),
        "cond": jnp.asarray(plan.cond),
        "nb_resp": jnp.asarray(plan.nb_resp),
        "nb_obs_pos": jnp.asarray(plan.nb_obs_pos),
        "obs_points": jnp.asarray(plan.obs_points),
        "ord_z": jnp.asarray(plan.ord_z),
        "has_lat": jnp.asarray(plan.has_latent_pts),
        "has_col": jnp.asarray(plan.has_latent_pts | plan.known_pts),
        "zero_obs": jnp.asarray(plan.zero_obs),
        "latent_rank": jnp.asarray(plan.latent_rank),
        "obs_pos": jnp.asarray(plan.obs_pos),
    }
    # parameter-free geometry caches (one-time device compute): packed pair
    # distances when they fit the budget, else just the gathered neighbor
    # coordinates (the (n, P) distance array is 3.4 GB at n=1e6/m=40 f32)
    from ..kernels.u_entries import packed_pair_dist
    budget = memory_budget()
    mp1 = plan.NN.shape[1]
    pair_bytes = plan.n_all * (mp1 * (mp1 + 1)) // 2 * np.dtype(dt).itemsize
    if pair_bytes <= budget["pdist_cache"]:
        dev["pdist"] = jax.jit(packed_pair_dist)(dev["locs"], dev["NN"])
    else:
        dev["nbr_pts"] = jax.jit(lambda l, nn: l[nn])(dev["locs"], dev["NN"])
    # sequential row chunks bound the u_entries intermediates
    plan.compiled["u_row_chunks"] = max(1, -(-pair_bytes
                                             // budget["u_chunk"]))
    if plan.n_lat == 0:
        # fully-known degenerate case: no factor machinery at all
        plan.compiled["dev"] = dev
        return dev
    if plan.use_mf:
        # multifrontal factor path: no per-entry V machinery on device
        mfp, vert_obs = get_mf_plan(plan)
        static, arrays = mf_device_arrays(mfp)
        plan.compiled["mf_static"] = static
        dev["mf"] = arrays
        dev["vert_obs"] = jnp.asarray(vert_obs)
        dev["vert_pt"] = jnp.asarray(
            np.flatnonzero(plan.has_latent_pts).astype(np.int32))
        if plan.known_pts.any():
            kp = np.flatnonzero(plan.known_pts)
            dev["known_pt"] = jnp.asarray(kp.astype(np.int32))
            dev["known_obs"] = jnp.asarray(
                plan.obs_pos[kp].astype(np.int32))
        plan.compiled["dev"] = dev
        return dev

    ensure_v(plan)

    def sched(s):
        return ([(jnp.asarray(b.pa), jnp.asarray(b.pb)) for b in s.buckets],
                jnp.asarray(s.gather_map)) if s is not None else ([], None)

    dev.update(
        v_diag_slots=jnp.asarray(plan.v_diag_slots),
        dir_pt=jnp.asarray(plan.dir_pt),
        dir_nn=jnp.asarray(plan.dir_nn),
        w_sched=sched(plan.w_schedule),
        z2_sched=sched(plan.z2_schedule),
        factor=[(jnp.asarray(b.offsets),
                 tuple((jnp.asarray(pa), jnp.asarray(pb))
                       for pa, pb, _ in b.diag_classes),
                 tuple((jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(dloc))
                       for pa, pb, dloc, _ in b.off_classes))
                for b in plan.factor_buckets],
        fwd=[(jnp.asarray(b.cols), jnp.asarray(b.diag_slots),
              jnp.asarray(b.row_slots), jnp.asarray(b.row_cols),
              jnp.asarray(b.offsets))
             for b in plan.fwd_blocks],
        bwd=[(jnp.asarray(b.cols), jnp.asarray(b.slots), jnp.asarray(b.rows),
              jnp.asarray(b.offsets))
             for b in plan.bwd_blocks],
        fwd_x_perm=jnp.asarray(plan.fwd_x_perm),
        bwd_x_perm=jnp.asarray(plan.bwd_x_perm),
    )
    plan.compiled["dev"] = dev
    return dev


def _nugget_vectors(plan, dev, nuggets, dt):
    """(nug_ord over obs positions, nug_point over ordered points).

    `nuggets` is a length-n_obs vector in original observation order.
    """
    nug_vec = jnp.broadcast_to(jnp.atleast_1d(jnp.asarray(nuggets, dt)),
                               (plan.n_obs,))
    nug_ord = gather(nug_vec, dev["ord_z"])
    nug_point = jnp.zeros(plan.n_all, dt).at[dev["obs_points"]].set(nug_ord)
    return nug_ord, nug_point


def compute_v_factor(plan, dev, col, nug_ord, dt):
    """Numeric V factor values (physical layout) from U columns and nuggets.

    Up-looking exact factorization on the static schedule (plan.py): W is
    assembled once as a gather-based pair reduction directly into the
    physical level layout, then each elimination level computes its
    contiguous segment (diagonals first, then off-diagonals normalized by
    rsqrt of their column's diagonal) and appends it with one
    dynamic_update_slice — gathers and dense reductions only, zero scatter
    ops (cf. the reference's Matrix::chol / ic0 at
    /root/reference/R/vecchia_prediction.R:74-84, src/ic0.cpp:43-64).
    """
    # direct columns occupy physical [0, n_dir): one contiguous gather
    v_dir = col[dev["dir_pt"], dev["dir_nn"]]
    if not dev["factor"]:
        return v_dir
    # W on the factor pattern from U products + 1/nugget diagonal terms
    ucat = jnp.concatenate([col.ravel(), 1.0 / nug_ord, jnp.ones(1, dt)])
    w_phys = pair_sum(ucat, ucat, dev["w_sched"], dt)

    v = jnp.concatenate([v_dir,
                         jnp.zeros(plan.v_phys_size - plan.n_dir, dt)])

    for offsets, diag_classes, off_classes in dev["factor"]:
        S = (sum(pa.shape[-2] for pa, _ in diag_classes)
             + sum(pa.shape[-2] for pa, _, _ in off_classes))

        def body(v, xs, S=S):
            off, dcls, ocls = xs
            w_lvl = jax.lax.dynamic_slice(w_phys, (off,), (S,))
            pos = 0
            dparts = []
            for pa, pb in dcls:
                E, C = pa.shape[-2], pa.shape[-1]
                w0 = w_lvl[pos:pos + E]
                if C > 0:
                    w0 = w0 - jnp.sum(gather0(v, pa) * gather0(v, pb),
                                      axis=-1)
                dparts.append(w0)
                pos += E
            draw = jnp.concatenate(dparts) if len(dparts) > 1 else dparts[0]
            # no clamping: a non-SPD pivot must surface as NaN rather than
            # silently corrupt the factor (/root/reference/src/ic0.cpp:53-58
            # likewise divides by whatever the pivot is)
            dinv = jax.lax.rsqrt(draw)
            parts = [draw * dinv]                     # sqrt of the diagonals
            for pa, pb, dloc in ocls:
                E, C = pa.shape[-2], pa.shape[-1]
                raw = w_lvl[pos:pos + E]
                if C > 0:
                    raw = raw - jnp.sum(gather0(v, pa) * gather0(v, pb),
                                        axis=-1)
                parts.append(raw * gather(dinv, jnp.clip(dloc, 0)))
                pos += E
            lvl = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
            return jax.lax.dynamic_update_slice(v, lvl, (off,)), None

        xs = (offsets, diag_classes, off_classes)
        if offsets.shape[0] == 1:
            v, _ = body(v, jax.tree.map(lambda a: a[0], xs))
        else:
            v, _ = jax.lax.scan(body, v, xs)
    return v


def _mf_denominator(plan, dev, col, z1L, zord, nug_ord, dt, rhs=True):
    """Multifrontal factor of W (+ optional forward solve of z2).

    Elements are the latent-conditioned entries of each U column; the D
    diagonal adds 1/nugget at observed vertices, and the z2 RHS adds
    -zord/nugget there (the observation column contribution).
    """
    static = plan.compiled["mf_static"]
    vo = dev["vert_obs"]
    obs_v = vo >= 0
    voc = jnp.clip(vo, 0)
    # gather a SAFE nugget first: unobserved latent vertices clamp to obs
    # position 0, and if that observation has a zero nugget the untaken
    # division branch would poison gradients with NaN (value is fine)
    nug_v = jnp.where(obs_v, gather(nug_ord, voc), 1.0)
    dvec = jnp.where(obs_v, 1.0 / nug_v, 0.0)
    u_elem = jnp.where(dev["cond"], col, 0.0)
    kw = {}
    if rhs:
        kw = dict(rhs_elem=z1L,
                  rhs_vert=jnp.where(obs_v,
                                     -gather(zord, voc) / nug_v,
                                     0.0))
    # bound the leaf-assembly intermediate (power-of-two chunks)
    leaf = dev["mf"]["levels"][-1]
    NL, EL = leaf["elem_pt"].shape
    F = static.npiv[-1] + static.nbord[-1]
    need = NL * EL * F * np.dtype(dt).itemsize
    cap = memory_budget()["leaf_chunk"]
    chunks = 1
    while need // chunks > cap and chunks < NL:
        chunks *= 2
    return mf_factor(static, dev["mf"], u_elem, dvec, dtype=dt,
                     leaf_chunks=chunks, **kw)


def _dispatch_covmodel(spec, covmodel, dtype):
    """Resolve covmodel into (full covmat | selected (vals, slots) | kernel)."""
    covmat = sel = kernel_fn = None
    if isinstance(covmodel, np.ndarray) or (hasattr(covmodel, "shape")
                                            and not callable(covmodel)):
        arr = np.asarray(covmodel, np.float64)
        n_all, mp1 = spec.NNarray.shape
        if arr.shape == (n_all, n_all):
            covmat = jnp.asarray(arr, dtype)
        elif arr.shape == (n_all, mp1):
            from ..plan import get_sel_pair_slots
            slots = get_sel_pair_slots(spec)
            sel = (jnp.asarray(np.nan_to_num(arr).ravel(), dtype),
                   jnp.asarray(slots))
        else:
            raise ValueError(
                f"covariance matrix shape {arr.shape} matches neither the "
                f"full ({n_all},{n_all}) nor selected ({n_all},{mp1}) layout")
    else:
        kernel_fn = make_kernel_fn(covmodel)
    return covmat, sel, kernel_fn


def _prepare_pack(plan, dev, z, dt):
    """Parameter-free, data-dependent precomputation (cacheable per z).

    Carries the NA-filled ordered observations, their (n, m+1) neighbor
    gather (constant across the MLE inner loop), and the NaN masks driving
    the reference's nugget-inflation NA handling
    (/root/reference/R/vecchia_likelihood.R:45-58)."""
    z = jnp.asarray(z, dt)
    isnan = jnp.isnan(z)
    zm = jnp.nanmean(z)
    n_ok = jnp.sum(~isnan)
    zv = jnp.nansum(jnp.where(isnan, 0.0, (z - zm) ** 2)) / jnp.maximum(
        n_ok - 1, 1)
    zf = jnp.where(isnan, zm, z)
    zord = gather(zf, dev["ord_z"])
    nan_ord = gather(isnan, dev["ord_z"])
    return dict(zord=zord, znb=zord[dev["nb_obs_pos"]], nan_ord=nan_ord,
                zv=zv)


def _loglik_core(plan, kernel_fn, covmat, dev, z, covparms, nuggets,
                 sel=None, pack=None, with_aux=False):
    dt = plan.dtype
    covparms = jnp.asarray(covparms, dt)
    if pack is None:
        pack = _prepare_pack(plan, dev, z, dt)
    nug_in = jnp.asarray(nuggets, dt)
    scalar_nug = nug_in.ndim == 0

    # NA handling by nugget inflation (R/vecchia_likelihood.R:45-58), on
    # the ordered axis (nan_ord/zv from the pack)
    big = pack["zv"] * 1e8
    if scalar_nug:
        nug_ord = jnp.where(pack["nan_ord"], big, nug_in)
    else:
        nug_vec = jnp.broadcast_to(nug_in, (plan.n_obs,))
        nug_ord = jnp.where(pack["nan_ord"], big,
                            gather(nug_vec, dev["ord_z"]))
    nug_point = jnp.zeros(plan.n_all, dt).at[dev["obs_points"]].set(nug_ord)

    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, kernel_fn, covparms, covmat=covmat,
                         sel=sel, pdist=dev.get("pdist"),
                         nbr_pts=dev.get("nbr_pts"),
                         row_chunks=plan.compiled.get("u_row_chunks", 1))

    zord = pack["zord"]

    # z1 over U columns: regression columns gather the values of their
    # known-conditioned neighbors (response-conditioned, or exact/zero-nugget
    # latents, whose own value IS the observation)
    zero_obs = dev["zero_obs"]
    nug_safe = jnp.where(zero_obs, 1.0, nug_ord)
    znb = pack["znb"]
    z1L = jnp.sum(jnp.where(dev["nb_resp"], col * znb, 0.0), axis=1)
    z1L = jnp.where(dev["has_col"], z1L, 0.0)
    z1Z = jnp.where(zero_obs, 0.0, zord / jnp.sqrt(nug_safe))

    quad_num = jnp.sum(z1L * z1L) + jnp.sum(z1Z * z1Z)
    col_mask = dev["has_col"]
    logdet_num = (-2.0 * jnp.sum(jnp.where(col_mask, jnp.log(jnp.where(
        col_mask, col[:, 0], 1.0)), 0.0))
        + jnp.sum(jnp.where(zero_obs, 0.0, jnp.log(nug_safe))))

    # dropped (non-SPD) rows contribute NOTHING to W = U_y U_y^T — the e0
    # stand-in in `col` keeps the numerator terms neutral, but its unit
    # element would otherwise add +1 to W's diagonal at that vertex
    col_w = jnp.where(bad[:, None], 0.0, col)

    if plan.n_lat == 0:
        # all observations exact (every latent known): no denominator
        quad_denom = jnp.zeros((), dt)
        logdet_denom = jnp.zeros((), dt)
    elif plan.use_mf:
        # denominator through the multifrontal factor of W = U_y U_y^T + D:
        # quad = z2^T W^{-1} z2 with z2 = U_y z1 assembled per-leaf inside
        # the tree (rhs_elem = z1L weights, rhs_vert = -zord/nugget at each
        # observed vertex), logdet(W) from the factor diagonals
        fac = _mf_denominator(plan, dev, col_w, z1L, zord, nug_ord, dt)
        quad_denom = fac["quad"]
        logdet_denom = -fac["logdet"]
    else:
        # z2 = U_y z1 over latent rows, as a gather-based pair reduction:
        # z2[r] = sum col[p,a]*z1L[p] over in-edges, minus z1Z/sqrt(nug) at
        # the point's own latent row (schedule built in plan.py)
        ucat_z = jnp.concatenate([col_w.ravel(), jnp.ones(1, dt)])
        zcat = jnp.concatenate([z1L, -z1Z / jnp.sqrt(nug_ord)])
        z2 = pair_sum(ucat_z, zcat, dev["z2_sched"], dt)

        # denominator through V
        v_flat = compute_v_factor(plan, dev, col_w, nug_ord, dt)
        z2rev = z2[::-1]
        z3 = forward_solve(v_flat, z2rev, dev["fwd"], x_size=plan.fwd_x_size)
        quad_denom = jnp.sum(z3 * z3)
        logdet_denom = -2.0 * jnp.sum(
            jnp.log(gather(v_flat, dev["v_diag_slots"])))

    const = plan.n_obs * math.log(2.0 * math.pi)
    neg2 = logdet_num - logdet_denom + quad_num - quad_denom + const
    ll = -0.5 * neg2
    if with_aux:
        return ll, {"n_dropped_rows": jnp.sum(bad)}
    return ll


def zero_nugget_variant(spec, nuggets):
    """Derived spec handling exact (zero-nugget) observations, if any.

    Mirrors /root/reference/R/createU.R:83-86 (force latent conditioning on
    zero-nugget neighbors — here equivalently response conditioning with a
    zero diagonal add, since the response IS the latent) and :173-193 (the
    z-row of a zero-nugget point is deleted and its y-row reclassified as an
    observation-type row — here a 'known' column with no free latent).
    Returns `spec` unchanged when no nugget is zero.
    """
    zero = np.asarray(nuggets) == 0.0
    if not zero.any():
        return spec
    key = ("zero_variant", zero.tobytes())

    def build():
        import dataclasses
        zero_by_pos = zero[spec.ord_z]
        if spec.cond_yz in ("zy", "RVP", "LK"):
            # Response-first layout: the observation lives on the response
            # point k < n and its latent twin is t = k + n.  With a zero
            # nugget y_t == z_k, so the twin's latent is deleted, any
            # conditioning on y_t is redirected to the (known) response
            # z_k, and the twin keeps a 'known' U column p(y_t = z_k | nb)
            # whose self slot points at k (same location) with the
            # degenerate own-z slot removed — the index surgery the
            # reference does by deleting Inf-diagonal rows and permuting
            # (/root/reference/R/createU.R:173-193).  The known column
            # conditions on neighbor RESPONSES (LK-style): it must carry no
            # latent rows, or it would add u u^T to W and break the
            # direct-mode identity V = rev(U_y) — the reference's own path
            # here builds the column from a singular duplicate-location
            # covariance, which this design avoids.
            n = spec.n_obs
            zpts = np.flatnonzero(zero_by_pos)
            twins = zpts + n
            NN = spec.NNarray.copy()
            cond = spec.cond_latent.copy()
            is_twin = np.zeros(spec.n_all, bool)
            is_twin[twins] = True
            hit = (NN >= 0) & is_twin[np.maximum(NN, 0)]
            NN = np.where(hit, NN - n, NN)
            cond = np.where(hit, False, cond)
            NN[twins, 0] = zpts
            NN[twins, 1] = -1          # own-z slot: duplicate location
            tw = NN[twins]
            assert not np.any(tw >= 2 * n), \
                "zero-nugget twin conditions on a prediction latent"
            NN[twins] = np.where(tw >= n, tw - n, tw)
            cond[twins] = False
            has_latent = spec.has_latent.copy()
            has_latent[twins] = False
            known = np.zeros(spec.n_all, bool)
            known[twins] = True
            return dataclasses.replace(
                spec, NNarray=NN, cond_latent=cond & (NN >= 0),
                has_latent=has_latent, known_pts=known,
                zero_obs_mask=zero_by_pos, _cache={})
        obs_pos = spec.obs_pos
        is_zero = spec.has_obs & np.where(
            obs_pos >= 0, zero_by_pos[np.maximum(obs_pos, 0)], False)
        NN = spec.NNarray
        valid = NN >= 0
        zero_nb = np.where(valid, is_zero[np.maximum(NN, 0)], False)
        return dataclasses.replace(
            spec, cond_latent=spec.cond_latent & ~zero_nb,
            has_latent=spec.has_latent & ~is_zero,
            known_pts=is_zero, zero_obs_mask=zero_by_pos, _cache={})

    return spec.cached(key, build)


def loglik_core(spec, covmodel="matern", dtype=None):
    """(core, dev) for composition under jit/grad/vmap.

    ``core(dev, z, covparms, nuggets)`` is un-jitted; callers must pass the
    ``dev`` index-array pytree through their own jit boundary as an ARGUMENT
    (closure capture would bake it into the executable as constants and
    invite XLA to constant-fold O(n m^2)-sized gathers at compile time).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    plan = get_plan(spec, dtype)
    covmat, sel, kernel_fn = _dispatch_covmodel(spec, covmodel, dtype)
    dev = _device_arrays(plan)

    def core(dev, z, covparms, nuggets):
        return _loglik_core(plan, kernel_fn, covmat, dev, z, covparms,
                            nuggets, sel=sel)

    return core, dev


def loglik_fn(spec, covmodel="matern", dtype=None, with_aux=False):
    """Compiled loglik(z, covparms, nuggets) for a given spec (cached).

    with_aux=True returns (loglik, {"n_dropped_rows": count}) — the number
    of U rows whose conditioning Cholesky failed (non-SPD) and were dropped
    (the reference prints these to stderr,
    /root/reference/src/U_NZentries.cpp:60-66; here the count is a value,
    so it survives jit).

    The data-dependent, parameter-free precomputation (ordered z, the n x m
    neighbor-observation gather, NaN masks) is cached per z-array identity:
    in the MLE/MCMC inner loop z never changes, so repeated evaluations pay
    only the parameter-dependent work.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    plan = get_plan(spec, dtype)
    key = ("loglik", str(covmodel), np.dtype(dtype).name, with_aux)
    if key in plan.compiled:
        return plan.compiled[key]
    covmat, sel, kernel_fn = _dispatch_covmodel(spec, covmodel, dtype)
    dev = _device_arrays(plan)

    _prep = jax.jit(lambda dev, z: _prepare_pack(plan, dev, z, dtype))
    _eval = jax.jit(functools.partial(
        lambda wa, dev, pack, covparms, nuggets: _loglik_core(
            plan, kernel_fn, covmat, dev, None, covparms, nuggets, sel=sel,
            pack=pack, with_aux=wa), with_aux))
    zcache = {}

    def _zkey(z):
        # jax arrays are immutable -> identity suffices; numpy arrays can be
        # mutated in place between calls (EM/latent-update loops), so key on
        # a content fingerprint: shape/dtype + a strided value sample
        if isinstance(z, np.ndarray):
            s = max(1, z.size // 64)
            sample = np.ascontiguousarray(z.reshape(-1)[::s])
            return (id(z), z.shape, str(z.dtype), sample.tobytes())
        return (id(z),)

    def fn(z, covparms, nuggets):
        key = None if isinstance(z, jax.core.Tracer) else _zkey(z)
        if key is not None and zcache.get("key") == key:
            return _eval(dev, zcache["pack"], covparms, nuggets)
        pack = _prep(dev, z)
        # cache ONLY concrete packs: under an outer trace (grad/jit of fn)
        # _prep stages into that trace and returns tracers, which must not
        # leak into later calls (and the constant cache can hand the same
        # id(z) to a different trace)
        if key is not None and not any(
                isinstance(leaf, jax.core.Tracer)
                for leaf in jax.tree.leaves(pack)):
            zcache["key"] = key
            zcache["ref"] = z            # pin the array so the id is stable
            zcache["pack"] = pack
        return _eval(dev, pack, covparms, nuggets)

    plan.compiled[key] = fn
    return fn


def vecchia_likelihood(z, spec, covparms, nuggets, covmodel="matern"):
    """Gaussian Vecchia loglikelihood (scalar).

    Mirrors /root/reference/R/vecchia_likelihood.R:14-27; `z` in original
    observation order, `nuggets` scalar or per-observation vector.
    """
    if spec.cond_yz in ("zy", "RVP", "LK"):
        # the reference collapses RVP/LK to cond.yz='zy'
        # (/root/reference/R/vecchia_specify.R:224), so its warning
        # (R/vecchia_likelihood.R:16-17) covers the whole family
        import warnings
        warnings.warn("cond.yz='zy' will produce a poor likelihood "
                      "approximation. Use 'SGV' instead.")
    nug = np.asarray(nuggets, dtype=np.float64)
    spec = zero_nugget_variant(spec, np.broadcast_to(nug, (spec.n_obs,)))
    if nug.ndim > 0:
        nug = np.broadcast_to(nug, (spec.n_obs,))
    fn = loglik_fn(spec, covmodel, with_aux=True)
    ll, aux = fn(np.asarray(z, np.float64),
                 np.asarray(covparms, np.float64), nug)
    nbad = int(aux["n_dropped_rows"])
    if nbad:
        import warnings
        warnings.warn(f"u_entries: Cholesky failed for {nbad} row(s); "
                      "their U rows were dropped (non-SPD conditioning "
                      "covariance)")
    return float(ll)
