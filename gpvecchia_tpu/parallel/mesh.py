"""Mesh sharding for scale-out (jax.sharding + jit/GSPMD).

The reference's only parallelism is one OpenMP loop over U rows
(/root/reference/src/U_NZentries.cpp:37); here the row dimension of every
batched kernel shards across a device mesh, with XLA inserting the
collectives (scatter-adds across shards -> reduce; loglik terms -> psum
over the device interconnect).  A second mesh axis runs independent
hyperparameter evaluations (chains) in parallel — a capability the
reference does not have.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..inference.likelihood import (_device_arrays, _dispatch_covmodel,
                                    _loglik_core)
from ..plan import get_plan

__all__ = ["make_mesh", "sharded_loglik_fn", "sharded_loglik_core",
           "shard_rows"]

_ROW_KEYS = ("NN", "valid", "cond", "nb_resp", "nb_obs_pos", "has_lat",
             "has_col", "latent_rank", "obs_pos", "pdist", "nbr_pts")


def make_mesh(devices=None, rows=None, chains=1):
    """1- or 2-D mesh over (chains, rows)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if rows is None:
        rows = devices.size // chains
    if rows < 1 or devices.size < rows * chains:
        raise ValueError(
            f"make_mesh: {devices.size} device(s) cannot form a "
            f"(chains={chains}, rows={rows}) mesh — on CPU, set "
            f"--xla_force_host_platform_device_count in XLA_FLAGS")
    devices = devices[: rows * chains].reshape(chains, rows)
    return Mesh(devices, ("chains", "rows"))


def _pad_rows(plan, dev, n_dev):
    """Pad row-dimension arrays so n_all divides the row axis."""
    n_all = plan.n_all
    pad = (-n_all) % n_dev
    if pad == 0:
        return dev, n_all
    out = dict(dev)
    for k in _ROW_KEYS:
        if k in out:
            a = out[k]
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            fill = False if a.dtype == bool else (-1 if jnp.issubdtype(a.dtype, jnp.integer) else 0)
            out[k] = jnp.pad(a, widths, constant_values=fill)
    return out, n_all + pad


def shard_rows(mesh, plan, dev):
    """Place row-indexed plan arrays sharded over the 'rows' axis.

    The multifrontal tree's per-level node arrays shard on the NODE axis
    wherever the node count divides the mesh: the planner's in-order node
    numbering makes contiguous node ranges exactly subtrees, and children
    2i, 2i+1 land on the same device as parent i — so the factorization's
    extend-add stays device-local below depth log2(n_dev) and XLA only
    inserts collectives at the (tiny) top levels.  This covers ~all factor
    FLOPs: the leaf + deep levels dominate.
    """
    n_dev = mesh.shape["rows"]
    dev, _ = _pad_rows(plan, dev, n_dev)
    out = {}
    for k, v in dev.items():
        if k in _ROW_KEYS:
            spec = P("rows", *([None] * (v.ndim - 1)))
        elif k == "mf":
            out[k] = _shard_mf(mesh, v, n_dev)
            continue
        else:
            spec = P()      # schedules/lookup tables stay replicated
        out[k] = jax.device_put(v, NamedSharding(mesh, spec))
    return out


def _shard_mf(mesh, mf, n_dev):
    """Shard each level's node-indexed arrays over 'rows' where divisible."""
    levels = []
    for lv in mf["levels"]:
        N = lv["piv_ids"].shape[0]
        ok = N % n_dev == 0 and N >= n_dev
        spec_of = (lambda a: P("rows", *([None] * (a.ndim - 1)))) if ok \
            else (lambda a: P())
        levels.append({k: (None if a is None else jax.device_put(
            a, NamedSharding(mesh, spec_of(a)))) for k, a in lv.items()})
    return dict(levels=levels,
                x_slot=jax.device_put(mf["x_slot"],
                                      NamedSharding(mesh, P())))


def sharded_loglik_core(spec, covmodel="matern", mesh=None, dtype=None):
    """(core, sharded_dev): un-jitted loglik core + row-sharded index arrays.

    ``core(dev, z, covparms, nuggets)``; callers compose it under their own
    jit/grad/vmap and MUST pass ``sharded_dev`` through the jit boundary as
    an argument (a closure capture would bake the arrays into the executable
    as replicated constants, losing the sharding and inviting giant
    compile-time constant folds).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if mesh is None:
        mesh = make_mesh()
    plan = get_plan(spec, dtype)
    covmat, sel, kernel_fn = _dispatch_covmodel(spec, covmodel, dtype)
    dev = _device_arrays(plan)
    # pad + shard row-space arrays; note locs stays replicated (n x d is small)
    sharded = shard_rows(mesh, plan, dev)

    def core(dev, z, covparms, nuggets):
        return _loglik_core(plan, kernel_fn, covmat, dev, z, covparms,
                            nuggets, sel=sel)

    return core, sharded


def sharded_posterior_core(spec, covmodel="matern", mesh=None, dtype=None):
    """(core, sharded_dev): posterior mean + selected-inverse variances with
    the multifrontal tree sharded over 'rows' (same subtree-contiguous node
    ranges as the likelihood).  ``core(dev, z, covparms, nuggets)`` returns
    (mu over ordered latents, posterior variance diagonal)."""
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if mesh is None:
        mesh = make_mesh()
    plan = get_plan(spec, dtype)
    if not plan.use_mf:
        raise NotImplementedError("sharded posterior needs the multifrontal "
                                  "('chol'-mode) path")
    covmat, sel, kernel_fn = _dispatch_covmodel(spec, covmodel, dtype)
    dev = _device_arrays(plan)
    sharded = shard_rows(mesh, plan, dev)
    static = plan.compiled["mf_static"]

    def core(dev, z, covparms, nuggets):
        from ..inference.prediction import _posterior_core
        from ..linalg.multifrontal import mf_selinv_diag
        mu, fac, _, _ = _posterior_core(plan, kernel_fn, covmat, dev, z,
                                        covparms, nuggets, sel=sel)
        return mu, mf_selinv_diag(static, dev["mf"], fac)

    return core, sharded


def sharded_loglik_fn(spec, covmodel="matern", mesh=None, dtype=None):
    """loglik(z, covparms, nuggets) with rows sharded over the mesh.

    Padded rows are masked inside the core (padded NN rows are invalid and
    carry no latent/obs flags, so they contribute exactly zero).
    """
    core, sharded = sharded_loglik_core(spec, covmodel, mesh, dtype)
    _fn = jax.jit(core)

    def fn(z, covparms, nuggets):
        return _fn(sharded, z, covparms, nuggets)

    return fn
