"""Hyperparameter posterior sampling: adaptive HMC/NUTS in pure JAX.

The reference has no sampling capability (its only estimation loop is
Nelder-Mead MLE, /root/reference/R/vecchia_wrappers.R:87-93); this module adds
Hamiltonian Monte Carlo over log-covariance-parameters, driven by exact AD
gradients of the Vecchia loglikelihood.  Everything jits; chains are an
embarrassingly parallel vmap axis that `sample_posterior` shards across the
'chains' axis of a device mesh (BASELINE.md config 5).

Design:
  * the whole sampler is one lax.scan over draws -> a single compiled program,
    no host round-trips between transitions;
  * dynamic trajectory length via the no-U-turn criterion evaluated along a
    statically-bounded trajectory (progressive multinomial sampling with the
    Betancourt generalized termination check on doubling boundaries), so all
    shapes are static;
  * Stan-style dual-averaging step-size adaptation + diagonal mass-matrix
    (Welford) adaptation during warmup.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["run_hmc", "sample_posterior"]


def _leapfrog(grad_fn, theta, r, eps, inv_mass):
    r = r + 0.5 * eps * grad_fn(theta)
    theta = theta + eps * inv_mass * r
    r = r + 0.5 * eps * grad_fn(theta)
    return theta, r


def _kinetic(r, inv_mass):
    return 0.5 * jnp.sum(r * r * inv_mass)


def _uturn(theta_plus, theta_minus, r_plus, r_minus, inv_mass):
    d = theta_plus - theta_minus
    return ((jnp.sum(d * inv_mass * r_plus) < 0)
            | (jnp.sum(d * inv_mass * r_minus) < 0))


def _nuts_transition(logpost_fn, grad_fn, key, theta0, eps, inv_mass,
                     max_depth):
    """One dynamic-length transition (doubling trajectory, multinomial).

    Classic recursive NUTS doubles the trajectory up to max_depth times,
    alternating directions, and stops on a U-turn between trajectory
    endpoints.  Here each doubling is one bounded fori_loop of leapfrog
    steps; the carry keeps both endpoints and a running multinomial sample of
    the whole trajectory.  Subtree-internal U-turn checks use the iterative
    balanced-block scheme (a state stack with one slot per scale), which
    reproduces the recursive algorithm's exact check set with static shapes.

    The loop carries the gradient at each endpoint so one
    ``value_and_grad`` per leapfrog step supplies the half-step kicks AND
    the multinomial weight: the compiled program contains ONE copy of the
    posterior graph per loop body instead of three (two grad_fn calls +
    one logpost call), which at the n=1e6 configs cuts both compile time
    and per-step runtime ~3x.  ``grad_fn`` is accepted for signature
    compatibility but derived internally.
    """
    dt = theta0.dtype
    dim = theta0.shape[0]
    vg_fn = jax.value_and_grad(logpost_fn)
    key, kr = jax.random.split(key)
    r0 = jax.random.normal(kr, (dim,), dt) * jnp.sqrt(1.0 / inv_mass)
    logp0, g0 = vg_fn(theta0)
    joint0 = logp0 - _kinetic(r0, inv_mass)

    def one_doubling(carry, depth):
        (key, tp, rp, gp, tm, rm, gm, prop, log_sum_w, sum_acc, n_acc,
         done) = carry
        key, kdir, ksel = jax.random.split(key, 3)
        go_right = jax.random.bernoulli(kdir)
        n_leap = 2 ** depth  # static per unrolled doubling

        # iterative balanced-subtree U-turn checks: a state stack with one
        # slot per scale s = 1..max_depth.  Step i (producing state z_{i+1})
        # SAVES z_{i+1} into every slot s with i % 2^s == 0 (z_{i+1} starts
        # those blocks) and CHECKS the U-turn between slot s and z_{i+1} for
        # every s with (i+1) % 2^s == 0 (those blocks complete there).  This
        # is exactly the recursive scheme's set of balanced sub-subtree
        # (start, end) pairs — reversal-symmetric, unlike a check against
        # the subtree start at every step, which biases the stationary
        # distribution (round-5 fix; calibration-tested on a Gaussian).
        scales = 2 ** jnp.arange(1, max_depth + 1, dtype=jnp.int32)
        dirsgn = jnp.where(go_right, 1.0, -1.0).astype(dt)

        def leap_body(i, c):
            (th, r, g, log_w_sub, prop_sub, key_s, sum_a, n_a, bad,
             stk_th, stk_r) = c
            eps_d = jnp.where(go_right, eps, -eps)
            r_half = r + 0.5 * eps_d * g
            th = th + eps_d * inv_mass * r_half
            logp, g = vg_fn(th)
            r = r_half + 0.5 * eps_d * g
            joint = logp - _kinetic(r, inv_mass)
            delta = joint - joint0
            bad = bad | (delta < -1000.0) | jnp.isnan(delta)
            save = (i % scales) == 0                          # (S,)
            stk_th = jnp.where(save[:, None], th[None, :], stk_th)
            stk_r = jnp.where(save[:, None], r[None, :], stk_r)
            check = ((i + 1) % scales) == 0
            dth = (th[None, :] - stk_th) * dirsgn             # (S, dim)
            d_end = jnp.sum(dth * (inv_mass * r), axis=-1)   # (S,)
            d_beg = jnp.sum(dth * (inv_mass * stk_r), axis=-1)
            bad = bad | jnp.any(check & ((d_end < 0) | (d_beg < 0)))
            # progressive multinomial within the new subtree
            log_w_new = jnp.logaddexp(log_w_sub, delta)
            key_s, ku = jax.random.split(key_s)
            take = jnp.log(jax.random.uniform(ku, dtype=dt)) < delta - log_w_new
            prop_sub = jnp.where(take & ~bad, th, prop_sub)
            sum_a = sum_a + jnp.minimum(jnp.exp(delta), 1.0)
            return (th, r, g, log_w_new, prop_sub, key_s, sum_a, n_a + 1,
                    bad, stk_th, stk_r)

        th_start = jnp.where(go_right, tp, tm)
        r_start = jnp.where(go_right, rp, rm)
        g_start = jnp.where(go_right, gp, gm)
        key, ksub = jax.random.split(key)
        stk0 = jnp.zeros((max_depth, dim), dt)
        init = (th_start, r_start, g_start, jnp.asarray(-jnp.inf, dt),
                th_start, ksub, jnp.asarray(0.0, dt),
                jnp.asarray(0, jnp.int32), jnp.asarray(False), stk0, stk0)
        (th_e, r_e, g_e, log_w_sub, prop_sub, _, sum_a, n_a, div, _,
         _) = jax.lax.fori_loop(0, n_leap, leap_body, init)

        # merge subtree into trajectory (biased progressive sampling); an
        # internally-invalid subtree contributes neither weight nor proposal
        log_sum_w_new = jnp.where(div, log_sum_w,
                                  jnp.logaddexp(log_sum_w, log_w_sub))
        take_sub = (jnp.log(jax.random.uniform(ksel, dtype=dt))
                    < log_w_sub - log_sum_w)
        prop_new = jnp.where(take_sub & ~div, prop_sub, prop)

        tp_n = jnp.where(go_right, th_e, tp)
        rp_n = jnp.where(go_right, r_e, rp)
        gp_n = jnp.where(go_right, g_e, gp)
        tm_n = jnp.where(go_right, tm, th_e)
        rm_n = jnp.where(go_right, rm, r_e)
        gm_n = jnp.where(go_right, gm, g_e)
        turning = _uturn(tp_n, tm_n, rp_n, rm_n, inv_mass)
        new_done = done | div | turning

        # freeze once done (delayed: state from completed doublings kept)
        frz = lambda old, new: jnp.where(done, old, new)
        return ((key, frz(tp, tp_n), frz(rp, rp_n), frz(gp, gp_n),
                 frz(tm, tm_n), frz(rm, rm_n), frz(gm, gm_n),
                 frz(prop, prop_new),
                 frz(log_sum_w, log_sum_w_new),
                 sum_acc + jnp.where(done, 0.0, sum_a),
                 n_acc + jnp.where(done, 0, n_a), new_done), None)

    init = (key, theta0, r0, g0, theta0, r0, g0, theta0,
            jnp.asarray(0.0, dt),  # weight of the initial state: exp(0)
            jnp.asarray(0.0, dt), jnp.asarray(0, jnp.int32),
            jnp.asarray(False))
    carry, _ = jax.lax.scan(one_doubling, init,
                            jnp.arange(max_depth, dtype=jnp.int32))
    theta_new = carry[7]
    accept_stat = carry[9] / jnp.maximum(carry[10], 1)
    return theta_new, accept_stat


def _hmc_transition(logpost_fn, grad_fn, key, theta0, eps, inv_mass, n_leap):
    """Plain HMC with a uniformly jittered number of leapfrog steps.

    As in ``_nuts_transition``, the loop carries (logp, grad) so one
    value_and_grad per step is the only copy of the posterior graph."""
    dt = theta0.dtype
    dim = theta0.shape[0]
    vg_fn = jax.value_and_grad(logpost_fn)
    key, kr, kl, ka = jax.random.split(key, 4)
    r0 = jax.random.normal(kr, (dim,), dt) * jnp.sqrt(1.0 / inv_mass)
    steps = jax.random.randint(kl, (), 1, n_leap + 1)
    logp0, g0 = vg_fn(theta0)

    def step(c):
        th, r, logp, g = c
        r_half = r + 0.5 * eps * g
        th = th + eps * inv_mass * r_half
        logp, g = vg_fn(th)
        return th, r_half + 0.5 * eps * g, logp, g

    def body(i, c):
        return jax.lax.cond(i < steps, step, lambda c: c, c)

    theta, r, logp, _ = jax.lax.fori_loop(0, n_leap, body,
                                          (theta0, r0, logp0, g0))
    joint0 = logp0 - _kinetic(r0, inv_mass)
    joint = logp - _kinetic(r, inv_mass)
    delta = jnp.where(jnp.isnan(joint), -jnp.inf, joint - joint0)
    accept_prob = jnp.minimum(jnp.exp(delta), 1.0)
    take = jax.random.uniform(ka, dtype=dt) < accept_prob
    return jnp.where(take, theta, theta0), accept_prob


def run_hmc(logpost_fn, theta0, key, num_warmup=500, num_samples=500,
            algorithm="nuts", max_depth=6, n_leap=32, target_accept=0.8,
            init_step_size=0.1):
    """Adaptive HMC/NUTS chain; returns (samples, accept_stats, step_size).

    Fully jit-compatible: warmup (dual-averaging step size + Welford diagonal
    mass matrix, Stan windowing simplified to one window) and sampling are two
    lax.scans.  `algorithm` is 'nuts' (dynamic trajectory length) or 'hmc'.
    """
    theta0 = jnp.asarray(theta0)
    dt = theta0.dtype
    dim = theta0.shape[0]
    grad_fn = jax.grad(logpost_fn)

    def transition(key, theta, eps, inv_mass):
        if algorithm == "nuts":
            return _nuts_transition(logpost_fn, grad_fn, key, theta, eps,
                                    inv_mass, max_depth)
        return _hmc_transition(logpost_fn, grad_fn, key, theta, eps, inv_mass,
                               n_leap)

    # ---- warmup: dual averaging + Welford ----
    mu = jnp.log(10.0 * init_step_size)
    gamma, t0, kappa = 0.05, 10.0, 0.75

    def warm_step(carry, k):
        theta, log_eps, log_eps_bar, h_bar, t, w_mean, w_m2, inv_mass = carry
        theta, astat = transition(k, theta, jnp.exp(log_eps), inv_mass)
        t = t + 1.0
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - astat) / (t + t0)
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        d = theta - w_mean
        w_mean = w_mean + d / t
        w_m2 = w_m2 + d * (theta - w_mean)
        return (theta, log_eps, log_eps_bar, h_bar, t, w_mean, w_m2,
                inv_mass), astat

    key, kw = jax.random.split(key)
    warm_keys = jax.random.split(kw, num_warmup)
    half = num_warmup // 2
    init = (theta0, jnp.log(jnp.asarray(init_step_size, dt)),
            jnp.asarray(0.0, dt), jnp.asarray(0.0, dt), jnp.asarray(0.0, dt),
            jnp.zeros(dim, dt), jnp.zeros(dim, dt), jnp.ones(dim, dt))
    # first half: adapt step size only
    carry, _ = jax.lax.scan(warm_step, init, warm_keys[:half])
    # second half: also accumulate the mass matrix
    theta, log_eps, log_eps_bar, h_bar, t, _, _, inv_mass = carry
    carry = (theta, log_eps, log_eps_bar, h_bar, jnp.asarray(0.0, dt),
             jnp.zeros(dim, dt), jnp.zeros(dim, dt), inv_mass)
    carry, _ = jax.lax.scan(warm_step, carry, warm_keys[half:])
    theta, _, log_eps_bar, _, t, w_mean, w_m2, _ = carry
    var = w_m2 / jnp.maximum(t - 1.0, 1.0)
    inv_mass = jnp.where(var > 0, var, 1.0)  # inv mass = posterior variance
    eps = jnp.exp(log_eps_bar)

    # ---- sampling ----
    def samp_step(theta, k):
        theta, astat = transition(k, theta, eps, inv_mass)
        return theta, (theta, astat)

    key, ks = jax.random.split(key)
    _, (samples, astats) = jax.lax.scan(samp_step, theta,
                                        jax.random.split(ks, num_samples))
    return samples, astats, eps


def sample_posterior(spec, z, nuggets=None, covmodel="matern",
                     log_prior=None, theta_ini=None, num_warmup=300,
                     num_samples=300, num_chains=4, seed=0, mesh=None,
                     algorithm="nuts", estimate_nugget=True, **hmc_kwargs):
    """Posterior over log Matern params (+ log nugget) given observations.

    Builds log-posterior = Vecchia loglik + `log_prior` (default: unit-scale
    normal on log-params, a weakly-informative choice), runs `num_chains`
    adaptive chains via vmap, and shards chains over the 'chains' axis of
    `mesh` when given.  Returns dict with 'samples' (chains, draws, dim) on
    the original (exp) scale, 'accept_stats', 'step_size'.
    """
    from ..inference.likelihood import loglik_core

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    core, dev = loglik_core(spec, covmodel, dtype=dtype)
    z = jnp.asarray(z, dtype)
    n_obs = spec.n_obs

    if theta_ini is None:
        zv = float(np.nanvar(np.asarray(z), ddof=1))
        theta_ini = np.array([0.9 * zv, 0.3, 0.8] + ([0.1 * zv] if
                                                     estimate_nugget else []))
    theta_ini = np.asarray(theta_ini, np.float64)
    dim = theta_ini.size

    if nuggets is not None:
        nug_fixed = jnp.broadcast_to(jnp.asarray(nuggets, dtype), (n_obs,))
    else:
        nug_fixed = None

    if log_prior is None:
        center = jnp.asarray(np.log(theta_ini), dtype)

        def log_prior(lg):
            return -0.5 * jnp.sum((lg - center) ** 2 / 4.0)

    def _run(chain_keys, theta0, dev):
        # dev is a tracer argument here, so the logpost closure stays inside
        # this trace (no executable-baked constants)
        def logpost(lg):
            theta = jnp.exp(lg)
            if estimate_nugget and nug_fixed is None:
                ll = core(dev, z, theta[:dim - 1],
                          jnp.broadcast_to(theta[dim - 1], (n_obs,)))
            else:
                ll = core(dev, z, theta, nug_fixed if nug_fixed is not None
                          else jnp.full((n_obs,), 1e-8, dtype))
            return ll + log_prior(lg)

        return jax.vmap(
            lambda k, t0: run_hmc(logpost, t0, k, num_warmup=num_warmup,
                                  num_samples=num_samples,
                                  algorithm=algorithm, **hmc_kwargs)
        )(chain_keys, theta0)

    run = jax.jit(_run)
    key = jax.random.PRNGKey(seed)
    chain_keys = jax.random.split(key, num_chains)
    jitter = jax.random.normal(jax.random.PRNGKey(seed + 1),
                               (num_chains, dim), dtype) * 0.1
    theta0 = jnp.asarray(np.log(theta_ini), dtype)[None, :] + jitter

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P("chains"))
        chain_keys = jax.device_put(chain_keys, sh)
        theta0 = jax.device_put(theta0, sh)
    samples_log, astats, eps = run(chain_keys, theta0, dev)
    return {"samples": np.exp(np.asarray(samples_log)),
            "samples_log": np.asarray(samples_log),
            "accept_stats": np.asarray(astats),
            "step_size": np.asarray(eps)}
