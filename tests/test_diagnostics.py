"""Numerical-failure surfacing: non-SPD conditioning rows are dropped and
COUNTED as a value (works under jit on every backend — the reference prints
to stderr, /root/reference/src/U_NZentries.cpp:60-66)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpvecchia_tpu import vecchia_specify
from gpvecchia_tpu.inference.likelihood import loglik_fn, vecchia_likelihood


def _setup(n=120, m=8):
    rng = np.random.default_rng(1988)
    locs = rng.uniform(size=(n, 2))
    z = rng.normal(size=n)
    return locs, z


def test_dropped_row_count_surfaces():
    locs, z = _setup()
    spec = vecchia_specify(locs, m=8, cond_yz="SGV")

    # a "covariance" with constant correlation > 1 off the diagonal is
    # massively non-PD once a row conditions on 2+ neighbors
    def poison(dist):
        return jnp.where(dist > 0, 1.5, 1.0)

    fn = loglik_fn(spec, poison, with_aux=True)
    ll, aux = fn(z, np.zeros(0), 0.1)
    assert int(aux["n_dropped_rows"]) > 0
    assert np.isfinite(float(ll))

    # healthy input reports zero drops and an unchanged value vs the
    # default path
    fn2 = loglik_fn(spec, "matern", with_aux=True)
    ll2, aux2 = fn2(z, np.array([1.0, 0.2, 0.5]), 0.1)
    assert int(aux2["n_dropped_rows"]) == 0
    ll_plain = vecchia_likelihood(z, spec, [1.0, 0.2, 0.5], 0.1)
    assert abs(float(ll2) - ll_plain) < 1e-8


def test_poisoned_vecchia_likelihood_warns():
    locs, z = _setup()
    spec = vecchia_specify(locs, m=8, cond_yz="SGV")

    def poison(dist):
        return jnp.where(dist > 0, 1.5, 1.0)

    with pytest.warns(UserWarning, match="Cholesky failed"):
        vecchia_likelihood(z, spec, np.zeros(0), 0.1, covmodel=poison)


def test_rvp_lk_get_zy_family_warning():
    locs, z = _setup()
    for mode in ("RVP", "LK", "zy"):
        spec = vecchia_specify(locs, m=8, cond_yz=mode)
        with pytest.warns(UserWarning, match="poor likelihood"):
            vecchia_likelihood(z, spec, [1.0, 0.2, 0.5], 0.1)


def test_scalar_and_vector_nuggets_agree():
    locs, z = _setup()
    spec = vecchia_specify(locs, m=8, cond_yz="SGV")
    cov = [1.0, 0.2, 0.5]
    a = vecchia_likelihood(z, spec, cov, 0.1)
    b = vecchia_likelihood(z, spec, cov, np.full(len(z), 0.1))
    assert abs(a - b) < 1e-8
    # with NaN data the inflation path must agree across the two forms too
    z2 = z.copy()
    z2[::7] = np.nan
    a2 = vecchia_likelihood(z2, spec, cov, 0.1)
    b2 = vecchia_likelihood(z2, spec, cov, np.full(len(z), 0.1))
    assert np.isfinite(a2) and abs(a2 - b2) < 1e-6
