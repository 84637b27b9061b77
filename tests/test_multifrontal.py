"""Multifrontal nested-dissection engine vs dense linear algebra.

W = sum_e u_e u_e^T + diag(d) assembled densely is the oracle; logdet,
quadratic forms, solves and diag(W^{-1}) must match to fp64 tolerance for
random element sets shaped like Vecchia conditioning columns.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpvecchia_tpu.linalg.blocked import (chol, tri_inv_lower, trsm_right,
                                          trsm_rightT)
from gpvecchia_tpu.linalg.multifrontal import (build_mf_plan,
                                               mf_backward, mf_device_arrays,
                                               mf_factor, mf_selinv_diag,
                                               mf_solve)


def _random_elements(rng, n_vert, K, density_scale=0.05):
    """Vecchia-like elements: each vertex owns one element of itself plus
    K-1 spatially-near earlier vertices."""
    xy = rng.uniform(size=(n_vert, 2))
    elem_verts = np.full((n_vert, K), -1, dtype=np.int64)
    elem_verts[:, 0] = np.arange(n_vert)
    for p in range(n_vert):
        if p == 0:
            continue
        d = np.linalg.norm(xy[:p] - xy[p], axis=1)
        k = min(K - 1, p)
        nb = np.argpartition(d, k - 1)[:k] if k < p else np.arange(p)
        elem_verts[p, 1:1 + k] = nb[:k]
    u_vals = np.where(elem_verts >= 0,
                      rng.normal(size=(n_vert, K)), 0.0)
    u_vals[:, 0] = np.abs(u_vals[:, 0]) + 1.0
    return elem_verts, xy, u_vals


def _dense_W(elem_verts, u_vals, dvec, n_vert):
    W = np.diag(dvec.astype(np.float64).copy())
    for e in range(elem_verts.shape[0]):
        ok = elem_verts[e] >= 0
        v = elem_verts[e][ok]
        u = u_vals[e][ok]
        W[np.ix_(v, v)] += np.outer(u, u)
    return W


@pytest.mark.parametrize("n_vert,K,leaf,leaf_chunks", [
    pytest.param(60, 5, 8, 1, id="60-5-8"),
    pytest.param(60, 5, 8, 4, id="60-5-8-chunks4"),
    pytest.param(120, 7, 8, 2, id="120-7-8-chunks2"),
    pytest.param(300, 9, 16, 1, marks=pytest.mark.slow, id="300-9-16"),
    pytest.param(300, 9, 512, 1, id="300-9-512")])
def test_mf_against_dense(n_vert, K, leaf, leaf_chunks):
    rng = np.random.default_rng(1988 + n_vert)
    elem_verts, xy, u_vals = _random_elements(rng, n_vert, K)
    dvec = rng.uniform(1.0, 3.0, size=n_vert) + 5.0 * K
    W = _dense_W(elem_verts, u_vals, dvec, n_vert)

    mf = build_mf_plan(elem_verts, xy, n_vert, leaf_elems=leaf)
    static, mfdev = mf_device_arrays(mf)
    assert (1 << static.depth) % leaf_chunks == 0
    rhs_e = rng.normal(size=n_vert)
    rhs_v = rng.normal(size=n_vert)
    fac = mf_factor(static, mfdev, jnp.asarray(u_vals), jnp.asarray(dvec),
                    rhs_elem=jnp.asarray(rhs_e), rhs_vert=jnp.asarray(rhs_v),
                    leaf_chunks=leaf_chunks)

    sign, logdet_ref = np.linalg.slogdet(W)
    assert sign > 0
    np.testing.assert_allclose(float(fac["logdet"]), logdet_ref, rtol=1e-9)

    # rhs = sum_e rhs_e[e] u_e + rhs_v
    b = rhs_v.copy()
    for e in range(elem_verts.shape[0]):
        ok = elem_verts[e] >= 0
        b[elem_verts[e][ok]] += rhs_e[e] * u_vals[e][ok]
    quad_ref = b @ np.linalg.solve(W, b)
    np.testing.assert_allclose(float(fac["quad"]), quad_ref, rtol=1e-8)

    x = np.asarray(mf_backward(static, mfdev, fac))
    # L^T x = y  =>  x = W^{-1} b
    np.testing.assert_allclose(x, np.linalg.solve(W, b), rtol=1e-7,
                               atol=1e-10)

    # independent solve path with a fresh RHS
    c = rng.normal(size=n_vert)
    xc = np.asarray(mf_solve(static, mfdev, fac, jnp.asarray(c)))
    np.testing.assert_allclose(xc, np.linalg.solve(W, c), rtol=1e-7,
                               atol=1e-10)

    d = np.asarray(mf_selinv_diag(static, mfdev, fac,
                                  leaf_chunks=leaf_chunks))
    np.testing.assert_allclose(d, np.diag(np.linalg.inv(W)), rtol=1e-7)


def test_blocked_dense_primitives():
    rng = np.random.default_rng(3)
    for P in (1, 3, 16, 24, 61, 96):
        A = rng.normal(size=(4, P, P))
        A = A @ np.swapaxes(A, -1, -2) + P * np.eye(P)
        L = np.asarray(chol(jnp.asarray(A)))
        np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-8,
                                   atol=1e-10)
        B = rng.normal(size=(4, 7, P))
        X = np.asarray(trsm_right(jnp.asarray(B), jnp.asarray(L)))
        np.testing.assert_allclose(X @ np.swapaxes(L, -1, -2), B, rtol=1e-8,
                                   atol=1e-9)
        X2 = np.asarray(trsm_rightT(jnp.asarray(B), jnp.asarray(L)))
        np.testing.assert_allclose(X2 @ L, B, rtol=1e-8, atol=1e-9)
        Li = np.asarray(tri_inv_lower(jnp.asarray(L)))
        np.testing.assert_allclose(Li @ L, np.broadcast_to(np.eye(P), A.shape),
                                   rtol=1e-8, atol=1e-8)
