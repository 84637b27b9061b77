"""The U-entries small-matrix solve: batched packed SPD solves against e0.

`_solve_e0` is the one XLA formulation (batched cholesky + cho_solve on the
unpacked matrices) that serves every backend; these tests pin it against
dense NumPy, its gradient against the analytic rule, and the handling of
padded slots, failed rows and row chunks in `u_entries`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpvecchia_tpu.kernels.covariance import matern
from gpvecchia_tpu.kernels.u_entries import (_packed_index, _postprocess,
                                             _solve_e0, build_cov_packed,
                                             u_entries)

# relative max-abs error against the f64 NumPy solve: f32 rounding through
# an O(F^3) Cholesky of well-conditioned matrices
_TOL = {jnp.float32: 2e-5, jnp.float64: 1e-12}


def _packed_spd(rng, n, F, dtype):
    A = rng.normal(size=(n, F, F))
    C = A @ np.swapaxes(A, 1, 2) + F * np.eye(F)
    iu, ju, _ = _packed_index(F)
    return C, jnp.asarray(C[:, iu, ju].T, dtype)


def _relerr(x, ref):
    x = np.asarray(x, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [3, 9, 21, 41])
def test_solve_e0_matches_dense(F, dtype):
    rng = np.random.default_rng(F)
    C, Cp = _packed_spd(rng, 150, F, dtype)
    x = _solve_e0(Cp, F)
    assert x.shape == (150, F) and x.dtype == dtype
    assert _relerr(x, np.linalg.solve(C, np.eye(F)[0])) < _TOL[dtype]


def test_solve_e0_gradient_matches_analytic_rule():
    """d(key . x)/dCp for x = C^{-1} e0: with w = C^{-1} key, the packed
    cotangent is -(w x^T + x w^T) on the upper triangle, halved on the
    diagonal (each off-diagonal packed entry stands for C[i,j] and C[j,i])."""
    rng = np.random.default_rng(1)
    F, n = 9, 40
    C, Cp = _packed_spd(rng, n, F, jnp.float64)
    key = rng.normal(size=(n, F))
    g = jax.grad(lambda cp: jnp.sum(_solve_e0(cp, F) * key))(Cp)
    x = np.linalg.solve(C, np.eye(F)[0])
    w = np.linalg.solve(C, key[..., None])[..., 0]
    full = -(w[:, :, None] * x[:, None, :] + x[:, :, None] * w[:, None, :])
    full[:, np.arange(F), np.arange(F)] *= 0.5
    iu, ju, _ = _packed_index(F)
    assert _relerr(g, full[:, iu, ju].T) < 1e-11


def _conditioning_problem(n=130, F=6, seed=2):
    rng = np.random.default_rng(seed)
    locs = jnp.asarray(rng.uniform(size=(n, 2)))
    NN = np.stack([np.arange(n)] + [(np.arange(n) + k) % n
                                    for k in range(1, F)], axis=1)
    valid = np.ones((n, F), bool)
    valid[::3, 4:] = False                       # short conditioning sets
    return (locs, jnp.asarray(np.where(valid, NN, 0)), jnp.asarray(valid),
            jnp.full((n,), 0.1))


def test_invalid_slots_are_identity_extended():
    locs, NN, valid, nug = _conditioning_problem()
    F = NN.shape[1]
    Cp = build_cov_packed(locs, NN, valid, valid, nug, matern,
                          jnp.asarray([1.0, 0.2, 0.5]))
    x = np.asarray(_solve_e0(Cp, F))
    # padded slots decouple from the rest: the solution vanishes there
    assert np.all(x[::3, 4:] == 0.0)
    iu, ju, pk = _packed_index(F)
    C = np.asarray(Cp).T[:, pk]
    ref = np.linalg.solve(C, np.eye(F)[0])
    assert _relerr(x, ref) < 1e-12


def test_non_spd_row_surfaces_as_bad_row():
    rng = np.random.default_rng(3)
    F, n = 5, 20
    C, _ = _packed_spd(rng, n, F, jnp.float64)
    C[7] = -np.eye(F)                            # not positive definite
    iu, ju, _ = _packed_index(F)
    x = _solve_e0(jnp.asarray(C[:, iu, ju].T), F)
    col, bad = _postprocess(x / jnp.sqrt(x[:, :1]), jnp.ones((n, F), bool))
    assert np.flatnonzero(np.asarray(bad)).tolist() == [7]
    np.testing.assert_array_equal(np.asarray(col[7]), np.eye(F)[0])
    assert np.all(np.isfinite(np.asarray(col)))


def test_row_chunks_pad_and_match_unchunked():
    locs, NN, valid, nug = _conditioning_problem()
    args = (locs, NN, valid, valid, nug, matern,
            jnp.asarray([1.0, 0.2, 0.5]))
    col1, bad1 = u_entries(*args)
    col3, bad3 = u_entries(*args, row_chunks=3)    # 130 rows: padded to 132
    np.testing.assert_allclose(np.asarray(col3), np.asarray(col1),
                               rtol=1e-12, atol=1e-15)
    assert not np.any(np.asarray(bad1)) and not np.any(np.asarray(bad3))
