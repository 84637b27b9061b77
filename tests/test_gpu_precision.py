"""f32 against f64 of the same path, on the card.

On the GPU an f32 contraction without an explicit precision may run in
TF32 (~3 decimal digits); these tests check the f32 value of each factor
path against f64 (the gradient and posterior, where TF32 shows most, are
checked the same way by chip_smoke.py).
They skip without a GPU (see conftest.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpvecchia_tpu import vecchia_specify
from gpvecchia_tpu.inference.likelihood import loglik_fn

N = 2000
COVPARMS = np.array([1.0, 0.2, 0.5])
# f32 loglik of 2000 O(1) terms through f32 factorizations (8.7e-8 relative
# at n=1e5 on an H100).  This limit catches gross precision loss only: TF32 in the multifrontal
# contractions moved the n=1e5 value by 1.5e-6 on an H100; chip_smoke.py's
# gradient and posterior checks are the ones that catch TF32.
TOL = 1e-4


def _problem(seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(N, 2)), rng.normal(size=N)


@pytest.mark.gpu
@pytest.mark.parametrize("kwargs", [
    dict(m=20, cond_yz="SGV"),                 # multifrontal 'chol' factor
    dict(m=20, cond_yz="zy"),                  # direct (response-first) path
    dict(m=20, cond_yz="SGV", ic0=True),       # incomplete Cholesky factor
], ids=["sgv", "zy", "ic0"])
def test_loglik_f32_matches_f64_on_gpu(gpu, kwargs):
    locs, z = _problem()
    spec = vecchia_specify(locs, **kwargs)
    nug = np.full(N, 0.1)
    v = {dt: float(loglik_fn(spec, "matern", dtype=dt)(z, COVPARMS, nug))
         for dt in (jnp.float32, jnp.float64)}
    assert abs(v[jnp.float32] - v[jnp.float64]) < TOL * abs(v[jnp.float64])
