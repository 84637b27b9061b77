"""End-to-end drive of the gpvecchia_tpu public API (the /verify recipe).

Run on CPU from the repository root with:
  JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python scripts/e2e_drive.py
"""
import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

import jax
print("backend:", jax.default_backend(), "x64:", jax.config.jax_enable_x64)

from gpvecchia_tpu import vecchia_specify
from gpvecchia_tpu.inference.likelihood import vecchia_likelihood
from gpvecchia_tpu.inference.prediction import vecchia_prediction
from gpvecchia_tpu.inference.laplace import (calculate_posterior_VL,
                                             vecchia_laplace_prediction)
from gpvecchia_tpu.fit.mle import vecchia_estimate, vecchia_pred

rng = np.random.default_rng(1988)
n = 300
locs = rng.uniform(size=(n, 2))

# simulate GP data
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tests'))
from reference_impl import matern_np
D = np.linalg.norm(locs[:, None] - locs[None, :], axis=-1)
K = matern_np(D, (2.0, 0.2, 1.5))
L = np.linalg.cholesky(K + 1e-10 * np.eye(n))
y = L @ rng.normal(size=n)
z = y + 0.3 * rng.normal(size=n)

# 1) likelihood: m=n-1 == dense GP logpdf
spec_full = vecchia_specify(locs, m=n - 1)
ll = vecchia_likelihood(z, spec_full, (2.0, 0.2, 1.5), 0.09)
Sig = K + 0.09 * np.eye(n)
s_, ld = np.linalg.slogdet(Sig)
llr = -0.5 * (n * np.log(2 * np.pi) + ld + z @ np.linalg.solve(Sig, z))
print(f"loglik m=n-1: {ll:.6f} dense {llr:.6f} diff {abs(ll-llr):.2e}")
assert abs(ll - llr) < 1e-6 * abs(llr)

# 2) SGV approx close
spec = vecchia_specify(locs, m=15, cond_yz="SGV")
ll2 = vecchia_likelihood(z, spec, (2.0, 0.2, 1.5), 0.09)
print(f"loglik SGV m=15: {ll2:.4f} (exact {llr:.4f})")
assert abs(ll2 - llr) < 0.02 * abs(llr)

# 3) estimate recovers parameters (loose sanity)
res = vecchia_estimate(z, locs, m=15, theta_ini=(1.0, 0.3, 1.0, 0.2),
                       max_iter=60)
theta = res["theta_hat"]
print("estimate theta_hat:", theta)
assert np.all(np.isfinite(theta))

# 4) prediction
locs_pred = rng.uniform(size=(40, 2))
spec_p = vecchia_specify(locs, m=15, locs_pred=locs_pred)
out = vecchia_prediction(z, spec_p, (2.0, 0.2, 1.5), 0.09)
assert np.all(np.isfinite(out["mu_pred"])) and np.all(out["var_pred"] > 0)
print("prediction ok: mu_pred range", out["mu_pred"].min(), out["mu_pred"].max())

# 5) wrapper pred
preds = vecchia_pred(res, locs_pred, m=15)
assert np.all(np.isfinite(preds["mean_pred"]))
print("vecchia_pred ok")

# 6) VL on Poisson data
lam = np.exp(y * 0.5)
zc = rng.poisson(lam).astype(float)
post = calculate_posterior_VL(zc, spec, "poisson", (1.0, 0.2, 1.5))
print("VL iters:", post["iter"], "converged:", post["cnvgd"])
assert post["cnvgd"] and post["iter"] < 20

# 7) VL prediction (data scale positive for exp link)
vlp = vecchia_laplace_prediction(post, spec_p, (1.0, 0.2, 1.5))
assert np.all(vlp["data_pred"] > 0)
print("VL prediction ok")

# 8) error probes
try:
    vecchia_specify(locs, m=10, locs_pred=locs[:3])
    raise SystemExit("FAIL: duplicate pred locations not caught")
except ValueError:
    print("duplicate pred locations -> ValueError ok")
try:
    calculate_posterior_VL(-np.abs(zc) - 1, spec, "poisson", (1.0, 0.2, 1.5))
    raise SystemExit("FAIL: invalid data not caught")
except ValueError:
    print("invalid VL data -> ValueError ok")
import warnings
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    sp = vecchia_specify(locs[:20], m=25)
    assert sp.m == 19
print("m>n capped ok")
zna = z.copy(); zna[:5] = np.nan
lln = vecchia_likelihood(zna, spec, (2.0, 0.2, 1.5), 0.09)
assert np.isfinite(lln)
print("NaN data -> finite loglik ok")

print("ALL E2E CHECKS PASSED")
