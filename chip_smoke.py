#!/usr/bin/env python
"""Smoke run of the Vecchia main path on an NVIDIA GPU.

Drives the public entry points once at the sizes users run (n=1e5/m=20 and
n=1e6/m=40 SGV, random locations and data from a fixed seed), checks every
result, and prints one line per phase with its numbers and the card.  Any
failed check raises and the script exits non-zero; no phase's error is
swallowed.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python chip_smoke.py             # one card, every phase
    python chip_smoke.py --cards 4   # only the sharded likelihood and
                                     # gradient (n=1e6/m=40) and posterior
                                     # (n=1e5/m=20) over 4 cards vs one card

Exits non-zero, printing no result, when JAX finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1988
N_LARGE, M_LARGE = 1_000_000, 40      # the sizes users call real
N_SMALL, M_SMALL = 100_000, 20
N_CPU = 2000                          # GPU vs CPU f64 check (m=M_LARGE)
COVPARMS = np.array([1.0, 0.2, 0.5])      # variance, range, smoothness
NUGGET = 0.1

# ---- tolerances (relative unless stated), each with its reason ----------
# Each f32 limit sits between the sound reading and a control reading on an
# H100 (n=1e5/m=20): the control let the multifrontal contractions run in
# TF32 (precision DEFAULT under jax_default_matmul_precision=tensorfloat32).
# f32 vs f64 loglik of the same path: sound 8.7e-8, TF32 control 1.5e-6;
# a weak TF32 detector, the gradient and posterior checks are the strong ones
TOL_LL_F32 = 1e-6
# f32 vs f64 gradient in (variance, range, smoothness), relative to its
# largest component: sound 5.9e-8, TF32 control 2.3e-5
TOL_GRAD_F32 = 1e-6
# f64 GPU vs f64 CPU loglik of one spec: only summation order differs
TOL_LL_CPU_F64 = 1e-8
# f32 vs f64 posterior mean / variances, relative to their max magnitude:
# sound 6.5e-6 (mean) and 4.0e-6 (variances), TF32 control 4.6e-3 and 8.9e-3
TOL_POST_F32 = 1e-4
# sharded (4 cards) vs one card, f32: only summation order and the
# reduction across cards differ
TOL_SHARD_LL = 1e-5
TOL_SHARD_GRAD = 1e-3
TOL_SHARD_POST = 1e-4

CARD = "?"


def require_gpu():
    """Exit non-zero unless JAX's default backend is an NVIDIA GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found '{backend}'")
    return jax.devices()


def report(phase, **kv):
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items} card={CARD}", flush=True)


def check(phase, name, err, tol):
    report(phase, check=name, err=f"{err:.3e}", tol=f"{tol:.0e}")
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{phase}: {name} error {err:.3e} > {tol:.0e}")


def relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def synced(fn, *args):
    import jax
    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t


def make_locs(n, seed=SEED):
    return np.random.default_rng(seed).uniform(size=(n, 2))


def make_z(n, seed=SEED + 1):
    return np.random.default_rng(seed).normal(size=n)


def phase_device(devices):
    import jax
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    CARD = f"'{smi.splitlines()[0]}'"
    from gpvecchia_tpu.csrc import require_lib
    from gpvecchia_tpu.utils.runtime import device_memory_limit
    require_lib()                 # set-up must not fall back to NumPy
    report("device", platform=jax.default_backend(),
           kind=repr(devices[0].device_kind), count=len(devices),
           jax=jax.__version__,
           bytes_limit=device_memory_limit(devices[0]))


def start_cpu_reference():
    """Start the f64 loglik of the n=2000/m=40 spec on the CPU in a child
    with JAX_PLATFORMS=cpu, which never opens the card; it runs while the
    card works.  `cpu_reference_loglik` collects it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-reference"], env=env,
                            stdout=subprocess.PIPE, text=True)


def cpu_reference_loglik(child):
    out, _ = child.communicate()
    if child.returncode != 0:
        raise RuntimeError(f"CPU reference exited {child.returncode}")
    return float(out.strip().splitlines()[-1])


def near_covparms(k):
    """COVPARMS with variance and range moved by k%: a new value each eval,
    the same smoothness (so the same ν=0.5 path as the first eval)."""
    return COVPARMS * np.array([1 + 0.01 * k, 1 + 0.01 * k, 1.0])


def _small_loglik(dtype):
    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import loglik_fn
    n = N_CPU
    spec = vecchia_specify(make_locs(n), m=M_LARGE, cond_yz="SGV")
    return float(loglik_fn(spec, "matern", dtype=dtype)(
        make_z(n), COVPARMS, np.full(n, NUGGET)))


def phase_loglik_small(cpu_child):
    """n=1e5/m=20 SGV: loglik and its gradient, f32 vs f64 on the card;
    n=2000/m=40: f64 on the card vs f64 on the CPU."""
    import jax
    import jax.numpy as jnp
    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import loglik_core, loglik_fn

    try:
        ll_gpu = _small_loglik(jnp.float64)
        ll_cpu = cpu_reference_loglik(cpu_child)
    finally:
        cpu_child.kill()          # no-op once it has exited
    check(f"loglik_n{N_CPU}", "f64 GPU vs f64 CPU",
          abs(ll_gpu - ll_cpu) / abs(ll_cpu), TOL_LL_CPU_F64)

    n = N_SMALL
    t = time.perf_counter()
    spec = vecchia_specify(make_locs(n), m=M_SMALL, cond_yz="SGV")
    report("loglik_n1e5", spec_s=f"{time.perf_counter() - t:.2f}")
    z = make_z(n)
    nug = np.full(n, NUGGET)
    vals, grads = {}, {}
    for dt in (jnp.float32, jnp.float64):
        name = jnp.dtype(dt).name
        fn = loglik_fn(spec, "matern", dtype=dt)
        v, t_first = synced(fn, z, COVPARMS, nug)
        ts = [synced(fn, z, near_covparms(k), nug)[1] for k in range(1, 6)]
        core, dev = loglik_core(spec, "matern", dt)
        vg = jax.jit(jax.value_and_grad(core, argnums=2))
        args = (dev, jnp.asarray(z, dt), jnp.asarray(COVPARMS, dt),
                jnp.asarray(nug, dt))
        (gv, g), tg_first = synced(vg, *args)
        tg = [synced(vg, *args)[1] for _ in range(3)]
        vals[name], grads[name] = float(v), np.asarray(g)
        report("loglik_n1e5", dtype=name, loglik=f"{float(v):.6f}",
               first_eval_s=f"{t_first:.2f}",
               eval_ms=",".join(f"{1e3 * x:.3f}" for x in ts),
               median_ms=f"{1e3 * float(np.median(ts)):.3f}",
               grad_first_s=f"{tg_first:.2f}",
               grad_ms=f"{1e3 * float(np.median(tg)):.3f}",
               grad=np.array2string(np.asarray(g), precision=6))
        check("loglik_n1e5", f"{name} value_and_grad value vs loglik_fn",
              abs(float(gv) - float(v)) / abs(float(v)),
              TOL_LL_F32 if name == "float32" else 1e-10)
    check("loglik_n1e5", "f32 vs f64 value",
          abs(vals["float32"] - vals["float64"]) / abs(vals["float64"]),
          TOL_LL_F32)
    check("loglik_n1e5", "f32 vs f64 gradient",
          relerr(grads["float32"], grads["float64"]), TOL_GRAD_F32)
    return spec


def phase_mle():
    from gpvecchia_tpu.fit.mle import vecchia_estimate
    n = N_SMALL
    t = time.perf_counter()
    est = vecchia_estimate(make_z(n, SEED + 2), make_locs(n), m=M_SMALL,
                           max_iter=4, output_level=0)
    theta = np.asarray(est["theta_hat"])
    report("mle_n1e5", seconds=f"{time.perf_counter() - t:.2f}",
           theta=np.array2string(theta, precision=5))
    if not np.all(np.isfinite(theta)) or np.any(theta <= 0):
        raise AssertionError(f"mle: theta_hat {theta} not finite/positive")


def phase_loglik_large():
    """n=1e6/m=40 SGV, f32: set-up, compile, synced per-eval time, memory."""
    import jax
    import jax.numpy as jnp
    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import loglik_fn

    n = N_LARGE
    t = time.perf_counter()
    spec = vecchia_specify(make_locs(n), m=M_LARGE, cond_yz="SGV")
    t_spec = time.perf_counter() - t
    fn = loglik_fn(spec, "matern", dtype=jnp.float32)
    z = jnp.asarray(make_z(n), jnp.float32)
    v, t_first = synced(fn, z, COVPARMS, np.float32(NUGGET))
    ts = [synced(fn, z, near_covparms(k), np.float32(NUGGET))[1]
          for k in range(1, 6)]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    report("loglik_n1e6", spec_s=f"{t_spec:.2f}",
           compile_and_first_s=f"{t_first:.2f}",
           eval_ms=",".join(f"{1e3 * x:.3f}" for x in ts),
           median_ms=f"{1e3 * float(np.median(ts)):.3f}",
           loglik=f"{float(v):.3f}", peak_bytes_in_use=peak)
    if not np.isfinite(float(v)):
        raise AssertionError(f"loglik_n1e6: {float(v)}")
    return spec


def phase_posterior_large(spec):
    """n=1e6/m=40 posterior mean + selected-inverse variances, f32."""
    import jax
    import jax.numpy as jnp
    from gpvecchia_tpu.inference.prediction import _pred_fns

    n = spec.n_obs
    z, nug = make_z(n), np.full(n, NUGGET)
    (mean_fn, var_fn), _ = _pred_fns(spec, "matern", jnp.float32)
    (mu, fac), t_mean = synced(mean_fn, z, COVPARMS, nug)
    var, t_var = synced(var_fn, fac)
    (mu, fac), t_mean2 = synced(mean_fn, z, COVPARMS, nug)
    var, t_var2 = synced(var_fn, fac)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    report("posterior_n1e6", mean_first_s=f"{t_mean:.2f}",
           var_first_s=f"{t_var:.2f}", mean_ms=f"{1e3 * t_mean2:.2f}",
           selinv_ms=f"{1e3 * t_var2:.2f}", peak_bytes_in_use=peak)
    var = np.asarray(var)
    if not (np.all(var > 0) and np.all(np.isfinite(np.asarray(mu)))):
        raise AssertionError("posterior_n1e6: non-positive variance or "
                             "non-finite mean")


def phase_posterior(spec):
    import jax.numpy as jnp
    from gpvecchia_tpu.inference.prediction import (_extract, _pred_fns,
                                                    vecchia_prediction)
    n = spec.n_obs
    z = make_z(n)
    nug = np.full(n, NUGGET)
    t = time.perf_counter()
    post = vecchia_prediction(z, spec, COVPARMS, nug)          # f64
    t64 = time.perf_counter() - t
    (mean_fn, var_fn), _ = _pred_fns(spec, "matern", jnp.float32)
    t = time.perf_counter()
    mu32, fac = mean_fn(z, COVPARMS, nug)
    var32 = np.asarray(var_fn(fac))
    t32 = time.perf_counter() - t
    mu32_obs, _ = _extract(spec, np.asarray(mu32))
    var32_obs, _ = _extract(spec, var32)
    var64 = post["var_obs"]
    report("posterior_n1e5", f64_s=f"{t64:.2f}", f32_first_s=f"{t32:.2f}",
           var_min=f"{float(np.min(var64)):.4e}",
           var_max=f"{float(np.max(var64)):.4e}")
    if not np.all(var64 > 0) or not np.all(var32_obs > 0):
        raise AssertionError("posterior: non-positive variances")
    check("posterior_n1e5", "f32 vs f64 mean", relerr(mu32_obs,
                                                      post["mu_obs"]),
          TOL_POST_F32)
    check("posterior_n1e5", "f32 vs f64 variance", relerr(var32_obs, var64),
          TOL_POST_F32)


def phase_vl(spec):
    from gpvecchia_tpu.inference.laplace import calculate_posterior_VL
    n = spec.n_obs
    zb = (np.random.default_rng(SEED + 3).uniform(size=n) < 0.5).astype(
        np.float64)
    t = time.perf_counter()
    post = calculate_posterior_VL(zb, spec, "logistic", COVPARMS,
                                  max_iter=50)
    report("vl_logistic_n1e5", seconds=f"{time.perf_counter() - t:.2f}",
           iterations=post["iter"], converged=post["cnvgd"])
    if not np.all(np.isfinite(post["mean"])):
        raise AssertionError("vl: non-finite posterior mean")


def phase_gpu_tests():
    """The repository's `gpu`-marked tests, in this process (one process
    per card)."""
    import pytest
    os.environ["GPV_TEST_PLATFORM"] = "gpu"
    t = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(_HERE, "tests")])
    report("gpu_tests", rc=int(rc), seconds=f"{time.perf_counter() - t:.2f}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc {rc})")


def _sharded_job(pool, task, spec, mesh, dt):
    """Device arrays and data of `task` for the 4-card mesh and for one
    card, and both executables' compiles started in `pool` (XLA compiles
    release the GIL, so they build side by side with the host's work)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gpvecchia_tpu.inference.likelihood import _device_arrays
    from gpvecchia_tpu.parallel.mesh import (sharded_loglik_core,
                                             sharded_posterior_core)
    from gpvecchia_tpu.plan import get_plan

    t = time.perf_counter()
    if task == "loglik":
        core, sdev = sharded_loglik_core(spec, "matern", mesh, dt)
        fn = jax.value_and_grad(core, argnums=2)
    else:
        core, sdev = sharded_posterior_core(spec, "matern", mesh, dt)
        fn = core
    dev1 = _device_arrays(get_plan(spec, dt))
    n = spec.n_obs
    data = [np.asarray(x, dt) for x in
            (make_z(n), COVPARMS, np.full(n, NUGGET))]
    one = mesh.devices.flat[0]
    args4 = (sdev, *jax.device_put(data, NamedSharding(mesh, P())))
    args1 = (dev1, *jax.device_put(data, one))
    report(f"sharded_{task}", n=n, plan_s=f"{time.perf_counter() - t:.2f}")
    t = time.perf_counter()
    futs = [pool.submit(lambda a: jax.jit(fn).lower(*a).compile(), a)
            for a in (args4, args1)]
    return dict(task=task, n=n, t=t, futs=futs, args=(args4, args1))


def _sharded_check(job):
    """Run both executables of `job` (one card first) and compare."""
    exe4, exe1 = (f.result() for f in job["futs"])
    compile_s = time.perf_counter() - job["t"]
    args4, args1 = job["args"]
    out1, _ = synced(exe1, *args1)
    t1 = [synced(exe1, *args1)[1] for _ in range(3)]
    out4, _ = synced(exe4, *args4)
    t4 = [synced(exe4, *args4)[1] for _ in range(3)]
    task = job["task"]
    phase = f"sharded_{task}"
    times = dict(compile_both_s=f"{compile_s:.2f}",
                 ms_4_cards=",".join(f"{1e3 * x:.2f}" for x in t4),
                 ms_1_card=",".join(f"{1e3 * x:.2f}" for x in t1))
    if task == "loglik":
        (v4, g4), (v1, g1) = out4, out1
        report(phase, n=job["n"], cards=4, loglik=f"{float(v4):.4f}",
               one_card_loglik=f"{float(v1):.4f}",
               grad4=np.array2string(np.asarray(g4), precision=6),
               grad1=np.array2string(np.asarray(g1), precision=6), **times)
        check(phase, "4 cards vs 1 card value",
              abs(float(v4) - float(v1)) / abs(float(v1)), TOL_SHARD_LL)
        check(phase, "4 cards vs 1 card gradient", relerr(g4, g1),
              TOL_SHARD_GRAD)
    else:
        (mu4, var4), (mu1, var1) = out4, out1
        report(phase, n=job["n"], cards=4,
               var_min=f"{float(np.min(np.asarray(var4))):.4e}", **times)
        if not np.all(np.asarray(var4) > 0):
            raise AssertionError("sharded posterior: variance <= 0")
        check(phase, "4 cards vs 1 card mean", relerr(mu4, mu1),
              TOL_SHARD_POST)
        check(phase, "4 cards vs 1 card variance", relerr(var4, var1),
              TOL_SHARD_POST)


def phase_sharded(devices):
    """Sharded posterior (n=1e5/m=20) and loglik + gradient (n=1e6/m=40) on
    a flat (chains=1, rows=4) mesh, each against one card on the same spec.
    The posterior's two compiles overlap the n=1e6 spec build; the loglik's
    two compiles overlap the posterior's runs."""
    from concurrent.futures import ThreadPoolExecutor
    import jax.numpy as jnp
    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.parallel.mesh import make_mesh

    dt = jnp.float32
    mesh = make_mesh(devices[:4], chains=1)
    with ThreadPoolExecutor(4) as pool:
        jobs = []
        for n, m in ((N_SMALL, M_SMALL), (N_LARGE, M_LARGE)):
            t = time.perf_counter()
            spec = vecchia_specify(make_locs(n), m=m, cond_yz="SGV")
            report("sharded", n=n, m=m,
                   spec_s=f"{time.perf_counter() - t:.2f}")
            jobs.append(_sharded_job(pool, "posterior" if n == N_SMALL
                                     else "loglik", spec, mesh, dt))
        for job in jobs:
            _sharded_check(job)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--cpu-reference", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, _HERE)
    import jax
    jax.config.update("jax_enable_x64", True)
    if args.cpu_reference:
        import jax.numpy as jnp
        print(repr(_small_loglik(jnp.float64)))
        return

    if args.cards == 4:
        # the one-card reference of the n=1e6 gradient peaks near 60 GB on
        # the first card, beside that card's share of the sharded arrays
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")
    devices = require_gpu()
    if len(devices) < args.cards:
        sys.exit(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
                 f"found {len(devices)}")
    from gpvecchia_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    t0 = time.perf_counter()
    phase_device(devices)
    if args.cards == 4:
        phase_sharded(devices)
    else:
        spec = phase_loglik_small(start_cpu_reference())
        phase_mle()
        phase_posterior(spec)
        phase_vl(spec)
        spec = phase_loglik_large()
        phase_posterior_large(spec)
        phase_gpu_tests()
    report("total", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
