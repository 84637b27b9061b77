#!/usr/bin/env python
"""Benchmark: Vecchia loglikelihood throughput on an NVIDIA GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Headline metric: the BASELINE.json north-star config (n=1e6, m=40, SGV)
loglik evals/s on one chip.  Extras carry the n=1e5/m=20 config and a
gradient-eval timing at n=1e5 (the MLE inner loop) so regressions in either
are visible every round.  Set BENCH_SMALL_ONLY=1 to skip the big config.

The parameter-free spec is cached on disk across runs, under
`<checkout>/.bench_cache/`.  Exits non-zero without a GPU; prints the card's
name and power limit before its result.

vs_baseline models the reference's OpenMP C++/R pipeline on a 16-core CPU
(the reference publishes no numbers, BASELINE.md): per likelihood
evaluation it must (a) run n dense (m+1)-Cholesky solves (U_NZentries,
/root/reference/src/U_NZentries.cpp:37-69; ~2(m+1)^3/3 flops each plus m^2
kernel evaluations, ~3 GFLOP/s effective for tiny LAPACK factorizations,
16-way parallel), and (b) a *sequential* sparse Cholesky of W.rev plus
triangular solves (~30 flops/nnz at ~1 GFLOP/s single-core).  This is a
deliberately generous model of the reference.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".bench_cache")


def _cache_path(name):
    os.makedirs(_CACHE, exist_ok=True)
    return os.path.join(_CACHE, name)


def modeled_reference_seconds(n, m, w_nnz):
    mp1 = m + 1
    per_row = (2.0 * mp1 ** 3 / 3.0 + 50.0 * mp1 * mp1) / 3e9  # chol+kernel
    part_a = n * per_row / 16.0                 # OpenMP over 16 cores
    part_b = w_nnz * 30.0 / 1e9                # sequential sparse chol+solves
    return part_a + part_b


def unfilled_w_nnz(plan):
    """nnz of the lower triangle of W = U_y U_y^T (pre-fill), for the cost
    model of the reference's sequential sparse Cholesky (an underestimate of
    its work, which also carries fill — deliberately conservative).  Cached
    on disk (it costs ~60 s of chunked np.unique at n=1e6)."""
    cache = _cache_path(f"wnnz_{plan.n_all}_{plan.NN.shape[1]}.txt")
    if os.path.exists(cache):
        return int(open(cache).read())
    NN = plan.NN.astype(np.int64)
    lr = plan.latent_rank.astype(np.int64)
    verts = np.where(plan.cond, lr[NN], -1)
    mp1 = verts.shape[1]
    iu, ju = np.triu_indices(mp1)
    uniq = np.empty(0, np.int64)
    step = max(1, 30_000_000 // iu.size)
    for s0 in range(0, verts.shape[0], step):
        v = verts[s0:s0 + step]
        a = v[:, iu].ravel()
        b = v[:, ju].ravel()
        ok = (a >= 0) & (b >= 0)
        keys = np.maximum(a[ok], b[ok]) * plan.n_lat + np.minimum(a[ok], b[ok])
        uniq = np.union1d(uniq, keys)
    with open(cache, "w") as f:
        f.write(str(int(uniq.size)))
    return int(uniq.size)


def run_config(n, m, cond, n_evals, dtype, with_grad=False):
    import jax
    import jax.numpy as jnp

    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import loglik_core, loglik_fn
    from gpvecchia_tpu.plan import get_plan

    rng = np.random.default_rng(1988)
    locs = rng.uniform(size=(n, 2))
    t0 = time.time()
    cache = _cache_path(f"spec_{n}_{m}_{cond}.npz")
    if os.path.exists(cache):
        from gpvecchia_tpu.utils.serialize import load_spec
        spec = load_spec(cache)
        print(f"[bench] spec loaded from {cache}", file=sys.stderr)
    else:
        spec = vecchia_specify(locs, m=m, cond_yz=cond)
        from gpvecchia_tpu.utils.serialize import save_spec
        save_spec(spec, cache)
    t1 = time.time()
    plan = get_plan(spec, dtype)
    w_nnz = unfilled_w_nnz(plan)
    t2 = time.time()
    print(f"[bench] n={n} spec {t1 - t0:.1f}s plan {t2 - t1:.1f}s "
          f"w_nnz={w_nnz} use_mf={plan.use_mf}", file=sys.stderr)

    fn = loglik_fn(spec, "matern", dtype=dtype)
    z = jnp.asarray(rng.normal(size=n), dtype)
    nug = dtype(0.1)
    covparms0 = np.array([1.0, 0.2, 0.5])

    t3 = time.time()
    out = float(fn(z, jnp.asarray(covparms0, dtype), nug))
    t4 = time.time()
    print(f"[bench] compile+first eval {t4 - t3:.1f}s loglik={out:.2f}",
          file=sys.stderr)

    # steady state: vary variance/range so nothing constant-folds (nu stays
    # 0.5: off half-integers the general Bessel path engages, which the
    # reference cost model's closed forms don't cover)
    scale = np.ones((n_evals, 3))
    scale[:, 0] = 1.0 + 0.01 * np.arange(n_evals)
    scale[:, 1] = 1.0 + 0.005 * np.arange(n_evals)
    params = [jnp.asarray(covparms0 * scale[k], dtype)
              for k in range(n_evals)]
    for p in params[:2]:
        float(fn(z, p, nug))
    # synchronous per-eval with value readback: the MLE inner loop consumes
    # each value
    lats = []
    for p in params:
        t0 = time.time()
        float(fn(z, p, nug))
        lats.append(time.time() - t0)
    per_eval = sorted(lats)[len(lats) // 2]
    print(f"[bench] n={n} sync ms: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in sorted(lats)[:8])}",
          file=sys.stderr)

    res = dict(per_eval=per_eval, compile_s=t4 - t3, spec_s=t1 - t0,
               plan_s=t2 - t1,
               ref_sec=modeled_reference_seconds(n, m, w_nnz))

    if with_grad:
        core, dev = loglik_core(spec, "matern", dtype)
        gfn = jax.jit(jax.value_and_grad(
            lambda d, z, c, g: core(d, z, c, g), argnums=2))
        t0 = time.time()
        v, g = gfn(dev, z, params[0], jnp.full((n,), 0.1, dtype))
        float(v)
        t1 = time.time()
        glats = []
        for p in params[:4]:
            t0 = time.time()
            v, g = gfn(dev, z, p, jnp.full((n,), 0.1, dtype))
            float(v), np.asarray(g)
            glats.append(time.time() - t0)
        res["grad_eval"] = sorted(glats)[len(glats) // 2]
        res["grad_compile_s"] = t1 - t0
        print(f"[bench] n={n} grad/eval {res['grad_eval']*1e3:.1f} ms",
              file=sys.stderr)
    return res


def _release_device_memory():
    """Drop compiled executables and their closed-over device buffers.

    The jit wrapper cache retains `dev` pytrees (GBs at n=1e6) long after
    the bench phase that built them returned; without this every extra
    phase stacks on the last one's HBM and the later configs OOM."""
    import gc
    import jax
    jax.clear_caches()
    gc.collect()


def bench_extras(dtype, only=None):
    """BASELINE configs 2-5: prediction+selinv, big grad, VL NR, MRA+NUTS.

    Each piece is guarded — a failure reports NaN rather than killing the
    headline metric.  Timings are value-readback synced.  With ``only``,
    runs that single config in-process (the child side of the subprocess
    dispatch below).
    """
    import jax
    import jax.numpy as jnp

    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import loglik_core
    from gpvecchia_tpu.utils.serialize import load_spec, save_spec

    out = {}
    rng = np.random.default_rng(1988)

    # Each config runs in a SUBPROCESS, one at a time, so that every config
    # starts with the card's memory free and only one process holds the
    # card; the persistent compile cache makes re-attachment cheap.
    # Running `python bench.py --extra cfgN` executes one config and prints
    # its JSON fragment; this parent collects them.
    def _run_extra(name, fn, fallback):
        if only is not None:
            if name == only:
                fn()
            return
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--extra",
                 name], capture_output=True, text=True, timeout=1500)
            sys.stderr.write(r.stderr[-2000:])
            line = [ln for ln in r.stdout.strip().splitlines()
                    if ln.startswith("{")][-1]
            out.update(json.loads(line))
        except Exception as e:
            print(f"[bench] extra {name} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            out.update(fallback)

    # ---- config 3: gradient of the north-star loglik (MLE inner loop) ----
    def _cfg3():
        spec = load_spec(_cache_path("spec_1000000_40_SGV.npz"))
        n = spec.n_obs
        core, dev = loglik_core(spec, "matern", dtype)
        gfn = jax.jit(jax.value_and_grad(
            lambda d, z, c, g: core(d, z, c, g), argnums=2))
        z = jnp.asarray(rng.normal(size=n), dtype)
        nug = jnp.full((n,), 0.1, dtype)
        t0 = time.time()
        v, g = gfn(dev, z, jnp.asarray([1.0, 0.2, 0.5], dtype), nug)
        float(v)
        out["big_grad_compile_s"] = round(time.time() - t0, 1)
        ts = []
        for k in range(3):
            t0 = time.time()
            v, g = gfn(dev, z, jnp.asarray([1.0 + 0.01 * k, 0.2, 0.5],
                                           dtype), nug)
            float(v), np.asarray(g)
            ts.append(time.time() - t0)
        out["big_grad_ms"] = round(sorted(ts)[1] * 1e3, 1)
    _run_extra("cfg3", _cfg3, {"big_grad_ms": float("nan")})

    # ---- config 2: prediction mean + SelInv variances at n=1e6 ----
    def _cfg2():
        from gpvecchia_tpu.inference.prediction import _pred_fns
        spec = load_spec(_cache_path("spec_1000000_40_SGV.npz"))
        n = spec.n_obs
        (mean_fn, var_fn), plan = _pred_fns(spec, "matern", dtype)
        z = np.asarray(rng.normal(size=n))
        nug = np.full(n, 0.1)
        cp = np.array([1.0, 0.2, 0.5])
        mu, fac = mean_fn(z, cp, nug)          # compile
        float(jnp.ravel(mu)[0])
        t0 = time.time()
        mu, fac = mean_fn(z, cp, nug)
        float(jnp.ravel(mu)[0])
        out["pred_mean_ms"] = round((time.time() - t0) * 1e3, 1)
        d = var_fn(fac)                        # compile
        float(jnp.ravel(d)[0])
        t0 = time.time()
        d = var_fn(fac)
        float(jnp.ravel(d)[0])
        out["pred_selinv_ms"] = round((time.time() - t0) * 1e3, 1)
    _run_extra("cfg2", _cfg2, {"pred_mean_ms": float("nan"),
                                "pred_selinv_ms": float("nan")})

    # ---- config 4: one VL Newton-Raphson solve, logistic, n=1e5 ----
    def _cfg4():
        from gpvecchia_tpu.inference.laplace import calculate_posterior_VL
        spec = load_spec(_cache_path("spec_100000_20_SGV.npz"))
        n = spec.n_obs
        zb = (rng.uniform(size=n) < 0.5).astype(np.float64)
        t0 = time.time()
        post = calculate_posterior_VL(zb, spec, "logistic",
                                      [1.0, 0.2, 0.5], max_iter=30)
        compile_and_run = time.time() - t0
        t0 = time.time()
        post = calculate_posterior_VL(zb, spec, "logistic",
                                      [1.0, 0.2, 0.5], max_iter=30)
        vl_s = time.time() - t0
        out["vl_nr_ms"] = round(vl_s * 1e3, 1)
        out["vl_iters"] = int(post["iter"])
        out["vl_iter_ms"] = round(vl_s * 1e3 / max(post["iter"], 1), 1)
    _run_extra("cfg4", _cfg4, {"vl_nr_ms": float("nan")})

    # ---- config 5: MRA conditioning at n=1e6 + one NUTS transition ----
    def _cfg5():
        cache = _cache_path("spec_1000000_40_MRA.npz")
        t0 = time.time()
        if os.path.exists(cache):
            spec_m = load_spec(cache)
        else:
            locs = np.random.default_rng(1988).uniform(size=(1_000_000, 2))
            spec_m = vecchia_specify(locs, m=40, conditioning="mra")
            save_spec(spec_m, cache)
        out["mra_spec_s"] = round(time.time() - t0, 1)
        n = spec_m.n_obs
        from gpvecchia_tpu.inference.likelihood import loglik_fn
        fn = loglik_fn(spec_m, "matern", dtype=dtype)
        z = np.asarray(rng.normal(size=n))
        float(fn(z, jnp.asarray([1.0, 0.2, 0.5], dtype), dtype(0.1)))
        ts = []
        for k in range(3):
            t0 = time.time()
            float(fn(z, jnp.asarray([1.0 + 0.01 * k, 0.2, 0.5], dtype),
                     dtype(0.1)))
            ts.append(time.time() - t0)
        out["mra_eval_ms"] = round(sorted(ts)[1] * 1e3, 1)

    _run_extra("cfg5", _cfg5, {"mra_eval_ms": float("nan")})

    # ---- config 5b: one NUTS transition at the MRA n=1e6 config ----
    # (own subprocess/frame: its compile is the longest of any phase)
    def _cfg5b():
        spec_m = load_spec(_cache_path("spec_1000000_40_MRA.npz"))
        n = spec_m.n_obs
        z = np.asarray(rng.normal(size=n))
        from gpvecchia_tpu.fit.mcmc import _nuts_transition
        core, dev = loglik_core(spec_m, "matern", dtype)
        zj = jnp.asarray(z, dtype)
        nugv = jnp.full((n,), 0.1, dtype)

        def logpost(lg):
            th = jnp.exp(lg)
            return core(dev, zj, jnp.stack([th[0], th[1], 0.5]), nugv)

        trans = jax.jit(lambda k, th: _nuts_transition(
            logpost, jax.grad(logpost), k, th, 0.05,
            jnp.ones(2, dtype), 2))
        key = jax.random.PRNGKey(0)
        th0 = jnp.zeros(2, dtype)
        th1, _ = trans(key, th0)
        float(th1[0])
        t0 = time.time()
        th1, _ = trans(jax.random.PRNGKey(1), th0)
        float(th1[0])
        out["nuts_transition_ms"] = round((time.time() - t0) * 1e3, 1)

    _run_extra("cfg5b", _cfg5b, {"nuts_transition_ms": float("nan")})
    return out


def _child_main(arg):
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"[bench] needs an NVIDIA GPU; JAX found "
                 f"'{jax.default_backend()}'")
    from gpvecchia_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    dtype = jnp.float32
    if arg == "--headline":
        d = jax.devices()[0]
        print(f"[bench] platform={d.platform} kind={d.device_kind} "
              f"count={len(jax.devices())}", file=sys.stderr)
        small = run_config(100_000, 20, "SGV", 10, dtype, with_grad=True)
        if os.environ.get("BENCH_SMALL_ONLY"):
            big = small
            n, m = 100_000, 20
        else:
            _release_device_memory()
            n, m = 1_000_000, 40
            big = run_config(n, m, "SGV",
                             int(os.environ.get("BENCH_EVALS", 6)), dtype)
        vs_big = big["ref_sec"] / big["per_eval"]
        vs_small = small["ref_sec"] / small["per_eval"]
        print(json.dumps({
            "metric": f"vecchia_loglik_evals_per_sec_n{n}_m{m}_SGV",
            "value": round(1.0 / big["per_eval"], 3),
            "unit": "evals/s",
            "vs_baseline": round(vs_big, 2),
            "small_n1e5_m20_ms": round(small["per_eval"] * 1e3, 2),
            "small_vs_baseline": round(vs_small, 2),
            "small_grad_ms": round(small.get("grad_eval",
                                             float("nan")) * 1e3, 2),
            "small_compile_s": round(small["compile_s"], 1),
            "big_compile_s": round(big["compile_s"], 1),
            "big_plan_s": round(big["plan_s"], 1),
        }))
    else:
        print(json.dumps(bench_extras(dtype, only=arg)))


def main():
    """Orchestrator: JAX-free parent; every phase runs in its own
    subprocess, one at a time, so each starts on a free card and only one
    process holds it.  The persistent compile cache keeps the per-phase
    re-attachment cost to seconds."""
    if len(sys.argv) > 2 and sys.argv[1] == "--extra":
        _child_main(sys.argv[2])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--headline":
        _child_main("--headline")
        return

    t_start = time.time()

    def run_child(arg, timeout):
        r = subprocess.run([sys.executable, os.path.abspath(__file__)] + arg,
                           capture_output=True, text=True, timeout=timeout)
        sys.stderr.write(r.stderr[-4000:])
        lines = [ln for ln in r.stdout.strip().splitlines()
                 if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else {}

    result = run_child(["--headline"], 2400)
    if not result:
        sys.exit("[bench] headline child produced no result")

    if not os.environ.get("BENCH_SMALL_ONLY") and \
            not os.environ.get("BENCH_NO_EXTRAS"):
        for name, fallback in [
                ("cfg3", {"big_grad_ms": float("nan")}),
                ("cfg2", {"pred_mean_ms": float("nan"),
                          "pred_selinv_ms": float("nan")}),
                ("cfg4", {"vl_nr_ms": float("nan")}),
                ("cfg5", {"mra_eval_ms": float("nan")}),
                ("cfg5b", {"nuts_transition_ms": float("nan")})]:
            try:
                got = run_child(["--extra", name], 1500)
                result.update(got or fallback)
                if not got:
                    print(f"[bench] extra {name} produced no result",
                          file=sys.stderr)
            except Exception as e:
                print(f"[bench] extra {name} failed: {type(e).__name__}",
                      file=sys.stderr)
                result.update(fallback)

    print(f"[bench] total {time.time() - t_start:.0f}s", file=sys.stderr)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
