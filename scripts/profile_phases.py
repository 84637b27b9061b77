"""Per-phase timing of the Vecchia loglikelihood on the current backend, and
device time per named scope from a profiler trace.

Env knobs: N (default 100000), M (20), COND (SGV), REPS (5), DTYPE (f32),
TRACE (directory: trace REPS evals of the full loglik and print the device
time of each named scope: `u_entries` and every multifrontal level
`mf_level_<d>`, leaves at the largest d).
Phases: u_entries, mf_factor (factor+forward of W), full loglik, grad.
Run from the repository root: `python scripts/profile_phases.py`.
"""

import collections
import glob
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

_SCOPE = re.compile(r"(u_entries|mf_level_\d+)")


def hlo_op_scopes(hlo_text):
    """{HLO instruction name: named scope} from a compiled module's text."""
    out = {}
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"",
                     line)
        if m:
            s = _SCOPE.findall(m.group(2))
            out[m.group(1)] = s[-1] if s else "other"
    return out


def device_time_by_scope(trace_dir, scopes):
    """Sum device event durations (ns) per named scope over every GPU plane
    of the newest trace in `trace_dir`.  Events whose HLO op is not in
    `scopes` (other programs) are counted under '(unmapped)'."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    totals = collections.Counter()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                totals[scopes.get(op, "(unmapped)")] += ev.duration_ns
    return dict(totals)


def _sync(out):
    return jax.block_until_ready(out)


def timed(name, fn, *args, reps=5):
    t0 = time.perf_counter()
    out = _sync(fn(*args))
    t1 = time.perf_counter()
    per = []
    for _ in range(reps):
        t = time.perf_counter()
        _sync(fn(*args))
        per.append(time.perf_counter() - t)
    per_run = sorted(per)[len(per) // 2]
    print(f"{name:16s} compile+1st {t1 - t0:7.1f}s   per-run "
          f"{per_run * 1e3:8.2f} ms", flush=True)
    return out


def main():
    N = int(os.environ.get("N", 100_000))
    M = int(os.environ.get("M", 20))
    COND = os.environ.get("COND", "SGV")
    REPS = int(os.environ.get("REPS", 5))
    dt = jnp.float64 if os.environ.get("DTYPE") == "f64" else jnp.float32
    TRACE = os.environ.get("TRACE")

    from gpvecchia_tpu import vecchia_specify
    from gpvecchia_tpu.inference.likelihood import (
        _device_arrays, _mf_denominator, loglik_core)
    from gpvecchia_tpu.kernels.covariance import make_kernel_fn
    from gpvecchia_tpu.kernels.u_entries import u_entries
    from gpvecchia_tpu.linalg.sparse import gather
    from gpvecchia_tpu.plan import get_mf_plan, get_plan
    from gpvecchia_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(1988)
    locs = rng.uniform(size=(N, 2))
    t0 = time.time()
    spec = vecchia_specify(locs, m=M, cond_yz=COND)
    t1 = time.time()
    plan = get_plan(spec, dt)
    dev = _device_arrays(plan)
    t2 = time.time()
    print(f"backend={jax.default_backend()} n={N} m={M} cond={COND} "
          f"mode={plan.mode} use_mf={plan.use_mf}")
    print(f"spec {t1 - t0:.1f}s  plan+dev {t2 - t1:.1f}s")
    if plan.use_mf:
        mf, _ = get_mf_plan(plan)
        sizes = [(1 << d, lv.npiv, lv.nbord)
                 for d, lv in enumerate(mf.levels)]
        print("mf levels (N, P, B):", sizes)

    kernel_fn = make_kernel_fn("matern")
    z = jnp.asarray(rng.normal(size=spec.n_obs), dt)
    covparms = jnp.asarray([1.0, 0.2, 0.5], dt)
    nuggets = jnp.full((spec.n_obs,), 0.1, dt)

    @jax.jit
    def f_u(dev, covparms, nuggets):
        nug_ord = gather(nuggets, dev["ord_z"])
        nug_point = jnp.zeros(plan.n_all, dt).at[dev["obs_points"]].set(
            nug_ord)
        return u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, kernel_fn, covparms,
                         pdist=dev.get("pdist"), nbr_pts=dev.get("nbr_pts"),
                         row_chunks=plan.compiled.get("u_row_chunks", 1))[0]

    col = timed("u_entries", f_u, dev, covparms, nuggets, reps=REPS)

    if plan.use_mf:
        @jax.jit
        def f_mf(dev, col, z, nuggets):
            nug_ord = gather(nuggets, dev["ord_z"])
            zord = gather(z, dev["ord_z"])
            znb = zord[dev["nb_obs_pos"]]
            z1L = jnp.sum(jnp.where(dev["nb_resp"], col * znb, 0.0), axis=1)
            fac = _mf_denominator(plan, dev, col, z1L, zord, nug_ord, dt)
            return fac["logdet"], fac["quad"]

        timed("mf_factor+fwd", f_mf, dev, col, z, nuggets, reps=REPS)

    core, dev2 = loglik_core(spec, "matern", dt)
    f_ll = jax.jit(core)
    timed("full loglik", f_ll, dev2, z, covparms, nuggets, reps=REPS)

    f_grad = jax.jit(jax.grad(core, argnums=2))
    timed("grad loglik", f_grad, dev2, z, covparms, nuggets, reps=REPS)

    if TRACE:
        args = (dev2, z, covparms, nuggets)
        scopes = hlo_op_scopes(f_ll.lower(*args).compile().as_text())
        jax.profiler.start_trace(TRACE)
        for _ in range(REPS):
            _sync(f_ll(*args))
        jax.profiler.stop_trace()
        by_scope = device_time_by_scope(TRACE, scopes)
        total = sum(by_scope.values())
        print(f"device time per eval by scope ({REPS} evals traced):")
        for k in sorted(by_scope, key=lambda k: -by_scope[k]):
            print(f"  {k:14s} {by_scope[k] / REPS / 1e6:9.3f} ms "
                  f"({100 * by_scope[k] / max(total, 1):5.1f}%)")


if __name__ == "__main__":
    main()
