"""Benchmark: batched KKT factorize+solve throughput on the GPU vs CPU.

The metric (BASELINE.md): KKT factorize+solve throughput on the device vs
LAPACK on the CPU.  Each IPM iteration's dominant cost is one Cholesky
factorization of the condensed KKT matrix plus two triangular solves
(reference misc.py:1352 kkt_chol2 / lapack.potrf); the batched design
factors many such matrices at once with vmap (scenario batching), through
XLA's Cholesky and triangular solves.

Method: the whole repetition loop runs on device as one executable
(lax.scan with a data dependency between iterations so nothing can be
elided); one scalar is fetched, and two loop lengths are differenced to
cancel the fixed dispatch cost.  Each scan iteration perturbs the matrix
so iterations are distinct work.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = batched KKT factorize+solve throughput (factorizations/s/chip)
vs_baseline = value / scipy-LAPACK-on-CPU throughput on identical problems.
"""

import functools
import json
import os
import time

import numpy as np

B, N = 16, 1024  # batch of condensed-KKT-sized SPD systems


def _factor_solve(K):
    """XLA's batched Cholesky factor and a solve(L, rhs) for it."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_solve
    L = jnp.linalg.cholesky(K)
    return L, jax.vmap(lambda Li, bi: cho_solve((Li, True), bi))


def device_seconds_per_batch():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(int.from_bytes(os.urandom(8), "little"))
    A = rng.standard_normal((B, N, N)).astype(np.float32)
    Ks = 0.5 * (A + A.transpose(0, 2, 1)) + (2.0 * N) * np.eye(
        N, dtype=np.float32)[None]
    bs = rng.standard_normal((B, N)).astype(np.float32)
    Kd, bd = jnp.asarray(Ks), jnp.asarray(bs)
    eye = jnp.eye(N, dtype=jnp.float32)

    @functools.partial(jax.jit, static_argnames=("m",))
    def many(K, b, m):
        def body(carry, _):
            s, x = carry
            Kp = K + (s * 1e-9)[None, None, None] * eye
            f, solve = _factor_solve(Kp)
            x2 = solve(f, solve(f, x))
            return (jnp.sum(x2) * 1e-9, x2), None
        (s, x), _ = jax.lax.scan(body, (jnp.float32(0.0), b), None,
                                 length=m)
        return s, x

    # correctness spot check on the m=1 result
    s, x = many(Kd, bd, 1)
    xh = np.asarray(x[0], dtype=np.float64)
    r = Ks[0].astype(np.float64) @ (Ks[0].astype(np.float64) @ xh) - bs[0]
    assert np.linalg.norm(r) / np.linalg.norm(bs[0]) < 1e-2, "bad solve"

    def run(m):
        t0 = time.perf_counter()
        float(many(Kd, bd, m)[0])
        return time.perf_counter() - t0

    m_lo, m_hi = 2, 18
    run(m_lo); run(m_hi)  # compile both lengths
    per = []
    for _ in range(3):
        per.append((run(m_hi) - run(m_lo)) / (m_hi - m_lo))
    return sorted(per)[1]  # median of 3 slope estimates


def kernel_scaling():
    """Factor-only TFLOP/s of XLA's batched Cholesky at growing n: the
    serial pivot chain's share shrinks as n grows, so these rows show the
    compute-bound regime."""
    import jax
    import jax.numpy as jnp

    rows = {}
    for Bk, Nk in ((16, 1024), (8, 2048), (2, 4096)):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((Bk, Nk, Nk)).astype(np.float32)
        Ks = 0.5 * (A + A.transpose(0, 2, 1)) + (2.0 * Nk) * np.eye(
            Nk, dtype=np.float32)[None]
        Kd = jnp.asarray(Ks)
        eye = jnp.eye(Nk, dtype=jnp.float32)

        @functools.partial(jax.jit, static_argnames=("m",))
        def fac_only(K, m):
            def body(s, _):
                Kp = K + (s * 1e-9)[None, None, None] * eye
                L = jnp.linalg.cholesky(Kp)
                return jnp.sum(L) * 1e-9, None
            s, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=m)
            return s

        def run(m):
            t0 = time.perf_counter()
            float(fac_only(Kd, m))
            return time.perf_counter() - t0

        run(2); run(10)
        per = sorted((run(10) - run(2)) / 8 for _ in range(3))
        t = per[1]
        rows[f"B{Bk}_n{Nk}"] = round(Bk * Nk ** 3 / 3 / t / 1e12, 2)
    return rows


def cpu_seconds_per_batch():
    import scipy.linalg as sla
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, N, N))
    K64 = 0.5 * (A + A.transpose(0, 2, 1)) + (2.0 * N) * np.eye(N)
    b64 = rng.standard_normal((B, N))
    c = sla.cho_factor(K64[0], lower=True)
    sla.cho_solve(c, b64[0])
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        for i in range(B):
            c = sla.cho_factor(K64[i], lower=True)
            x1 = sla.cho_solve(c, b64[i])
            sla.cho_solve(c, x1)
    return (time.perf_counter() - t0) / reps


IPM_B, IPM_N, IPM_M = 64, 16, 32  # batched coneqp workload (f64 state)


def _ipm_problem(seed=0):
    rng = np.random.default_rng(seed)
    Ps = np.zeros((IPM_B, IPM_N, IPM_N)); qs = np.zeros((IPM_B, IPM_N))
    Gs = np.zeros((IPM_B, IPM_M, IPM_N)); hs = np.zeros((IPM_B, IPM_M))
    for i in range(IPM_B):
        M = rng.standard_normal((IPM_N, IPM_N))
        Ps[i] = M @ M.T + IPM_N * np.eye(IPM_N)
        qs[i] = rng.standard_normal(IPM_N)
        Gs[i] = rng.standard_normal((IPM_M, IPM_N))
        hs[i] = Gs[i] @ rng.standard_normal(IPM_N) + rng.uniform(
            0.5, 1.5, IPM_M)
    return Ps, qs, Gs, hs


def ipm_metrics():
    """IPM metrics: complete batched coneqp
    solves/s at reference tolerances (abstol 1e-7), IPM iterations/s, and
    ms per IPM iteration (one KKT factorize + 2 predictor/corrector
    solves with refinement)."""
    import jax
    import jax.numpy as jnp
    from kvxopt_tpu.cones import ConeDims
    from kvxopt_tpu.parallel import batched_qp_solver

    vsolve = batched_qp_solver(ConeDims(l=IPM_M))
    # host-resident numpy inputs: the jitted driver places them on the
    # default device
    Ps, qs, Gs, hs = _ipm_problem(int.from_bytes(os.urandom(4), "little"))
    args = tuple(np.asarray(a, np.float64) for a in (Ps, qs, Gs, hs))
    out = vsolve(*args)          # compile
    out[0].block_until_ready()
    n_opt = int((np.asarray(out[5]) == 1).sum())
    iters = np.asarray(out[4]) - 1
    ts = []
    for rep in range(5):
        Ps2, qs2, Gs2, hs2 = _ipm_problem(rep + 1)
        a2 = tuple(np.asarray(a, np.float64)
                   for a in (Ps2, qs2, Gs2, hs2))
        t0 = time.perf_counter()
        o2 = vsolve(*a2)
        o2[0].block_until_ready()
        ts.append(time.perf_counter() - t0)
        iters = np.asarray(o2[4]) - 1
    t = sorted(ts)[len(ts) // 2]
    mean_iters = float(iters.mean())
    return {
        "workload": f"coneqp batch B={IPM_B} n={IPM_N} m={IPM_M} f64, "
                    "abstol 1e-7",
        "solves_per_s": round(IPM_B / t, 1),
        "ipm_iters_per_s": round(IPM_B * mean_iters / t, 1),
        "ms_per_ipm_iter_per_problem": round(
            1e3 * t / (IPM_B * mean_iters), 4),
        "mean_iterations": round(mean_iters, 2),
        "optimal_fraction": round(n_opt / IPM_B, 3),
    }


def cpu_ipm_baseline():
    """The same batched-coneqp program on the host CPU backend (the
    reference's execution model is CPU LAPACK; this is the matched-accuracy
    CPU stand-in, run in a subprocess that never opens the GPU)."""
    import subprocess
    import sys
    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import json,time\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "jax.config.update('jax_enable_x64',True)\n"
        "import jax.numpy as jnp\n"
        "import bench\n"
        "from kvxopt_tpu.cones import ConeDims\n"
        "from kvxopt_tpu.parallel import batched_qp_solver\n"
        "vs = batched_qp_solver(ConeDims(l=bench.IPM_M))\n"
        "P,q,G,h = bench._ipm_problem(0)\n"
        "a = tuple(jnp.asarray(x) for x in (P,q,G,h))\n"
        "o = vs(*a); o[0].block_until_ready()\n"
        "ts=[]\n"
        "for r in range(3):\n"
        "    P,q,G,h = bench._ipm_problem(r+1)\n"
        "    a = tuple(jnp.asarray(x) for x in (P,q,G,h))\n"
        "    t0=time.perf_counter(); o=vs(*a); o[0].block_until_ready()\n"
        "    ts.append(time.perf_counter()-t0)\n"
        "print(json.dumps({'t': sorted(ts)[1]}))\n"
    )
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
        line = out.stdout.strip().splitlines()[-1]
        return json.loads(line)["t"]
    except Exception:
        return None


LARGE_N, LARGE_M = 512, 1024  # single-instance IPM at reference tolerances


def _large_problem(seed, n=LARGE_N, m=LARGE_M):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h


def ipm_large_device():
    """Single full coneqp at n=512, m=1024, reference tolerances
    (abstol/feastol 1e-7), through the adaptive mixed-precision KKT
    (f32 factorizations + f64 refinement + automatic f64 fallback)."""
    import jax
    import jax.numpy as jnp
    from kvxopt_tpu.cones import ConeDims
    from kvxopt_tpu.parallel.batch import make_qp_solver
    from kvxopt_tpu.solvers.coneprog import Options

    dims = ConeDims(l=LARGE_M)
    o = Options(refinement=1).resolve_refinement(dims)
    vs = jax.jit(make_qp_solver(dims, "chol2_mixed", o))
    args = tuple(jnp.asarray(a, jnp.float64) for a in _large_problem(0))
    out = vs(*args)
    out[0].block_until_ready()
    reps = 5   # median of 5 warm solves
    ts, opt = [], 0
    for r in range(reps):
        a = tuple(jnp.asarray(x, jnp.float64)
                  for x in _large_problem(r + 1))
        t0 = time.perf_counter()
        out = vs(*a)
        out[0].block_until_ready()
        ts.append(time.perf_counter() - t0)
        opt += int(out[5]) == 1
    return sorted(ts)[reps // 2], opt / reps


def ipm_large_cpu():
    """The same problem with the all-f64 path on the host CPU backend."""
    import subprocess
    import sys
    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import json,time\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "jax.config.update('jax_enable_x64',True)\n"
        "import jax.numpy as jnp\n"
        "import bench\n"
        "from kvxopt_tpu.cones import ConeDims\n"
        "from kvxopt_tpu.parallel.batch import make_qp_solver\n"
        "from kvxopt_tpu.solvers.coneprog import Options\n"
        "dims = ConeDims(l=bench.LARGE_M)\n"
        "o = Options(refinement=1).resolve_refinement(dims)\n"
        "vs = jax.jit(make_qp_solver(dims, 'chol2', o))\n"
        "a = tuple(jnp.asarray(x) for x in bench._large_problem(0))\n"
        "out = vs(*a); out[0].block_until_ready()\n"
        "ts=[]\n"
        "for r in range(3):\n"
        "    a = tuple(jnp.asarray(x) for x in bench._large_problem(r+1))\n"
        "    t0=time.perf_counter(); out=vs(*a); out[0].block_until_ready()\n"
        "    ts.append(time.perf_counter()-t0)\n"
        "print(json.dumps({'t': sorted(ts)[1]}))\n"
    )
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
        line = out.stdout.strip().splitlines()[-1]
        return json.loads(line)["t"]
    except Exception:
        return None


def main():
    dev_time = device_seconds_per_batch()
    cpu_time = cpu_seconds_per_batch()
    dev_thr = B / dev_time
    cpu_thr = B / cpu_time
    ipm = ipm_metrics()
    cpu_t = cpu_ipm_baseline()
    if cpu_t:
        ipm["cpu_solves_per_s"] = round(IPM_B / cpu_t, 1)
        ipm["vs_cpu"] = round(ipm["solves_per_s"] / (IPM_B / cpu_t), 2)
        ipm["note"] = ("tiny problems are host-latency-bound; see "
                       "ipm_large for the compute-bound comparison")
    tl, opt_frac = ipm_large_device()
    large = {
        "workload": f"single coneqp n={LARGE_N} m={LARGE_M} f64 state, "
                    "abstol/feastol 1e-7, kktsolver=chol2_mixed",
        "device_ms_per_solve": round(tl * 1e3, 1),
        "optimal_fraction": round(opt_frac, 3),
    }
    cl = ipm_large_cpu()
    if cl:
        large["cpu_f64_ms_per_solve"] = round(cl * 1e3, 1)
        large["vs_cpu"] = round(cl / tl, 2)
    configs = {}
    if os.environ.get("KVX_BENCH_CONFIGS", "1") != "0":
        import bench_configs
        configs = bench_configs.run_all()
    # last: the big-n scaling rows allocate multi-GB HBM working sets
    # and measurably perturb whatever runs after them
    try:
        scaling = kernel_scaling()
    except Exception:
        scaling = {}
    full = {
        "metric": f"batched KKT factorize+solve throughput (n={N}, B={B})",
        "value": round(dev_thr, 2),
        "unit": "factorizations/s",
        "vs_baseline": round(dev_thr / cpu_thr, 2),
        "kernel_tflops_scaling": scaling,
        "ipm": ipm,
        "ipm_large": large,
        "configs": configs,
    }
    # Verbose detail goes to build/bench_full.json + an early stdout
    # line; the LAST line is a compact machine-readable summary.
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bench_full.json"), "w") as f:
        json.dump(full, f, indent=1)
    print(json.dumps(full))
    compact = {
        "metric": f"batched KKT factor+solve/s (n={N} B={B})",
        "value": round(dev_thr, 2),
        "unit": "factorizations/s",
        "vs_baseline": round(dev_thr / cpu_thr, 2),
        "kernel_tflops": scaling,
        "ipm_vs_cpu": ipm.get("vs_cpu"),
        "ipm_large_vs_cpu": large.get("vs_cpu"),
        "configs_vs_reference": {
            k: v.get("vs_reference", v.get("vs_cpu_sparse"))
            for k, v in configs.items()},
    }
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
