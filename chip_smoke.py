"""Smoke test of kvxopt_tpu on one NVIDIA GPU (or four with --four).

    python chip_smoke.py [--four] [--seed N]

Drives the public entry points once each on the GPU, at realistic sizes
with seeded random data, and compares every result with an independent
reference: the same call on the host CPU device (in this process), scipy
or numpy.  Each phase prints one line with the card's name and power
limit, its first-call (compile + run) and warm seconds, and the errors
beside their tolerances.  Any failure raises: the script exits non-zero
and prints no result.  Without a GPU it fails; it never falls back to the
CPU.  The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases on one card: 1 device check, 2 dense QP, 3 LP with equalities,
4 SOCP and max-cut SDP, 5 mixed-precision KKT and the batched drivers,
6 XLA batched Cholesky timings, 7 sparse Cholesky on the device tile
path.  --four runs only the multi-card path: the batch-sharded driver,
the sharded KKT solver inside coneqp, the distributed Cholesky and the
arrow KKT factorization, each compared with one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the CPU references need the host platform next to the GPU one
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np  # noqa: E402

TOL = {"abstol": 1e-7, "reltol": 1e-6, "feastol": 1e-7}


class Ctx:
    """What every phase needs: the device under test, the host CPU device
    for references, the card description and the seed."""

    def __init__(self, dev, cpu, card, seed):
        self.dev, self.cpu, self.card, self.seed = dev, cpu, card, seed

    def rng(self, phase):
        return np.random.default_rng([self.seed, phase])

    def report(self, name, first_s, warm_s, **checks):
        items = " ".join(f"{k}={v}" for k, v in checks.items())
        print(f"phase {name}: card={self.card} "
              f"compile_s={max(first_s - warm_s, 0.0):.3f} "
              f"first_s={first_s:.3f} warm_s={warm_s:.3f} {items}",
              flush=True)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn):
    """(result, first-call seconds, warm seconds): the first call
    includes tracing and compilation."""
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


class _RanOn:
    """Context that checks a solve allocated on `dev`: solver result
    dicts hold host copies, so placement is read from the device
    allocator.  On the CPU (no allocator statistics) it checks that
    no default-device override is in effect."""

    def __init__(self, dev):
        self.dev = dev

    def _allocs(self):
        stats = self.dev.memory_stats()
        return None if stats is None else stats["num_allocs"]

    def __enter__(self):
        import jax
        if jax.config.jax_default_device not in (None, self.dev):
            raise AssertionError("a default-device override is active")
        self.before = self._allocs()
        return self

    def __exit__(self, *exc):
        after = self._allocs()
        if exc[0] is None and after is not None and after <= self.before:
            raise AssertionError(f"nothing was allocated on {self.dev}")
        return False


def _on(dev, *arrays):
    for a in arrays:
        if a.devices() != {dev}:
            raise AssertionError(f"result on {a.devices()}, not {dev}")


def _check(name, value, tol):
    if not (value <= tol):
        raise AssertionError(f"{name}={value:.3e} exceeds {tol:.0e}")
    return f"{value:.3e}(tol {tol:.0e})"


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _on_cpu(ctx, fn):
    import jax
    with jax.default_device(ctx.cpu):
        return fn()


def _qp_data(rng, n, m):
    """Strongly convex dense QP with a strictly feasible point."""
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h


def _qp_batch(rng, B, n, m):
    data = [_qp_data(rng, n, m) for _ in range(B)]
    return tuple(np.stack(a) for a in zip(*data))


def phase_device(ctx):
    import jax
    from kvxopt_tpu import config
    if jax.default_backend() != ctx.dev.platform:
        raise AssertionError(f"default backend {jax.default_backend()}")
    ctx.report("1 device", 0.0, 0.0, kind=repr(ctx.dev.device_kind),
               x64=jax.config.jax_enable_x64,
               matmul_precision=jax.config.jax_default_matmul_precision,
               cache_dir=config.cache_dir())


def phase_qp(ctx, n=1024, m=2048):
    from kvxopt_tpu import solvers
    P, q, G, h = _qp_data(ctx.rng(2), n, m)
    with _RanOn(ctx.dev):
        sol, first, warm = _timed(lambda: solvers.qp(P, q, G, h))
    ref = _on_cpu(ctx, lambda: solvers.qp(P, q, G, h))
    if sol["status"] != "optimal" or ref["status"] != "optimal":
        raise AssertionError((sol["status"], ref["status"]))
    x, s, z = (np.asarray(sol[k]).ravel() for k in "xsz")
    pres = np.linalg.norm(G @ x + s - h) / max(1.0, np.linalg.norm(h))
    dres = np.linalg.norm(P @ x + q + G.T @ z) / max(1.0, np.linalg.norm(q))
    if min(s.min(), z.min()) < 0:
        raise AssertionError("s or z left the cone")
    ctx.report(f"2 qp n={n} m={m} chol2 f64", first, warm,
               iters=sol["iterations"],
               rel_dx_vs_cpu=_check("rel_dx", _rel(x, ref["x"]), 1e-6),
               pres=_check("pres", pres, 1e-7),
               dres=_check("dres", dres, 1e-7), gap=f"{sol['gap']:.2e}")


def _lp_data(rng, n, m, p):
    """Bounded LP: strictly feasible primal and dual points exist."""
    G = rng.standard_normal((m, n))
    A = rng.standard_normal((p, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.5, 1.5, m)
    b = A @ x0
    c = -(G.T @ rng.uniform(0.5, 1.5, m) + A.T @ rng.standard_normal(p))
    return c, G, h, A, b


def phase_lp(ctx, n=512, m=1024, p=64):
    from scipy.optimize import linprog
    from kvxopt_tpu import solvers
    c, G, h, A, b = _lp_data(ctx.rng(3), n, m, p)
    with _RanOn(ctx.dev):
        sol, first, warm = _timed(lambda: solvers.lp(c, G, h, A, b))
    if sol["status"] != "optimal":
        raise AssertionError(sol["status"])
    ref = linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b, bounds=(None, None),
                  method="highs")
    if ref.status != 0:
        raise AssertionError(ref.message)
    obj = float(sol["primal objective"])
    ctx.report(f"3 lp n={n} m={m} p={p}", first, warm,
               iters=sol["iterations"],
               rel_obj_vs_highs=_check(
                   "rel_obj", abs(obj - ref.fun) / abs(ref.fun), 1e-6))


def _socp_data(rng, n, nq, qm):
    G = rng.standard_normal((nq * qm, n))
    s0 = np.zeros(nq * qm)
    z0 = np.zeros(nq * qm)
    for k in range(nq):
        for v in (s0, z0):
            u = rng.standard_normal(qm - 1) * 0.3
            v[k * qm] = np.linalg.norm(u) + rng.uniform(0.5, 1.5)
            v[k * qm + 1:(k + 1) * qm] = u
    h = G @ rng.standard_normal(n) + s0
    c = -G.T @ z0
    Gq = [G[k * qm:(k + 1) * qm] for k in range(nq)]
    hq = [h[k * qm:(k + 1) * qm] for k in range(nq)]
    return c, Gq, hq


def _maxcut_data(rng, nodes):
    """Dual max-cut SDP: minimize sum(x) s.t. diag(x) - L/4 >= 0, written
    as sum_k x_k G_k <= h with G_k = -e_k e_k' and h = -L/4."""
    W = np.triu((rng.uniform(size=(nodes, nodes)) < 0.5).astype(float), 1)
    W = W + W.T
    L = np.diag(W.sum(1)) - W
    G = np.zeros((nodes * nodes, nodes))
    G[np.arange(nodes) * (nodes + 1), np.arange(nodes)] = -1.0
    return np.ones(nodes), G, -L / 4.0


def phase_cones(ctx, n=256, nq=32, qm=16, nodes=64):
    from kvxopt_tpu import solvers
    c, Gq, hq = _socp_data(ctx.rng(4), n, nq, qm)
    with _RanOn(ctx.dev):
        sol, first, warm = _timed(lambda: solvers.socp(c, Gq=Gq, hq=hq))
    ref = _on_cpu(ctx, lambda: solvers.socp(c, Gq=Gq, hq=hq))
    if sol["status"] != "optimal" or ref["status"] != "optimal":
        raise AssertionError((sol["status"], ref["status"]))
    ctx.report(f"4a socp n={n} q=[{qm}]*{nq}", first, warm,
               iters=sol["iterations"],
               rel_dx_vs_cpu=_check("rel_dx", _rel(sol["x"], ref["x"]),
                                    1e-6))

    c, G, h = _maxcut_data(ctx.rng(5), nodes)
    with _RanOn(ctx.dev):
        sol, first, warm = _timed(
            lambda: solvers.sdp(c, Gs=[G], hs=[h]))
    ref = _on_cpu(ctx, lambda: solvers.sdp(c, Gs=[G], hs=[h]))
    if sol["status"] != "optimal" or ref["status"] != "optimal":
        raise AssertionError((sol["status"], ref["status"]))
    ctx.report(f"4b sdp max-cut nodes={nodes}", first, warm,
               iters=sol["iterations"],
               rel_dx_vs_cpu=_check("rel_dx", _rel(sol["x"], ref["x"]),
                                    1e-6))


def _lanes_vs_cpu(ctx, out, data, lanes=4):
    """Re-solve `lanes` lanes with solvers.qp on the CPU; worst rel dx."""
    from kvxopt_tpu import solvers
    P, q, G, h = data
    worst = 0.0
    for i in range(lanes):
        ref = _on_cpu(ctx, lambda: solvers.qp(P[i], q[i], G[i], h[i],
                                              options=TOL))
        if ref["status"] != "optimal":
            raise AssertionError(ref["status"])
        worst = max(worst, _rel(np.asarray(out[0])[i], ref["x"]))
    return worst


def _optimal_fraction(out):
    return float((np.asarray(out[5]) == 1).mean())


def phase_batched(ctx, n=512, m=1024, Bv=64, nv=256, mv=512, Bm=16, Bs=8):
    import jax
    import jax.numpy as jnp
    from kvxopt_tpu import solvers
    from kvxopt_tpu.cones import ConeDims
    from kvxopt_tpu.parallel import (batched_qp_solver,
                                     batched_qp_solver_mixed,
                                     batched_qp_solver_seq)
    from kvxopt_tpu.solvers.coneprog import Options

    P, q, G, h = _qp_data(ctx.rng(6), n, m)
    with _RanOn(ctx.dev):
        sol, first, warm = _timed(lambda: solvers.coneqp(
            P, q, G, h, kktsolver="chol2_mixed"))
        ref = solvers.coneqp(P, q, G, h, kktsolver="chol2")
    if sol["status"] != "optimal" or ref["status"] != "optimal":
        raise AssertionError((sol["status"], ref["status"]))
    ctx.report(f"5a coneqp chol2_mixed n={n} m={m}", first, warm,
               iters=sol["iterations"],
               rel_dx_vs_chol2=_check("rel_dx", _rel(sol["x"], ref["x"]),
                                      1e-6))

    opts = Options(**TOL)
    for seed, label, make, (B, nn, mm) in (
            (11, "5b batched_qp_solver", lambda d: batched_qp_solver(
                d, options=opts), (Bv, nv, mv)),
            (12, "5c batched_qp_solver_mixed",
             lambda d: batched_qp_solver_mixed(d, options=opts), (Bm, n, m)),
            (13, "5d batched_qp_solver_seq", lambda d: batched_qp_solver_seq(
                d, options=opts), (Bs, n, m))):
        data = _qp_batch(ctx.rng(seed), B, nn, mm)
        args = [jax.device_put(jnp.asarray(a), ctx.dev) for a in data]
        solve = make(ConeDims(l=mm))
        with _RanOn(ctx.dev):
            out, first, warm = _timed(
                lambda: jax.block_until_ready(solve(*args)))
        if isinstance(out[0], jax.Array):
            _on(ctx.dev, *out[:4])
        frac = _optimal_fraction(out)
        if frac != 1.0:
            raise AssertionError(f"{label}: optimal fraction {frac}")
        ctx.report(f"{label} B={B} n={nn} m={mm} f64", first, warm,
                   optimal_fraction=frac,
                   mean_iters=float(np.asarray(out[4]).mean() - 1),
                   rel_dx_4_lanes_vs_cpu=_check(
                       "rel_dx", _lanes_vs_cpu(ctx, out, data), 1e-6))


CHOL_SHAPES = ((16, 1024), (8, 2048), (2, 4096))


def phase_cholesky(ctx, shapes=CHOL_SHAPES, reps=5):
    """XLA's batched Cholesky on the card: factor alone and factor + two
    solves, TFLOP/s counted as B n^3/3 per factor (+ 4 n^2 per pair of
    solves), residuals of lane 0 checked in numpy float64."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_solve

    factor = jax.jit(jnp.linalg.cholesky)

    @jax.jit
    def factor_solve2(K, b):
        L = jnp.linalg.cholesky(K)
        solve = jax.vmap(lambda Li, bi: cho_solve((Li, True), bi))
        return solve(L, solve(L, b))

    for dtype, tol in ((jnp.float32, 1e-4), (jnp.float64, 1e-10)):
        for B, n in shapes:
            key = jax.random.key(ctx.seed)
            A = jax.device_put(
                jax.random.normal(key, (B, n, n), dtype), ctx.dev)
            K = (jnp.einsum("bij,bkj->bik", A, A) / n
                 + jnp.eye(n, dtype=dtype))
            b = jnp.ones((B, n), dtype)
            rows = {}
            for name, fn, args, flops in (
                    ("factor", factor, (K,), B * n ** 3 / 3),
                    ("factor_2solves", factor_solve2, (K, b),
                     B * (n ** 3 / 3 + 4 * n ** 2))):
                out, first, _ = _timed(
                    lambda: jax.block_until_ready(fn(*args)))
                _on(ctx.dev, out)
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(*args))
                    ts.append(time.perf_counter() - t0)
                t = sorted(ts)[reps // 2]
                rows[name] = (out, first, t, flops / t / 1e12)
            K0 = np.asarray(K[0], np.float64)
            L0 = np.asarray(rows["factor"][0][0], np.float64)
            x0 = np.asarray(rows["factor_2solves"][0][0], np.float64)
            fres = (np.linalg.norm(L0 @ L0.T - K0) / np.linalg.norm(K0))
            b0 = np.ones(n)
            sres = (np.linalg.norm(K0 @ (K0 @ x0) - b0)
                    / np.linalg.norm(b0))
            _, ffirst, ft, ftf = rows["factor"]
            _, sfirst, st, stf = rows["factor_2solves"]
            ctx.report(
                f"6 cholesky {jnp.dtype(dtype).name} B={B} n={n}",
                ffirst + sfirst, ft + st,
                factor_ms=f"{ft * 1e3:.3f}", factor_tflops=f"{ftf:.2f}",
                factor_2solves_ms=f"{st * 1e3:.3f}",
                factor_2solves_tflops=f"{stf:.2f}",
                factor_res=_check("factor_res", fres, tol),
                solve_res=_check("solve_res", sres, tol))


def phase_cholmod(ctx, grid=64, shift=0.1, device="auto"):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from kvxopt_tpu import cholmod, matrix, spmatrix
    T = sp.diags([-np.ones(grid - 1), 2 * np.ones(grid),
                  -np.ones(grid - 1)], [-1, 0, 1])
    I = sp.eye(grid)
    A = (sp.kron(T, I) + sp.kron(I, T) + shift * sp.eye(grid * grid)).tocsc()
    n = A.shape[0]
    As = spmatrix._from_csc(sp.csc_matrix(sp.tril(A)))
    b = ctx.rng(7).standard_normal(n)
    old = dict(cholmod.options)
    cholmod.options.update({"supernodal": 2, "device": device})
    try:
        def run():
            F = cholmod.symbolic(As)
            cholmod.numeric(As, F)
            B = matrix(b.reshape(-1, 1))
            cholmod.solve(F, B)
            return F, np.asarray(B).ravel()
        with _RanOn(ctx.dev):
            (F, x), first, warm = _timed(run)
    finally:
        cholmod.options.clear()
        cholmod.options.update(old)
    if not getattr(F, "_device", False):
        raise AssertionError("cholmod did not take the device tile path")
    _on(ctx.dev, F._X)
    xref = spla.spsolve(A, b)
    res = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    ctx.report(f"7 cholmod tile grid={grid}x{grid} n={n}", first, warm,
               rel_residual=_check("rel_residual", res, 1e-10),
               rel_dx_vs_spsolve=f"{_rel(x, xref):.3e}")


def phase_four(ctx, devs, B=64, n=256, m=512, nk=1024, mk=8192,
               nd=8192, nb=256, blocks=8, bsize=512, nc=64):
    """The multi-card path, each piece compared with one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps
    from kvxopt_tpu import solvers
    from kvxopt_tpu.cones import ConeDims
    from kvxopt_tpu.parallel import (arrow_kkt_factor, batched_qp_solver,
                                     cyclic_unpack, dist_cholesky,
                                     sharded_kkt_solver)
    from kvxopt_tpu.solvers.coneprog import Options

    nd_ = len(devs)
    one = devs[0]
    dims = ConeDims(l=m)
    data = _qp_batch(ctx.rng(8), B, n, m)
    mesh = Mesh(np.array(devs), ("batch",))
    sh = NamedSharding(mesh, Ps("batch"))
    sharded = batched_qp_solver(dims, options=Options(**TOL), mesh=mesh)
    args = [jax.device_put(jnp.asarray(a), sh) for a in data]
    out, first, warm = _timed(lambda: jax.block_until_ready(
        sharded(*args)))
    single = batched_qp_solver(dims, options=Options(**TOL))
    ref = single(*[jax.device_put(jnp.asarray(a), one) for a in data])
    if _optimal_fraction(out) != 1.0:
        raise AssertionError("sharded batch: not all lanes optimal")
    if out[0].sharding.device_set != set(devs):
        raise AssertionError("sharded batch did not span the devices")
    worst = max(_rel(np.asarray(out[0])[i], np.asarray(ref[0])[i])
                for i in range(B))
    ctx.report(f"4x-1 batch-sharded batched_qp_solver B={B} n={n} m={m}",
               first, warm, devices=nd_,
               rel_dx_vs_one_card=_check("rel_dx", worst, 1e-8))

    P, q, G, h = _qp_data(ctx.rng(9), nk, mk)
    kmesh = Mesh(np.array(devs), ("kkt",))
    kd = ConeDims(l=mk)
    dt = jnp.float64

    def sharded_solve():
        factor = sharded_kkt_solver(kmesh, "kkt", kd, jnp.asarray(G, dt),
                                    Pmat=jnp.asarray(P, dt))
        return solvers.coneqp(P, q, G, h, kd, kktsolver=factor)
    sol, first, warm = _timed(sharded_solve)
    with jax.default_device(one):
        ref = solvers.coneqp(P, q, G, h, kd, kktsolver="chol2")
    if sol["status"] != "optimal" or ref["status"] != "optimal":
        raise AssertionError((sol["status"], ref["status"]))
    ctx.report(f"4x-2 sharded_kkt_solver coneqp n={nk} m={mk}", first,
               warm, iters=sol["iterations"],
               rel_dx_vs_one_card=_check(
                   "rel_dx", _rel(sol["x"], ref["x"]), 1e-6))

    A = jax.device_put(jax.random.normal(jax.random.key(ctx.seed),
                                         (nd, nd), dt), one)
    K = A @ A.T / nd + jnp.eye(nd, dtype=dt)
    (Lst, _), first, warm = _timed(lambda: jax.block_until_ready(
        dist_cholesky(kmesh, "kkt", K, nb)))
    L = jax.device_put(cyclic_unpack(Lst, nb, nd_), one)
    res = float(jnp.linalg.norm(L @ L.T - K) / jnp.linalg.norm(K))
    Lone = jnp.linalg.cholesky(K)
    ctx.report(f"4x-3 dist_cholesky n={nd} nb={nb} f64", first, warm,
               factor_res=_check("factor_res", res, 1e-12),
               rel_dL_vs_one_card=f"{_rel(L, Lone):.3e}")

    rng = ctx.rng(10)
    Bb = nd_ * blocks
    Ab = rng.standard_normal((Bb, bsize, bsize))
    Dm = np.einsum("bij,bkj->bik", Ab, Ab) / bsize + np.eye(bsize)
    Cm = rng.standard_normal((Bb, bsize, nc)) * 0.01
    Em = np.eye(nc) * (10.0 + Bb)
    bb = rng.standard_normal((Bb, bsize))
    bc = rng.standard_normal(nc)
    s3 = NamedSharding(kmesh, Ps("kkt", None, None))
    s2 = NamedSharding(kmesh, Ps("kkt", None))

    def arrow():
        solve, _ = arrow_kkt_factor(jax.device_put(Dm, s3),
                                    jax.device_put(Cm, s3),
                                    jnp.asarray(Em), mesh=kmesh)
        return jax.block_until_ready(solve(jax.device_put(bb, s2),
                                           jnp.asarray(bc)))
    (xb, xc), first, warm = _timed(arrow)
    with jax.default_device(one):
        solve1, _ = arrow_kkt_factor(jnp.asarray(Dm), jnp.asarray(Cm),
                                     jnp.asarray(Em))
        xb1, xc1 = solve1(jnp.asarray(bb), jnp.asarray(bc))
    xbh, xch = np.asarray(xb), np.asarray(xc)
    r_blk = np.einsum("bij,bj->bi", Dm, xbh) + Cm @ xch - bb
    r_brd = np.einsum("bij,bi->j", Cm, xbh) + Em @ xch - bc
    res = (np.sqrt(np.sum(r_blk ** 2) + np.sum(r_brd ** 2))
           / np.sqrt(np.sum(bb ** 2) + np.sum(bc ** 2)))
    ctx.report(f"4x-4 arrow_kkt_factor {nd_}x{blocks} blocks of {bsize}",
               first, warm, rel_residual=_check("rel_residual", res, 1e-10),
               rel_dx_vs_one_card=_check(
                   "rel_dx", _rel(np.concatenate([xbh.ravel(), xch]),
                                  np.concatenate([np.ravel(xb1),
                                                  np.ravel(xc1)])),
                   1e-10))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX backend is "
                 f"{jax.default_backend()!r})")
    devs = jax.devices()
    card = _card()
    ctx = Ctx(devs[0], jax.devices("cpu")[0], card, args.seed)
    import kvxopt_tpu  # noqa: F401  (sets x64 and matmul precision)

    phase_device(ctx)
    if args.four:
        if len(devs) < 4:
            sys.exit(f"chip_smoke --four: need 4 GPUs, have {len(devs)}")
        devs = devs[:4]
        phase_four(ctx, devs)
    else:
        devs = devs[:1]
        phase_qp(ctx)
        phase_lp(ctx)
        phase_cones(ctx)
        phase_batched(ctx)
        phase_cholesky(ctx)
        phase_cholmod(ctx)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": ctx.dev.platform, "kind": ctx.dev.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
