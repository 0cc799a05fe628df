"""KKT strategies: each must solve the scaled Newton system to high accuracy
for random cone problems (the reference's contract, misc.py:1055-1570)."""

import numpy as np
import jax.numpy as jnp
import pytest

from kvxopt_tpu import cones, kkt
from kvxopt_tpu.cones import ConeDims
from .test_cones import random_interior


def build_system(dims, n, p, with_P, seed=0):
    rng = np.random.default_rng(seed)
    N = dims.size
    G = rng.standard_normal((N, n))
    # symmetrize s-block rows so columns are valid cone vectors
    for ofs, m in zip(dims.sofs, dims.s):
        for c in range(n):
            X = G[ofs:ofs + m * m, c].reshape(m, m)
            G[ofs:ofs + m * m, c] = (0.5 * (X + X.T)).ravel()
    A = rng.standard_normal((p, n)) if p else np.zeros((0, n))
    P = None
    if with_P:
        B = rng.standard_normal((n, n))
        P = jnp.asarray(B @ B.T + n * np.eye(n))
    s = random_interior(dims, rng)
    z = random_interior(dims, rng)
    W, _ = cones.compute_scaling(dims, s, z)
    return jnp.asarray(G), jnp.asarray(A), P, W


def check_residual(dims, G, A, P, W, solve, seed=1, tol=1e-6):
    rng = np.random.default_rng(seed)
    n, p, N = G.shape[1], A.shape[0], G.shape[0]
    bx = jnp.asarray(rng.standard_normal(n))
    by = jnp.asarray(rng.standard_normal(p))
    bzn = rng.standard_normal(N)
    for ofs, m in zip(dims.sofs, dims.s):
        X = bzn[ofs:ofs + m * m].reshape(m, m)
        bzn[ofs:ofs + m * m] = (0.5 * (X + X.T)).ravel()
    bz = jnp.asarray(bzn)
    ux, uy, uz = solve(bx, by, bz)
    Px = P @ ux if P is not None else 0.0
    r1 = Px + A.T @ uy + G.T @ uz - bx
    r2 = A @ ux - by
    wtwuz = cones.scale(dims, W, cones.scale(dims, W, uz), trans=True)
    r3 = G @ ux - wtwuz - bz
    scale = 1.0 + float(jnp.linalg.norm(bx))
    assert float(jnp.linalg.norm(r1)) / scale < tol, f"r1 {jnp.linalg.norm(r1)}"
    if p:
        assert float(jnp.linalg.norm(r2)) / scale < tol
    assert float(jnp.linalg.norm(r3)) / scale < tol


DIMS = [ConeDims(l=6), ConeDims(l=2, q=(3, 4), s=(3,))]


@pytest.mark.parametrize("strategy", kkt.STRATEGIES)
@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("p", [0, 2])
@pytest.mark.parametrize("with_P", [False, True])
def test_kkt_solve(strategy, dims, p, with_P):
    n = 5
    G, A, P, W = build_system(dims, n, p, with_P)
    factor = kkt.make_kkt_solver(strategy, dims, G, A, P)
    solve = factor(W)
    check_residual(dims, G, A, P, W, solve)


def test_ldl_nopiv_quasidefinite():
    rng = np.random.default_rng(9)
    n, m = 40, 17
    E = rng.standard_normal((n, n)); E = E @ E.T + n * np.eye(n)
    F = rng.standard_normal((m, m)); F = F @ F.T + m * np.eye(m)
    B = rng.standard_normal((m, n))
    M = np.block([[E, B.T], [B, -F]])
    L, d = kkt.ldl_nopiv(jnp.asarray(M), block=16)
    np.testing.assert_allclose(
        np.asarray(L * np.asarray(d)[None, :] @ L.T), M, atol=1e-8)
    b = rng.standard_normal(n + m)
    x = kkt.ldl_solve(L, d, jnp.asarray(b))
    np.testing.assert_allclose(M @ np.asarray(x), b, atol=1e-8)
    # signs of d reveal the quasidefinite signature
    assert (np.asarray(d[:n]) > 0).all() and (np.asarray(d[n:]) < 0).all()


def test_kkt_with_nonlinear_block():
    # mnl > 0: Df rows scaled like extra 'l' entries (reference 'dnl')
    dims = ConeDims(l=3, q=(3,))
    n, p, mnl = 4, 1, 2
    rng = np.random.default_rng(3)
    G, A, P, _ = build_system(dims, n, p, False)
    Df = jnp.asarray(rng.standard_normal((mnl, n)))
    H = jnp.asarray(np.eye(n))
    edims = dims.with_extra_l(mnl)
    s = random_interior(edims, rng)
    z = random_interior(edims, rng)
    W, _ = cones.compute_scaling(edims, s, z)
    for strategy in kkt.STRATEGIES:
        factor = kkt.make_kkt_solver(strategy, dims, G, A, P=None, mnl=mnl)
        solve = factor(W, H=H, Df=Df)
        Geff = jnp.concatenate([Df, G], axis=0)
        check_residual(edims, Geff, A, H, W, solve)


def test_factor_refinement_extends_conditioning_range(monkeypatch):
    """The one-shot factor correction lets the
    no-fallback mixed core solve cond~2e7 systems to f64 accuracy where
    the plain f32 preconditioner stalls."""
    from kvxopt_tpu import config as cfg
    from kvxopt_tpu.kkt import _mixed_core

    rng = np.random.default_rng(5)
    n = 192
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, -7.2, n)
    K = (Q * d) @ Q.T
    K = 0.5 * (K + K.T)
    b = rng.standard_normal(n)
    x_true = np.linalg.solve(K, b)
    K64 = jnp.asarray(K)
    kmul = lambda x: K64 @ x

    def run(facref):
        keq = (lambda dsc: K64 * dsc[:, None] * dsc[None, :]) \
            if facref else None
        solve = _mixed_core(kmul, K64.astype(jnp.float32), jnp.float64,
                            lambda: K64, max_refine=4, fallback=False,
                            keq64_build=keq)
        x = np.asarray(solve(jnp.asarray(b)))
        return np.linalg.norm(x - x_true) / np.linalg.norm(x_true)

    err_ref = run(True)
    err_plain = run(False)
    assert err_ref < 2e-6, err_ref
    # the plain path needs far more than 4 steps at this conditioning
    assert err_ref < err_plain * 1e-2, (err_ref, err_plain)


def test_cond_any_matches_cond_under_vmap():
    """kkt.cond_any: vmapped results equal per-lane lax.cond results,
    for all-false, mixed, and all-true predicates."""
    import jax
    import jax.numpy as jnp
    from kvxopt_tpu.kkt import cond_any

    K = jnp.asarray(np.random.default_rng(0).standard_normal((3, 4, 4)))

    def one(pred, Ki, b):
        return cond_any(pred, lambda x: Ki @ x + 1.0,
                        lambda x: 2.0 * x, b)

    b = jnp.asarray(np.random.default_rng(1).standard_normal((3, 4)))
    for pv in ([False] * 3, [True, False, True], [True] * 3):
        pred = jnp.asarray(pv)
        out = jax.vmap(one)(pred, K, b)
        for i in range(3):
            ref = (K[i] @ b[i] + 1.0) if pv[i] else 2.0 * b[i]
            np.testing.assert_allclose(np.asarray(out[i]),
                                       np.asarray(ref), atol=1e-12)
        # scalar path agrees too
        s = one(pred[0], K[0], b[0])
        np.testing.assert_allclose(np.asarray(s), np.asarray(out[0]),
                                   atol=1e-12)
