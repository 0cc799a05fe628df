"""Dense SPD factor/solve helpers behind the KKT strategies
(kkt._chol_spd / kkt._chol_solve and the triangular solves of the
mixed-precision factor refinement): XLA's Cholesky, checked against
scipy per instance and under vmap, in float32 and float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
from jax.scipy.linalg import solve_triangular

from kvxopt_tpu import kkt
from kvxopt_tpu.cones import ConeDims

TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _spd_batch(B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, 2 * n, n))
    K = np.einsum("bij,bik->bjk", G, G) + n * np.eye(n)
    return K.astype(dtype), rng


@pytest.mark.parametrize("vmapped", [False, True],
                         ids=["per_instance", "vmapped"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B,n,k", [
    (2, 128, 0), (1, 200, 0), (3, 64, 0), (8, 64, 0),
    (3, 256, 1), (2, 200, 4)])
def test_chol_factor_solve(B, n, k, dtype, vmapped):
    """L L' x = b through _chol_spd/_chol_solve: the factor matches
    scipy's and the solve's residual is at the dtype's accuracy."""
    K, rng = _spd_batch(B, n, dtype, seed=B * n + k)
    shape = (B, n) if k == 0 else (B, n, k)
    b = rng.standard_normal(shape).astype(dtype)

    def one(Ki, bi):
        L = kkt._chol_spd(Ki, 0.0)
        return L, kkt._chol_solve(L, bi)

    if vmapped:
        L, x = jax.vmap(one)(jnp.asarray(K), jnp.asarray(b))
    else:
        outs = [one(jnp.asarray(K[i]), jnp.asarray(b[i])) for i in range(B)]
        L, x = (jnp.stack(a) for a in zip(*outs))
    assert L.dtype == dtype and x.shape == b.shape
    tol = TOL[dtype]
    for i in range(B):
        Lref = sla.cholesky(K[i].astype(np.float64), lower=True)
        assert np.abs(np.asarray(L[i]) - Lref).max() / \
            np.abs(Lref).max() < tol
        r = K[i].astype(np.float64) @ np.asarray(x[i], np.float64) - b[i]
        assert np.linalg.norm(r) / np.linalg.norm(b[i]) < tol


def test_chol_spd_regularization():
    """reg adds reg*I before factoring."""
    K, _ = _spd_batch(1, 32, np.float64, seed=0)
    L = np.asarray(kkt._chol_spd(jnp.asarray(K[0]), 0.5))
    np.testing.assert_allclose(L @ L.T, K[0] + 0.5 * np.eye(32),
                               rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B,n,k,trans", [
    (2, 128, 128, False), (2, 128, 128, True),
    (2, 200, 200, False), (2, 200, 200, True),
    (3, 256, 64, False), (2, 256, 1, True)])
def test_tri_solve_vmapped(B, n, k, trans, dtype):
    """The n-RHS triangular solves of the factor refinement (L X = E and
    L' X = E) on the _chol_spd factor, vmapped, against scipy."""
    K, rng = _spd_batch(B, n, dtype, seed=n + k)
    shape = (B, n) if k == 1 else (B, n, k)
    E = rng.standard_normal(shape).astype(dtype)

    def one(Ki, Ei):
        L = kkt._chol_spd(Ki, 0.0)
        return L, solve_triangular(L.T if trans else L, Ei,
                                   lower=not trans)

    L, X = jax.vmap(one)(jnp.asarray(K), jnp.asarray(E))
    assert X.shape == E.shape
    Lh = np.asarray(L, np.float64)
    for i in range(B):
        ref = sla.solve_triangular(Lh[i].T if trans else Lh[i],
                                   E[i].astype(np.float64),
                                   lower=not trans)
        err = np.abs(np.asarray(X[i], np.float64) - ref).max()
        assert err / (np.abs(ref).max() + 1) < TOL[dtype], (i, err)


def test_tri_solve_many_rhs():
    """k=300 right-hand sides (more than n): vmapped equals scipy."""
    B, n, k = 2, 128, 300
    K, rng = _spd_batch(B, n, np.float32, seed=5)
    E = rng.standard_normal((B, n, k)).astype(np.float32)
    L = jax.vmap(lambda Ki: kkt._chol_spd(Ki, 0.0))(jnp.asarray(K))
    X = jax.vmap(lambda Li, Ei: solve_triangular(Li, Ei, lower=True))(
        L, jnp.asarray(E))
    Lh = np.asarray(L, np.float64)
    for i in range(B):
        ref = sla.solve_triangular(Lh[i], E[i].astype(np.float64),
                                   lower=True)
        assert np.abs(np.asarray(X[i]) - ref).max() / \
            (np.abs(ref).max() + 1) < 1e-4


@pytest.mark.parametrize("facref", [False, True],
                         ids=["plain", "factor_refined"])
def test_chol2_mixed_vmapped_matches_per_instance(facref):
    """_kkt_chol2_mixed under vmap gives the per-instance solution, with
    and without the one-shot factor refinement."""
    dims = ConeDims(l=48)
    n, B = 16, 3
    rng = np.random.default_rng(7)
    G = jnp.asarray(rng.standard_normal((B, dims.l, n)))
    P = jnp.asarray(np.stack([np.eye(n) * 2.0] * B))
    d = jnp.asarray(np.abs(rng.standard_normal((B, dims.l))) + 0.5)
    bx = jnp.asarray(rng.standard_normal((B, n)))
    bz = jnp.asarray(rng.standard_normal((B, dims.l)))

    def one(Gi, Pi, di, bxi, bzi):
        from kvxopt_tpu import cones
        W, _ = cones.compute_scaling(dims, di, di)
        factor = kkt.make_kkt_solver("chol2_mixed", dims, Gi, None, Pi,
                                     facref=facref)
        return factor(W)(bxi, jnp.zeros((0,)), bzi)

    vx, _, vz = jax.vmap(one)(G, P, d, bx, bz)
    for i in range(B):
        ux, _, uz = one(G[i], P[i], d[i], bx[i], bz[i])
        np.testing.assert_allclose(np.asarray(vx[i]), np.asarray(ux),
                                   rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(np.asarray(vz[i]), np.asarray(uz),
                                   rtol=1e-9, atol=1e-10)
