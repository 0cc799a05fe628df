"""Ports of the reference's cvxbook examples as integration tests.

Reference: examples/book/chap6 (huber.py, tv.py, basispursuit.py,
regsel.py), examples/book/chap7 (maxent.py, expdesign.py), and
examples/doc/chap7/covsel.py.  The reference ships these as
documentation; here each is solved and asserted against an
independent oracle (scipy, analytic optimality conditions, or duality),
since the book publishes figures rather than numbers and the .bin data
files are cvxopt pickles.  tv and covsel exercise paths nothing else
does: operator-form P/G with a custom kktsolver (tv) and the
cholmod symbolic/numeric/solve/diag loop on a sparse Newton method
(covsel)."""

import numpy as np
import pytest

import jax.numpy as jnp

from kvxopt_tpu.cones import ConeDims
from kvxopt_tpu.solvers import qp, lp, cp


def test_huber_robust_regression():
    """book/chap6/huber.py: robust regression via the QP form of the
    Huber penalty (exercise 4.5).  Oracle: scipy minimize of the Huber
    loss directly."""
    rng = np.random.default_rng(0)
    m, n = 60, 2
    u = np.sort(rng.uniform(-1, 1, m))
    v = u + 0.3 * rng.standard_normal(m)
    v[::7] += 3.0 * rng.standard_normal((m + 6) // 7)   # outliers
    A = np.stack([np.ones(m), u], axis=1)

    # minimize (1/2) w'w + 1'y  s.t. -w - y <= Ax - v <= w + y,
    #          0 <= w <= 1, y >= 0;  variables x (n), w (m), y (m)
    nv = n + 2 * m
    P = np.zeros((nv, nv))
    P[n:n + m, n:n + m] = np.eye(m)
    q = np.zeros(nv)
    q[n + m:] = 1.0
    I = np.eye(m)
    G = np.zeros((5 * m, nv))
    h = np.zeros(5 * m)
    G[:m, :n] = A; G[:m, n:n + m] = -I; G[:m, n + m:] = -I; h[:m] = v
    G[m:2 * m, :n] = -A; G[m:2 * m, n:n + m] = -I
    G[m:2 * m, n + m:] = -I; h[m:2 * m] = -v
    G[2 * m:3 * m, n:n + m] = -I
    G[3 * m:4 * m, n:n + m] = I; h[3 * m:4 * m] = 1.0
    G[4 * m:, n + m:] = -I

    sol = qp(P, q, G, h)
    assert sol["status"] == "optimal"
    xh = np.asarray(sol["x"])[:n]

    from scipy.optimize import minimize

    def huber_loss(x):
        r = A @ x - v
        a = np.abs(r)
        return np.sum(np.where(a <= 1.0, r * r, 2 * a - 1.0))

    ref = minimize(huber_loss, np.zeros(n), method="Nelder-Mead",
                   options={"xatol": 1e-10, "fatol": 1e-12,
                            "maxiter": 5000})
    np.testing.assert_allclose(xh, ref.x, atol=1e-4)


def test_tv_smoothing_custom_kkt():
    """book/chap6/tv.py: total-variation smoothing with operator-form P
    and G and the tridiagonal custom kktsolver (the factored S = I +
    4 D' diag(d1 d2/(d1+d2)) D system).  Oracle: the same QP through
    dense matrices and the default kktsolver."""
    rng = np.random.default_rng(1)
    n = 120
    t = np.linspace(0, 4 * np.pi, n)
    corr = np.sign(np.sin(t)) + 0.2 * rng.standard_normal(n)
    delta = 0.8
    nv = 2 * n - 1
    qv = np.concatenate([-corr, delta * np.ones(n - 1)])

    def Pop(u):
        out = jnp.zeros_like(u)
        return out.at[:n].set(u[:n])

    def Gop(u, trans=False):
        if not trans:
            y = u[1:n] - u[:n - 1]
            return jnp.concatenate([y - u[n:], -y - u[n:]])
        # u has length 2(n-1)
        y = u[:n - 1] - u[n - 1:]
        v = jnp.zeros(nv, dtype=u.dtype)
        v = v.at[:n - 1].add(-y)
        v = v.at[1:n].add(y)
        v = v.at[n:].add(-(u[:n - 1] + u[n - 1:]))
        return v

    hvec = np.zeros(2 * (n - 1))

    def kktsolver(W, **kw):
        # W.d is the l-cone scaling; d1 = 1/d[:n-1]^2, d2 = 1/d[n-1:]^2
        di = 1.0 / W.d
        d1 = di[:n - 1] ** 2
        d2 = di[n - 1:] ** 2
        d = 4.0 * d1 * d2 / (d1 + d2)
        S = jnp.diag(jnp.ones(n).at[:n - 1].add(d).at[1:].add(d)) + \
            jnp.diag(-d, 1) + jnp.diag(-d, -1)
        L = jnp.linalg.cholesky(S)

        def Dmul(x):
            return x[1:] - x[:-1]

        def Dtmul(y):
            v = jnp.zeros(n, dtype=y.dtype)
            return v.at[:-1].add(-y).at[1:].add(y)

        def solve(bx, by, bz):
            y = ((d1 - d2) / (d1 + d2)) * bx[n:] + \
                0.5 * d * (bz[:n - 1] - bz[n - 1:])
            r = bx[:n] + Dtmul(y)
            x1 = jnp.linalg.solve(S, r)
            Dx = Dmul(x1)
            x2 = (bx[n:] - d1 * bz[:n - 1] - d2 * bz[n - 1:] +
                  (d1 - d2) * Dx) / (d1 + d2)
            # unscaled uz = (W'W)^{-1}(Geff ux - bz), here diag(d1,d2)
            z1 = d1 * (Dx - x2 - bz[:n - 1])
            z2 = d2 * (-Dx - x2 - bz[n - 1:])
            return (jnp.concatenate([x1, x2]),
                    jnp.zeros(0, dtype=bx.dtype),
                    jnp.concatenate([z1, z2]))

        return solve

    from kvxopt_tpu.solvers import coneqp
    sol = coneqp(Pop, qv, Gop, hvec, {"l": 2 * (n - 1)},
                 kktsolver=kktsolver)
    assert sol["status"] == "optimal"
    x_custom = np.asarray(sol["x"])[:n]

    # dense oracle
    D = np.diff(np.eye(n), axis=0)
    Pd = np.zeros((nv, nv)); Pd[:n, :n] = np.eye(n)
    Gd = np.block([[D, -np.eye(n - 1)], [-D, -np.eye(n - 1)]])
    ref = qp(Pd, qv, Gd, hvec)
    assert ref["status"] == "optimal"
    np.testing.assert_allclose(x_custom, np.asarray(ref["x"])[:n],
                               atol=1e-5)


def test_basispursuit_lasso():
    """book/chap6/basispursuit.py (scaled down): minimize
    ||Ax-y||_2^2 + ||x||_1 as a QP; oracle: the lasso subgradient
    optimality conditions."""
    rng = np.random.default_rng(2)
    N, K = 40, 80
    A = rng.standard_normal((N, K)) / np.sqrt(N)
    x_true = np.zeros(K); x_true[[3, 17, 41]] = [2.0, -1.5, 1.0]
    y = A @ x_true + 0.01 * rng.standard_normal(N)

    nv = 2 * K
    P = np.zeros((nv, nv)); P[:K, :K] = 2.0 * A.T @ A
    q = np.concatenate([-2.0 * A.T @ y, np.ones(K)])
    I = np.eye(K)
    G = np.block([[I, -I], [-I, -I]])
    h = np.zeros(2 * K)
    sol = qp(P, q, G, h)
    assert sol["status"] == "optimal"
    x = np.asarray(sol["x"])[:K]

    g = 2.0 * A.T @ (A @ x - y)
    assert np.all(np.abs(g) <= 1.0 + 1e-5)
    nz = np.abs(x) > 1e-6
    np.testing.assert_allclose(g[nz], -np.sign(x[nz]), atol=1e-5)


def test_regsel_tradeoff():
    """book/chap6/regsel.py: regressor selection via the l1-constrained
    QP sweep; residual must decrease monotonically in alpha and reach
    the least-squares residual."""
    rng = np.random.default_rng(3)
    m, n = 20, 10
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    xln, *_ = np.linalg.lstsq(A, b, rcond=None)

    nv = 2 * n
    P = np.zeros((nv, nv)); P[:n, :n] = A.T @ A
    q = np.concatenate([-A.T @ b, np.zeros(n)])
    I = np.eye(n)
    G = np.zeros((2 * n + 1, nv))
    G[:n, :n] = I; G[:n, n:] = -I
    G[n:2 * n, :n] = -I; G[n:2 * n, n:] = -I
    G[2 * n, n:] = 1.0
    h = np.zeros(2 * n + 1)

    res = []
    alphas = np.abs(xln).sum() * np.array([0.2, 0.5, 0.8, 1.0])
    for alpha in alphas:
        h[-1] = alpha
        sol = qp(P, q, G, h)
        assert sol["status"] == "optimal"
        x = np.asarray(sol["x"])[:n]
        assert np.abs(x).sum() <= alpha + 1e-6
        res.append(np.linalg.norm(A @ x - b))
    assert all(res[i] >= res[i + 1] - 1e-8 for i in range(len(res) - 1))
    np.testing.assert_allclose(res[-1], np.linalg.norm(A @ xln - b),
                               atol=1e-4)


def test_maxent_distribution():
    """book/chap7/maxent.py: the maximum-entropy distribution cp with
    the exact constraint set of the book figure.  Oracle: scipy SLSQP on
    the same problem."""
    n = 50
    a = -1.0 + 2.0 / (n - 1) * np.arange(n)
    I = a < 0
    G = np.zeros((8, n))
    G[0], G[1] = -a, a
    G[2], G[3] = -a ** 2, a ** 2
    G[4], G[5] = -(3 * a ** 3 - 2 * a), 3 * a ** 3 - 2 * a
    G[6, I], G[7, I] = -1.0, 1.0
    h = np.array([0.1, 0.1, -0.5, 0.6, 0.3, -0.2, -0.3, 0.4])
    A = np.ones((1, n)); b = np.array([1.0])

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.full((n,), 1.0)
        if float(jnp.min(x)) <= 0.0:
            return None
        f = jnp.array([jnp.dot(x, jnp.log(x))])
        grad = (1.0 + jnp.log(x)).reshape(1, -1)
        if z is None:
            return f, grad
        H = jnp.diag(z[0] / x)
        return f, grad, H

    sol = cp(F, G, h, A=A, b=b)
    assert sol["status"] == "optimal"
    p = np.asarray(sol["x"])
    assert np.all(p > 0) and abs(p.sum() - 1.0) < 1e-6
    assert np.all(G @ p <= h + 1e-6)

    from scipy.optimize import minimize
    ref = minimize(
        lambda x: np.sum(x * np.log(np.maximum(x, 1e-300))),
        np.full(n, 1.0 / n), method="SLSQP",
        jac=lambda x: 1.0 + np.log(np.maximum(x, 1e-300)),
        bounds=[(1e-9, 1.0)] * n,
        constraints=[{"type": "eq", "fun": lambda x: x.sum() - 1.0},
                     {"type": "ineq", "fun": lambda x: h - G @ x}],
        options={"maxiter": 500, "ftol": 1e-12})
    assert ref.success
    assert abs(float(sol["primal objective"]) - ref.fun) < 1e-5


def test_expdesign_d_optimal():
    """book/chap7/expdesign.py: D-optimal experiment design, the
    -log det V diag(x) V' cp.  Oracle: the D-design duality condition
    v_i' X^{-1} v_i <= dim (=2), with equality on the support."""
    V = np.array([
        [-2.1213, -2.2981, -2.4575, -2.5981, -2.7189, -2.8191, -2.8978,
         -2.9544, -2.9886, -3.0000, 1.5000, 1.4772, 1.4095, 1.2990,
         1.1491, 0.9642, 0.7500, 0.5130, 0.2605, 0.0000],
        [2.1213, 1.9284, 1.7207, 1.5000, 1.2679, 1.0261, 0.7765,
         0.5209, 0.2615, 0.0000, 0.0000, -0.2605, -0.5130, -0.7500,
         -0.9642, -1.1491, -1.2990, -1.4095, -1.4772, -1.5000]])
    n = V.shape[1]
    Vj = jnp.asarray(V)

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.full((n,), 1.0)
        X = (Vj * x[None, :]) @ Vj.T
        if float(jnp.linalg.det(X)) <= 0:
            return None
        Xi = jnp.linalg.inv(X)
        f = jnp.array([-jnp.log(jnp.linalg.det(X))])
        gradf = -jnp.sum(Vj * (Xi @ Vj), axis=0).reshape(1, -1)
        if z is None:
            return f, gradf
        H = z[0] * (Vj.T @ Xi @ Vj) ** 2
        return f, gradf, H

    G = -np.eye(n); h = np.zeros(n)
    A = np.ones((1, n)); b = np.array([1.0])
    sol = cp(F, G, h, A=A, b=b)
    assert sol["status"] == "optimal"
    x = np.asarray(sol["x"])
    assert np.all(x >= -1e-7) and abs(x.sum() - 1.0) < 1e-6
    X = (V * x[None, :]) @ V.T
    Xi = np.linalg.inv(X)
    w = np.sum(V * (Xi @ V), axis=0)
    assert np.max(w) <= 2.0 + 1e-4          # duality: w_i <= dim
    support = x > 1e-5
    np.testing.assert_allclose(w[support], 2.0, atol=1e-3)


def test_covsel_sparse_newton():
    """doc/chap7/covsel.py: covariance selection by Newton's method on
    the sparse pattern, driving cholmod symbolic/numeric/solve/diag and
    spmatrix indexing.  Oracle: at the optimum, (K^{-1})_ij = Y_ij on
    the pattern (stationarity of -log det K + tr(KY))."""
    import scipy.sparse as sp
    from kvxopt_tpu import cholmod
    from kvxopt_tpu.base import matrix, spmatrix

    rng = np.random.default_rng(5)
    n = 25
    # sparse symmetric Y = sample covariance restricted to a banded +
    # random pattern, diagonally dominant so the MLE exists
    M = rng.standard_normal((n, 4 * n))
    C = M @ M.T / (4 * n)
    mask = np.tril(np.abs(np.arange(n)[:, None] -
                          np.arange(n)[None, :]) <= 1)
    extra = sp.random(n, n, 0.05, random_state=7).toarray() != 0
    mask |= np.tril(extra | extra.T)
    Iis, Jjs = np.nonzero(mask)            # lower triangle incl. diag
    full = mask | mask.T
    Ii2, Jj2 = np.nonzero(full)
    Yd = np.where(full, C, 0.0)

    # Newton coordinates: lower-triangle pattern with symmetric basis
    # matrices B_k (E_ii, or E_ij + E_ji), like the reference's I,J lists
    nc = len(Iis)
    Bs = np.zeros((nc, n, n))
    Bs[np.arange(nc), Iis, Jjs] = 1.0
    Bs[np.arange(nc), Jjs, Iis] = 1.0   # no-op for diagonal coords

    F = cholmod.symbolic(spmatrix._from_csc(sp.csc_matrix(
        (np.where(Ii2 == Jj2, 1.0, 1e-8), (Ii2, Jj2)), shape=(n, n))))

    def numeric(Kd):
        Km = spmatrix._from_csc(sp.csc_matrix(
            (Kd[Ii2, Jj2], (Ii2, Jj2)), shape=(n, n)))
        cholmod.numeric(Km, F)

    Kcur = np.eye(n)
    for it in range(60):
        numeric(Kcur)                       # cholmod numeric refactor
        # K^{-1} via cholmod in-place solve on the identity
        Kinv_m = matrix(np.eye(n))
        cholmod.solve(F, Kinv_m)
        Kinv = np.asarray(Kinv_m)
        R = Yd - Kinv
        grad = np.einsum("kij,ij->k", Bs, R)
        T = np.einsum("ip,kpq,qj->kij", Kinv, Bs, Kinv)
        hess = np.einsum("kij,lij->kl", Bs, T)
        v = np.linalg.solve(hess + 1e-13 * np.eye(nc), -grad)
        sqntdecr = -grad @ v
        if sqntdecr < 1e-12:
            break
        dK = np.einsum("k,kij->ij", v, Bs)
        f = (Kcur * Yd).sum() - 2.0 * np.log(
            np.asarray(cholmod.diag(F))).sum()
        s = 1.0
        for _ in range(50):
            Kn = Kcur + s * dK
            try:
                numeric(Kn)
            except ArithmeticError:
                s *= 0.5
                continue
            fn = (Kn * Yd).sum() - 2.0 * np.log(
                np.asarray(cholmod.diag(F))).sum()
            if fn < f - 0.01 * s * sqntdecr:
                break
            s *= 0.5
        Kcur = Kcur + s * dK
    assert sqntdecr < 1e-10
    Kinv = np.linalg.inv(Kcur)
    # stationarity: (K^{-1})_ij = Y_ij on the pattern
    np.testing.assert_allclose(Kinv[Ii2, Jj2], Yd[Ii2, Jj2], atol=1e-6)
    assert np.linalg.eigvalsh(Kcur).min() > 0
