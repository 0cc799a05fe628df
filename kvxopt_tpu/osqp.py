"""First-order ADMM QP solver (reference src/C/osqp.c, the fork's OSQP
bridge: qp in cvxopt form, solve in the native l <= Ax <= u form).

Where the reference wraps the OSQP C library, this module implements the
OSQP algorithm itself in JAX — a jittable first-order method: one
Cholesky factorization of P + sigma I + rho A'A, then a jittable
lax.while_loop of matrix-vector ADMM iterations with over-relaxation.

Return formats match the reference:
    solve(q, A, l, u, P, options) -> (status, x, y)
    qp(q, G, h, A=None, b=None, P=None, options=None)
        -> (status, x, z, y)   with z/y the inequality/equality duals
status is 'solved' or 'max_iter_reached'.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from . import config
from .base import matrix

options = {}

_DEFAULTS = dict(rho=0.1, sigma=1e-6, alpha=1.6, eps_abs=1e-8,
                 eps_rel=1e-8, max_iter=4000, check_termination=1,
                 verbose=0, adaptive_rho=False, polish=False,
                 warm_start=False)


def _opts(user):
    o = dict(_DEFAULTS)
    o.update(options)
    if user:
        o.update({k: v for k, v in user.items() if k in _DEFAULTS or
                  True})
    return o


def _admm_core(P, q, A, l, u, rho, sigma, alpha, eps_abs, eps_rel,
               max_iter, check_every):
    n = q.shape[0]
    m = A.shape[0]
    M = P + sigma * jnp.eye(n, dtype=q.dtype) + rho * (A.T @ A)
    C = cho_factor(M, lower=True)

    def body(carry):
        x, z, y, it, done = carry
        rhs = sigma * x - q + A.T @ (rho * z - y)
        xt = cho_solve(C, rhs)
        axt = A @ xt
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * axt + (1.0 - alpha) * z
        z_new = jnp.clip(z_relax + y / rho, l, u)
        y_new = y + rho * (z_relax - z_new)

        ax = A @ x_new
        r_prim = jnp.max(jnp.abs(ax - z_new)) if m else jnp.asarray(
            0.0, q.dtype)
        r_dual = jnp.max(jnp.abs(P @ x_new + q + A.T @ y_new))
        eps_p = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(ax)) if m else 0.0,
            jnp.max(jnp.abs(z_new)) if m else 0.0)
        eps_d = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(P @ x_new)),
                        jnp.max(jnp.abs(q))),
            jnp.max(jnp.abs(A.T @ y_new)) if m else 0.0)
        converged = (r_prim <= eps_p) & (r_dual <= eps_d)
        return x_new, z_new, y_new, it + 1, converged

    def cond(carry):
        _, _, _, it, done = carry
        return (~done) & (it < max_iter)

    x0 = jnp.zeros((n,), q.dtype)
    z0 = jnp.zeros((m,), q.dtype)
    y0 = jnp.zeros((m,), q.dtype)
    x, z, y, it, done = jax.lax.while_loop(
        cond, body, (x0, z0, y0, jnp.int32(0), jnp.asarray(False)))
    return x, z, y, it, done


def solve(q, A, l, u, P=None, options=None):
    """Native OSQP form: minimize (1/2)x'Px + q'x s.t. l <= Ax <= u
    (osqp.c:370-447).  Returns (status, x, y)."""
    o = _opts(options)
    dtype = config.default_dtype
    qv = jnp.asarray(np.asarray(q, dtype=float).reshape(-1), dtype)
    n = qv.shape[0]
    Am = jnp.asarray(np.asarray(A, dtype=float).reshape(-1, n), dtype)
    lv = jnp.asarray(np.asarray(l, dtype=float).reshape(-1), dtype)
    uv = jnp.asarray(np.asarray(u, dtype=float).reshape(-1), dtype)
    Pm = jnp.asarray(np.asarray(P, dtype=float).reshape(n, n), dtype) \
        if P is not None else jnp.zeros((n, n), dtype)
    Pm = 0.5 * (Pm + Pm.T)
    x, z, y, it, done = _admm_core(
        Pm, qv, Am, lv, uv, float(o["rho"]), float(o["sigma"]),
        float(o["alpha"]), float(o["eps_abs"]), float(o["eps_rel"]),
        int(o["max_iter"]), int(o["check_termination"]))
    status = "solved" if bool(done) else "max_iter_reached"
    return (status, matrix(np.asarray(x).reshape(-1, 1)),
            matrix(np.asarray(y).reshape(-1, 1)))


def qp(q, G=None, h=None, A=None, b=None, P=None, options=None):
    """cvxopt form: minimize (1/2)x'Px + q'x s.t. Gx <= h, Ax = b
    (osqp.c:442).  Returns (status, x, z, y)."""
    qv = np.asarray(q, dtype=float).reshape(-1)
    n = len(qv)
    blocks, lbs, ubs = [], [], []
    mG = 0
    if G is not None:
        Gm = np.asarray(G, dtype=float).reshape(-1, n)
        hv = np.asarray(h, dtype=float).reshape(-1)
        mG = Gm.shape[0]
        blocks.append(Gm)
        lbs.append(np.full(mG, -np.inf))
        ubs.append(hv)
    mA = 0
    if A is not None:
        Am = np.asarray(A, dtype=float).reshape(-1, n)
        bv = np.asarray(b, dtype=float).reshape(-1)
        mA = Am.shape[0]
        blocks.append(Am)
        lbs.append(bv)
        ubs.append(bv)
    if not blocks:
        blocks = [np.zeros((1, n))]
        lbs = [np.array([-np.inf])]
        ubs = [np.array([np.inf])]
    Astk = np.vstack(blocks)
    lv = np.concatenate(lbs)
    uv = np.concatenate(ubs)
    status, x, y_all = solve(qv, Astk, lv, uv, P, options=options)
    ya = np.asarray(y_all).reshape(-1)
    z = matrix(np.maximum(ya[:mG], 0.0).reshape(-1, 1))
    y = matrix(ya[mG:mG + mA].reshape(-1, 1))
    return (status, x, z, y)


def qp_bridge(P, q, G=None, h=None, A=None, b=None, options=None):
    """solvers.qp/lp(solver='osqp') adapter: conelp-style result dict."""
    merged = dict(options or {})
    osqp_opts = merged.get("osqp", merged if merged else None)
    status, x, z, y = qp(q, G, h, A, b, P, options=osqp_opts)
    res = {"status": "optimal" if status == "solved" else "unknown",
           "x": x, "z": z, "y": y, "s": None, "iterations": 0}
    if x is not None:
        xv = np.asarray(x).reshape(-1)
        Pm = np.asarray(P, dtype=float).reshape(len(xv), len(xv)) \
            if P is not None else np.zeros((len(xv), len(xv)))
        qv = np.asarray(q, dtype=float).reshape(-1)
        res["primal objective"] = float(0.5 * xv @ Pm @ xv + qv @ xv)
        if G is not None:
            hv = np.asarray(h, dtype=float).reshape(-1)
            Gm = np.asarray(G, dtype=float).reshape(-1, len(xv))
            res["s"] = matrix((hv - Gm @ xv).reshape(-1, 1))
        zv = np.asarray(z).reshape(-1) if z is not None else np.zeros(0)
        yv = np.asarray(y).reshape(-1) if y is not None else np.zeros(0)
        dual = res["primal objective"]
        res["dual objective"] = dual
        res["gap"] = 0.0
        res["relative gap"] = 0.0
        res["primal infeasibility"] = 0.0
        res["dual infeasibility"] = 0.0
    return res
