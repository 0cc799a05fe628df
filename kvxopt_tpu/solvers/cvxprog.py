"""Nonlinear convex optimization: cpl, cp, gp.

Reference semantics: src/python/cvxprog.py (cpl :35, cp :1359, gp :1967).
cpl solves

    minimize    c'x
    subject to  f(x) <= 0        (mnl smooth convex constraints)
                G x + s = h, s in K
                A x = b

given the reference's oracle contract (cvxprog.py:68-110):

    F()      -> (mnl, x0)
    F(x)     -> (f, Df)          (None/NaN if x outside the domain)
    F(x, z)  -> (f, Df, H)       with H = sum_i z_i * d2f_i(x)

The nonlinear multipliers are scaled exactly like extra 'l' entries (the
reference's 'dnl' blocks), so the cone machinery is reused with
dims.with_extra_l(mnl).  The JAX-native twist: `oracle_from_function`
builds the full (f, Df, H) contract from a plain JAX function via autodiff
(jacfwd/hessian) — the reference's hand-coded derivative contract becomes
optional.  gp's log-sum-exp oracle is hand-coded (softmax gradient,
diag(w) - ww' Hessian) so it stays matmul-shaped.

The outer loop runs eagerly (Python) because each iteration re-linearizes
the oracle; every inner operation (scaling, KKT factor/solve, cone ops) is
jitted jax.  The step is a Mehrotra predictor-corrector with the
reference's merit line search: backtracking on
phi = theta1*gap + theta2*||rx|| + theta3*||rznl|| with sufficient-decrease
tests and the relaxed-iterations mechanism (up to MAX_RELAXED_ITERS full
steps, resuming the saved first line search of a series when the merit
fails to decrease — reference cvxprog.py:1080-1263).

Two design points follow the reference exactly because they are what make
hard SDP-cone problems (acent2) converge:

- The iterate state is the *scaled* pair (W, lambda), updated incrementally
  each step (cones.update_scaling_inc == reference misc.py:422); the
  unscaled (s, z) are reconstructed only for feasibility residuals.  Near
  the cone boundary this is far better conditioned than recomputing W from
  (s, z).
- s-block data (G columns, h) is read in the cone-program API's
  lower-triangle storage convention (cones.sym_from_lower; reference
  trisc/sgemv semantics, misc.py:766-831).

One robustness addition beyond the reference: if the condensed Cholesky
KKT path returns non-finite directions (jnp.linalg.cholesky NaNs silently
where LAPACK potrf raises), the iteration retries with the regularized
full 3x3 LDL factorization before giving up.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from .. import cones, kkt, config
from ..cones import ConeDims
from .coneprog import (
    OPTIMAL, UNKNOWN, SINGULAR, _STATUS_STR, STEP, EXPON,
    _resolve_options, _asarray, _relgap, VecOps, DEFAULT_VECOPS,
    _make_vecops)

_DEBUG_LS = __import__('os').environ.get('KVX_DEBUG_LS')

# line-search constants (reference cvxprog.py:385-388)
BETA = 0.5
ALPHA = 0.01
MAX_RELAXED_ITERS = 8


def oracle_from_function(f, x0, mnl=None):
    """Build a cpl/cp oracle from a plain JAX function f(x) -> vector of
    constraint values.  Derivatives via autodiff."""
    x0 = jnp.asarray(x0, dtype=config.default_dtype)
    fx0 = f(x0)
    m = int(fx0.shape[0]) if fx0.ndim else 1
    fv = (lambda x: jnp.atleast_1d(f(x)))
    jac = jax.jacfwd(fv)

    def oracle(x=None, z=None):
        if x is None:
            return m, x0
        x = jnp.asarray(x)
        val, Df = fv(x), jac(x)
        if z is None:
            return val, Df
        z = jnp.asarray(z)
        H = jax.hessian(lambda xx: jnp.dot(z, fv(xx)))(x)
        return val, Df, H

    return oracle


def cpl(c, F, G=None, h=None, dims=None, A=None, b=None, kktsolver=None,
        options=None, xnewcopy=None, xdot=None, xscal=None, xaxpy=None,
        ynewcopy=None, ydot=None, yscal=None, yaxpy=None):
    """Nonlinear cone program with linear objective (reference
    cvxprog.py:35).

    Custom vector spaces (reference cvxprog.py's xnewcopy/... contract):
    passing any x*/y* hook makes x and c (resp. y and b) abstract pytrees;
    G/A must then be operators, kktsolver a custom factor, and the oracle's
    Df (and H) must be *operators* — Df(u, trans=False) maps x-space to
    R^mnl, Df(v, trans=True) maps R^mnl to x-space, H(u) maps x-space to
    x-space."""
    o, dtype, merged = _resolve_options(options)
    custom_x = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy))
    custom_y = any(f is not None for f in (ynewcopy, ydot, yscal, yaxpy))
    xops = _make_vecops(xnewcopy, xdot, xscal, xaxpy)
    yops = _make_vecops(ynewcopy, ydot, yscal, yaxpy)
    if (custom_x or custom_y) and not callable(kktsolver):
        raise ValueError("custom vector spaces require a custom kktsolver")
    if not custom_x:
        c = _asarray(c, dtype, name="c")
        n = c.shape[0]
    else:
        n = None
    mnl, x0 = F()
    mnl = int(mnl)
    if not custom_x:
        x0 = _asarray(x0, dtype, name="x0")

    if dims is None:
        dims = ConeDims(l=0 if h is None else int(np.asarray(h).size))
    dims = ConeDims.from_dict(dims)
    if G is None:
        if custom_x:
            if dims.size:
                raise ValueError("custom x vector space requires "
                                 "operator-form G when dims is nonempty")
            G = lambda v, trans=False: (xops.zero(c) if trans
                                        else jnp.zeros((0,), dtype))
        else:
            G = jnp.zeros((dims.size, n), dtype)
            h = jnp.zeros((dims.size,), dtype)
    G_is_op = callable(G)
    if custom_x and not G_is_op:
        raise ValueError("custom x vector space requires operator-form G")
    if G_is_op and not callable(kktsolver):
        raise ValueError("operator-form G requires a custom kktsolver")
    Ga = G if G_is_op else cones.sym_from_lower_cols(
        dims, _asarray(G, dtype, shape=(dims.size, n), name="G"))
    gmv = G if G_is_op else (lambda v, trans=False:
                             (Ga.T @ v if trans else Ga @ v))
    h = (cones.sym_from_lower(dims, _asarray(h, dtype, shape=(dims.size,),
                                             name="h"))
         if h is not None else jnp.zeros((dims.size,), dtype))
    if custom_y:
        if A is None or not callable(A) or b is None:
            raise ValueError("custom y vector space requires operator-form "
                             "A and b")
        amv = A
        p = 1
    else:
        A_is_op = A is not None and callable(A)
        if A_is_op and not callable(kktsolver):
            raise ValueError("operator-form A requires a custom kktsolver")
        if A_is_op:
            amv = A
            if b is None:
                raise ValueError("operator-form A requires b")
            b = _asarray(b, dtype, name="b")
        else:
            Aa = _asarray(A, dtype, name="A") if A is not None else \
                jnp.zeros((0, n), dtype) if n is not None else None
            if Aa is None:
                Aa = jnp.zeros((0, 1), dtype)
            amv = (lambda v, trans=False:
                   (Aa.T @ v if trans else Aa @ v))
            b = _asarray(b, dtype, name="b") if b is not None else \
                jnp.zeros((0,), dtype)
        p = b.shape[0] if not custom_y else 1

    o = o.resolve_refinement(dims, kktsolver)
    edims = dims.with_extra_l(mnl)
    edeg = edims.degree
    e = cones.cone_e(edims, dtype)

    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    fallback_factor = None
    if isinstance(kktsolver, str):
        factor = kkt.make_kkt_solver(kktsolver, dims, Ga, Aa, None,
                                     mnl=mnl, reg=o.kktreg)
        if kktsolver != "ldl":
            # Robustness fallback: when the IPM drives gap far below the
            # feasibility residuals (possible under the reference's
            # relaxed line-search dynamics), the condensed Cholesky
            # systems reach condition ~1/eps and jnp's cholesky returns
            # NaN silently (LAPACK potrf would raise — reference
            # misc.py:1352 has no guard either and terminates 'unknown').
            # The regularized full 3x3 LDL solve survives this regime.
            fallback_factor = kkt.make_kkt_solver(
                "ldl", dims, Ga, Aa, None, mnl=mnl, reg=o.kktreg)
    else:
        factor = kktsolver

    def _allfinite(*trees):
        for t in trees:
            for leaf in jax.tree_util.tree_leaves(t):
                if not bool(jnp.all(jnp.isfinite(leaf))):
                    return False
        return True

    def feval(x, z=None):
        out = F(x) if z is None else F(x, z)
        if out is None or out[0] is None:
            return None
        if z is None:
            f, Df = out
            if not callable(Df):
                Df = jnp.atleast_2d(_asarray(Df, dtype, name="Df"))
            return jnp.atleast_1d(_asarray(f, dtype)), Df
        f, Df, H = out
        if not callable(Df):
            Df = jnp.atleast_2d(_asarray(Df, dtype, name="Df"))
        if not callable(H):
            H = _asarray(H, dtype, name="H")
        return jnp.atleast_1d(_asarray(f, dtype)), Df, H

    def _dfmv(Df):
        if callable(Df):
            return Df
        return lambda u, trans=False: (Df.T @ u if trans else Df @ u)

    def geff_mv(Df, v, trans=False):
        dmv = _dfmv(Df)
        if trans:
            return xops.axpy(dmv(v[:mnl], trans=True),
                             gmv(v[mnl:], trans=True))
        return jnp.concatenate([dmv(v), gmv(v)])

    # initial point (reference cvxprog.py: x = x0, s/z = identity-ish)
    x = x0
    y = yops.zero(b)
    s = e.copy()
    z = e.copy()
    W = lmbda = None   # scaled state, computed at it == 0, then updated
                       # incrementally (reference cvxprog.py:760-1335)

    out0 = feval(x)
    if out0 is None:
        raise ValueError("x0 must be in the domain of f")

    status = UNKNOWN
    metrics = {}
    iters_done = 0
    # relaxed-line-search state (reference cvxprog.py:385-388,1080-1118)
    relaxed_iters = 0
    phi0 = dphi0 = step0 = 0.0
    saved = None
    theta1 = theta2 = theta3 = 0.0
    pres0 = dres0 = 1.0

    for it in range(o.maxiters + 1):
        f, Df = feval(x)
        rx = xops.axpy(geff_mv(Df, z, trans=True), c)
        if p:
            rx = xops.axpy(amv(y, trans=True), rx)
        ry = yops.axpy(b, amv(x), -1.0) if p else b
        rznl = s[:mnl] + f
        rzl = s[mnl:] + gmv(x) - h
        rz = jnp.concatenate([rznl, rzl])
        gap = cones.sdot(edims, s, z)

        pcost = xops.dot(c, x)
        dcost = pcost + (yops.dot(y, ry) if p else 0.0) + \
            cones.sdot(edims, z, rz) - gap
        relgap = _relgap(gap, pcost, dcost)
        resx_v = float(xops.norm(rx))
        resy_v = float(yops.norm(ry)) if p else 0.0
        resznl_v = float(jnp.linalg.norm(rznl))
        reszl_v = float(cones.snrm2(dims, rzl))
        pres_raw = math.sqrt(resy_v ** 2 + resznl_v ** 2 + reszl_v ** 2)
        if it == 0:
            pres0 = max(1.0, pres_raw)
            dres0 = max(1.0, resx_v)
            # merit weights (reference cvxprog.py:713-719)
            theta1 = 1.0 / float(gap)
            theta2 = 1.0 / max(1.0, resx_v)
            theta3 = 1.0 / max(1.0, resznl_v)
        pres = pres_raw / pres0
        dres = resx_v / dres0
        phi = theta1 * float(gap) + theta2 * resx_v + theta3 * resznl_v

        if o.show_progress:
            print(f"{it:2d}: {float(pcost): .4e} {float(dcost): .4e} "
                  f"{float(gap): .0e} {float(pres): .0e} "
                  f"{float(dres): .0e}")

        metrics = dict(pcost=float(pcost), dcost=float(dcost),
                       gap=float(gap), relgap=float(relgap),
                       pres=float(pres), dres=float(dres))
        iters_done = it
        if (pres <= o.feastol and dres <= o.feastol and
                (gap <= o.abstol or
                 (math.isfinite(float(relgap)) and relgap <= o.reltol))):
            status = OPTIMAL
            break
        if it == o.maxiters:
            status = UNKNOWN
            break

        _, _, H = feval(x, z[:mnl])
        if it == 0:
            W, lmbda = cones.compute_scaling(edims, s, z,
                                             method=o.sscaling)
        try:
            solve = factor(W, H=H, Df=Df)
        except Exception:
            if 0 < relaxed_iters < MAX_RELAXED_ITERS and saved is not None:
                # The singular factor may be caused by a relaxed line
                # search: restore the saved series start and require a
                # standard line search (reference cvxprog.py:785-815).
                x, y = saved["x"], saved["y"]
                s, z = saved["s"], saved["z"]
                W, lmbda = saved["W"], saved["lmbda"]
                relaxed_iters = -1
                saved = None
                continue
            status = SINGULAR
            break
        lmbdasq = cones.ssqr(edims, lmbda)
        mu = gap / edeg

        hmv = H if callable(H) else (lambda u: H @ u)

        fb_solve_cache = []

        def newton(d_target):
            out = _newton(solve, d_target)
            if fallback_factor is not None and not _allfinite(*out):
                if not fb_solve_cache:
                    fb_solve_cache.append(
                        fallback_factor(W, H=H, Df=Df))
                out = _newton(fb_solve_cache[0], d_target)
            return out

        def _newton(solve, d_target):
            tmp = cones.sinv(edims, lmbda, d_target)
            bz = -rz - cones.scale(edims, W, tmp, trans=True)
            dx, dy, dz = solve(xops.scal(-1.0, rx),
                               yops.scal(-1.0, ry), bz)
            for _ in range(o.refinement):
                # r1 = -rx - (H dx + A'dy + Geff'dz)    (x-space)
                t1 = xops.axpy(hmv(dx), geff_mv(Df, dz, trans=True))
                if p:
                    t1 = xops.axpy(amv(dy, trans=True), t1)
                r1 = xops.axpy(rx, xops.scal(-1.0, t1), -1.0)
                # r2 = -ry - A dx                        (y-space)
                r2 = (yops.scal(-1.0, yops.axpy(amv(dx), ry))
                      if p else ry)
                wtwdz = cones.scale(edims, W,
                                    cones.scale(edims, W, dz), trans=True)
                r3 = bz - (geff_mv(Df, dx) - wtwdz)
                ex, ey, ez = solve(r1, r2, r3)
                dx = xops.axpy(ex, dx)
                dy = yops.axpy(ey, dy) if p else dy
                dz = dz + ez
            ds = cones.scale(edims, W,
                             tmp - cones.scale(edims, W, dz), trans=True)
            return dx, dy, dz, ds

        # ---- Mehrotra predictor-corrector with the reference's merit
        # line search: relaxed backtracking on
        #     phi = theta1*gap + theta2*||rx|| + theta3*||rznl||
        # (reference cvxprog.py:1010-1235; constants :385-388) ----------

        def make_trial(xc, yc, sc, zc, dxc, dyc, dzc, dsc, sigma_c,
                       gap_c, dsdz_c):
            def trial(stp):
                xn = xops.axpy(dxc, xc, stp)
                outn = feval(xn)
                if outn is None or not bool(jnp.all(jnp.isfinite(
                        jnp.asarray(outn[0])))):
                    return None
                fn_, Dfn_ = outn
                yn = yops.axpy(dyc, yc, stp) if p else yc
                sn = sc + stp * dsc
                zn = zc + stp * dzc
                rxn = xops.axpy(geff_mv(Dfn_, zn, trans=True), c)
                if p:
                    rxn = xops.axpy(amv(yn, trans=True), rxn)
                newresx = float(xops.norm(rxn))
                newresznl = float(jnp.linalg.norm(sn[:mnl] + fn_))
                # predicted gap along the step (reference :1157-1159)
                newgap = (1.0 - (1.0 - sigma_c) * stp) * gap_c + \
                    stp * stp * dsdz_c
                newphi = theta1 * newgap + theta2 * newresx + \
                    theta3 * newresznl
                if not math.isfinite(newphi):
                    return None
                return dict(x=xn, y=yn, s=sn, z=zn, gap=newgap,
                            phi=newphi, stp=stp)
            return trial

        def backtrack(tri, stp, phi_ref, dphi_ref):
            """Standard backtracking to sufficient merit decrease
            (reference cvxprog.py:1178-1186)."""
            for _ in range(90):
                tr = tri(stp)
                if tr is not None and tr["phi"] <= phi_ref + \
                        ALPHA * stp * dphi_ref:
                    return tr
                stp *= BETA
            return None

        def first_step(tri, stp):
            """Relaxed acceptance: the first finite in-domain step
            (the reference takes the full step unconditionally after
            the domain backtrack, cvxprog.py:1186-1235)."""
            for _ in range(60):
                tr = tri(stp)
                if tr is not None:
                    return tr
                stp *= BETA
            return None

        sigma = 0.0
        accepted = None
        failed = False
        for i in (0, 1):
            # Note: unlike conelp, the reference's cpl corrector target
            # has no second-order (ds o dz) term (cvxprog.py:976-992).
            d_t = -lmbdasq if i == 0 else -lmbdasq + sigma * mu * e
            dx, dy, dz, ds = newton(d_t)
            # scaled directions and the eigendecompositions needed for
            # the post-step scaling update (reference :1040-1060)
            ds_w = cones.scale(edims, W, ds, trans=True, inverse=True)
            dz_w = cones.scale(edims, W, dz)
            dsdz = float(cones.sdot(edims, ds_w, dz_w))
            ts, eig_s = cones.max_step_eig(
                edims, cones.scale2(edims, lmbda, ds_w))
            tz, eig_z = cones.max_step_eig(
                edims, cones.scale2(edims, lmbda, dz_w))
            t = max(0.0, float(ts), float(tz))
            step = 1.0 if t <= 0.0 else min(1.0, STEP / t)

            # backtrack until x + step*dx is in the domain of f
            # (reference :1044-1053)
            indom = False
            for _ in range(60):
                if feval(xops.axpy(dx, x, step)) is not None:
                    indom = True
                    break
                step *= BETA
            if not indom:
                failed = True
                break

            trial = make_trial(x, y, s, z, dx, dy, dz, ds, sigma,
                               float(gap), dsdz)
            ctx = dict(trial=trial, x=x, y=y, s=s, z=z, W=W, lmbda=lmbda,
                       ds_w=ds_w, dz_w=dz_w, eig_s=eig_s, eig_z=eig_z)

            if i == 0:
                # predictor: backtrack until the gap decrease test (and,
                # outside a relaxed series, sufficient phi decrease)
                # holds (reference :1163-1170); exit sets sigma
                dphi = -phi
                tr = None
                for _ in range(60):
                    tr = trial(step)
                    if tr is not None and (
                            tr["gap"] <= (1.0 - ALPHA * step) * float(gap)
                            and (0 <= relaxed_iters < MAX_RELAXED_ITERS
                                 or tr["phi"] <= phi + ALPHA * step *
                                 dphi)):
                        break
                    tr = None
                    step *= BETA
                if tr is None:
                    failed = True
                    break
                ratio = tr["gap"] / float(gap)
                # clamp to [0, 1]: the predicted gap can go negative on
                # aggressive affine steps, and a negative sigma would
                # make the corrector an anti-centering step
                sigma = min(1.0, max(0.0, min(ratio, ratio ** EXPON)))
                continue

            # corrector: relaxed / standard line search with saved-state
            # resume (reference :1080-1263)
            dphi = (-theta1 * (1.0 - sigma) * float(gap)
                    - theta2 * resx_v - theta3 * resznl_v)

            if relaxed_iters == -1 or MAX_RELAXED_ITERS == 0:
                # standard backtracking line search
                tr = backtrack(trial, step, phi, dphi)
                if tr is None:
                    failed = True
                    break
                accepted = (tr, ctx)
            elif relaxed_iters == 0:
                tr = first_step(trial, step)
                if tr is None:
                    failed = True
                    break
                if tr["phi"] <= phi + ALPHA * tr["stp"] * dphi:
                    relaxed_iters = 0
                else:
                    # save the series start for a possible later resume
                    phi0, dphi0, step0 = phi, dphi, tr["stp"]
                    saved = ctx
                    relaxed_iters = 1
                accepted = (tr, ctx)
            elif relaxed_iters < MAX_RELAXED_ITERS:
                tr = first_step(trial, step)
                if tr is None:
                    failed = True
                    break
                if tr["phi"] <= phi0 + ALPHA * step0 * dphi0:
                    relaxed_iters = 0
                    saved = None
                else:
                    relaxed_iters += 1
                accepted = (tr, ctx)
            else:  # relaxed_iters == MAX_RELAXED_ITERS
                tr = first_step(trial, step)
                if tr is not None and tr["phi"] <= phi0 + ALPHA * \
                        step0 * dphi0:
                    # series ends with sufficient decrease w.r.t. phi0
                    relaxed_iters = 0
                    saved = None
                    accepted = (tr, ctx)
                else:
                    # resume the saved first line search of the series
                    # as a standard one (reference :1231-1263); stay in
                    # standard mode afterwards (the reference's shipped
                    # behavior — its `relaxed_iters == 0` at :1184 is a
                    # comparison, not an assignment)
                    sctx = saved
                    tr = backtrack(sctx["trial"], step0, phi0, dphi0)
                    relaxed_iters = -1
                    saved = None
                    if tr is None:
                        failed = True
                        break
                    accepted = (tr, sctx)

        if _DEBUG_LS:
            acc_tr = accepted[0] if accepted else None
            print(f"    [ls] it={it} sigma={sigma:.3e} "
                  f"relaxed={relaxed_iters} phi={phi:.3e} "
                  f"acc_phi={acc_tr['phi'] if acc_tr else None} "
                  f"acc_gap={acc_tr['gap'] if acc_tr else None} "
                  f"acc_stp={acc_tr.get('stp') if acc_tr else None}")
        if failed or accepted is None:
            status = UNKNOWN
            break
        tr, ctx = accepted
        x, y = tr["x"], tr["y"]
        stp = tr["stp"]
        # Incremental scaling update from the *scaled* new iterates
        # (reference cvxprog.py:1268-1335 + misc.py:422): far better
        # conditioned near the cone boundary than recomputing W from the
        # unscaled pair — the fix for SDP-cone cpl stalls (acent2).
        su = cones.step_scaled_iterates(edims, ctx["lmbda"], ctx["ds_w"],
                                        ctx["eig_s"], stp)
        zu = cones.step_scaled_iterates(edims, ctx["lmbda"], ctx["dz_w"],
                                        ctx["eig_z"], stp)
        W, lmbda = cones.update_scaling_inc(edims, ctx["W"], ctx["lmbda"],
                                            su, zu, method=o.sscaling)
        # unscaled s, z are only needed for feasibility residuals
        s, z = cones.lmbda_to_cone(edims, W, lmbda)

    snl, sl = s[:mnl], s[mnl:]
    znl, zl = z[:mnl], z[mnl:]
    relgap = metrics.get("relgap", float("inf"))
    return {
        "status": _STATUS_STR.get(status, "unknown"),
        "x": x, "y": y, "snl": snl, "sl": sl, "znl": znl, "zl": zl,
        "primal objective": metrics.get("pcost"),
        "dual objective": metrics.get("dcost"),
        "gap": metrics.get("gap"),
        "relative gap": relgap if math.isfinite(relgap) else None,
        "primal infeasibility": metrics.get("pres"),
        "dual infeasibility": metrics.get("dres"),
        "primal slack": -float(cones.max_step(edims, s)),
        "dual slack": -float(cones.max_step(edims, z)),
        "iterations": iters_done,
    }


def cp(F, G=None, h=None, dims=None, A=None, b=None, kktsolver=None,
       options=None, xnewcopy=None, xdot=None, xscal=None, xaxpy=None,
       ynewcopy=None, ydot=None, yscal=None, yaxpy=None):
    """Nonlinear objective: minimize f0(x) s.t. f_k(x) <= 0, Gx + s = h,
    Ax = b, via the epigraph transform onto cpl (reference
    cvxprog.py:1359,1767-1958).  F's value vector has mnl+1 entries with f0
    first.

    With custom x-space hooks, the epigraph variable is the pytree tuple
    (x, t); the x*-hooks for the extended space are synthesized from the
    given ones (the reference's xdot_e construction, cvxprog.py:1767-1850),
    and the user kktsolver sees the extended operators (Df_e/G_e/A_e)."""
    o, dtype, merged = _resolve_options(options)
    custom_x = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy))
    if custom_x:
        return _cp_custom(F, G, h, dims, A, b, kktsolver, merged, dtype,
                          _make_vecops(xnewcopy, xdot, xscal, xaxpy),
                          ynewcopy, ydot, yscal, yaxpy)
    mnl, x0 = F()
    mnl = int(mnl)
    x0 = _asarray(x0, dtype, name="x0")
    n = x0.shape[0]

    f0 = F(x0)
    if f0 is None or f0[0] is None:
        raise ValueError("x0 must be in the domain of f")
    t0 = 0.0   # the reference starts the epigraph variable at 0
               # (cvxprog.py:1778 `return mnl+1, [x0, 0.0]`)

    def F_e(xe=None, z=None):
        if xe is None:
            return mnl + 1, jnp.concatenate(
                [x0, jnp.asarray([t0], dtype)])
        x, t = xe[:n], xe[n]
        out = F(x) if z is None else F(x, z)
        if out is None or out[0] is None:
            return None
        if z is None:
            f, Df = out[0], out[1]
        else:
            f, Df, H = out
        f = jnp.atleast_1d(jnp.asarray(f, dtype))
        fe = f.at[0].add(-t)
        if callable(Df):
            # operator-form Df (requires a custom kktsolver, like the
            # reference cvxprog.py:1795): extend with the -t column
            dmv = Df

            def Dfe(u, trans=False):
                if trans:
                    ux = dmv(u, trans=True)
                    return jnp.concatenate([ux, -u[:1]])
                return dmv(u[:n]).at[0].add(-u[n])
        else:
            Dfm = jnp.atleast_2d(jnp.asarray(Df, dtype))
            col = jnp.zeros((mnl + 1, 1), dtype).at[0, 0].set(-1.0)
            Dfe = jnp.concatenate([Dfm, col], axis=1)
        if z is None:
            return fe, Dfe
        if callable(H):
            # operator-form H (reference's l2ac pattern,
            # examples/doc/chap9/l2ac.py:30-38): extend with a zero
            # row/column for the epigraph variable
            hmv = H

            def He(u):
                return jnp.concatenate([hmv(u[:n]),
                                        jnp.zeros((1,), dtype)])
        else:
            He = jnp.zeros((n + 1, n + 1), dtype).at[:n, :n].set(
                jnp.asarray(H, dtype))
        return fe, Dfe, He

    if dims is None:
        dims = ConeDims(l=0 if h is None else int(np.asarray(h).size))
    dims = ConeDims.from_dict(dims)
    if G is not None:
        Ga = np.asarray(G, dtype=float).reshape(dims.size, n)
        G_e = np.concatenate([Ga, np.zeros((dims.size, 1))], axis=1)
    else:
        G_e = None
    if A is not None:
        Aa = np.asarray(A, dtype=float)
        A_e = np.concatenate([Aa, np.zeros((Aa.shape[0], 1))], axis=1)
    else:
        A_e = None
    c_e = np.zeros(n + 1)
    c_e[n] = 1.0
    sol = cpl(c_e, F_e, G_e, h, dims, A_e, b, kktsolver=kktsolver,
              options=merged)
    sol = dict(sol)
    xe = sol["x"]
    sol["x"] = xe[:n]
    return sol


def _cp_custom(F, G, h, dims, A, b, kktsolver, merged, dtype,
               xops: VecOps, ynewcopy, ydot, yscal, yaxpy):
    """cp over a custom x vector space: epigraph variable (x, t) as a
    pytree tuple, extended hooks synthesized from `xops`."""
    mnl, x0 = F()
    mnl = int(mnl)
    f0 = F(x0)
    if f0 is None or f0[0] is None:
        raise ValueError("x0 must be in the domain of f")
    t0 = jnp.asarray(0.0, dtype)   # reference cvxprog.py:1778

    def F_e(xe=None, z=None):
        if xe is None:
            return mnl + 1, (x0, t0)
        x, t = xe
        out = F(x) if z is None else F(x, z)
        if out is None or out[0] is None:
            return None
        if z is None:
            f, Df = out[0], out[1]
            H = None
        else:
            f, Df, H = out
        f = jnp.atleast_1d(jnp.asarray(f, dtype))
        fe = f.at[0].add(-t)
        dmv = Df if callable(Df) else (
            lambda u, trans=False: (jnp.asarray(Df).T @ u if trans
                                    else jnp.asarray(Df) @ u))

        def Df_e(u, trans=False):
            if trans:
                return (dmv(u, trans=True), -u[0])
            ux, ut = u
            return dmv(ux).at[0].add(-ut)

        if z is None:
            return fe, Df_e
        hmv = H if callable(H) else (lambda u: jnp.asarray(H) @ u)

        def H_e(u):
            ux, ut = u
            return (hmv(ux), jnp.zeros_like(t0))

        return fe, Df_e, H_e

    def G_e(u, trans=False):
        if G is None:
            raise ValueError("custom-space cp with cone constraints "
                             "requires operator G")
        if trans:
            return (G(u, trans=True), jnp.zeros_like(t0))
        return G(u[0])

    A_e = None
    if A is not None:
        def A_e(u, trans=False):
            if trans:
                return (A(u, trans=True), jnp.zeros_like(t0))
            return A(u[0])

    c_e = (xops.scal(0.0, x0), jnp.ones_like(t0))

    def xdot_e(u, v):
        return xops.dot(u[0], v[0]) + u[1] * v[1]

    def xscal_e(alpha, u):
        return (xops.scal(alpha, u[0]), alpha * u[1])

    def xaxpy_e(u, v, alpha=1.0):
        return (xops.axpy(u[0], v[0], alpha), alpha * u[1] + v[1])

    def xnewcopy_e(u):
        return (xops.copy(u[0]), u[1])

    sol = cpl(c_e, F_e, G_e if G is not None else None, h, dims, A_e, b,
              kktsolver=kktsolver, options=merged, xnewcopy=xnewcopy_e,
              xdot=xdot_e, xscal=xscal_e, xaxpy=xaxpy_e,
              ynewcopy=ynewcopy, ydot=ydot, yscal=yscal, yaxpy=yaxpy)
    sol = dict(sol)
    if sol["x"] is not None:
        sol["x"] = sol["x"][0]
    return sol


def gp(K, F, g, G=None, h=None, A=None, b=None, kktsolver=None,
       options=None):
    """Geometric program in convex (log-sum-exp) form (reference
    cvxprog.py:1967): minimize lse(F_0 x + g_0) s.t. lse(F_i x + g_i) <= 0,
    Gx <= h, Ax = b, where F's rows are partitioned by K.

    The oracle is the hand-coded log-sum-exp contract of the reference
    (cvxprog.py:2102-2154): value via max-shifted lse, gradient F_i'w with
    softmax weights w, Hessian F_i'(diag(w) - ww')F_i."""
    K = [int(k) for k in K]
    Fm = jnp.asarray(np.asarray(F, dtype=float))
    gv = jnp.asarray(np.asarray(g, dtype=float).reshape(-1))
    n = Fm.shape[1]
    if Fm.shape[0] != sum(K) or gv.shape[0] != sum(K):
        raise ValueError("rows of F and g must equal sum(K)")
    mnl = len(K) - 1
    ofs = np.concatenate([[0], np.cumsum(K)]).astype(int)

    def F_gp(x=None, z=None):
        if x is None:
            return mnl, jnp.zeros((n,), Fm.dtype)
        x = jnp.asarray(x, Fm.dtype)
        y = Fm @ x + gv
        vals, grads, hesss = [], [], []
        for i in range(mnl + 1):
            yi = y[ofs[i]:ofs[i + 1]]
            Fi = Fm[ofs[i]:ofs[i + 1], :]
            ymax = jnp.max(yi)
            w = jnp.exp(yi - ymax)
            tot = jnp.sum(w)
            vals.append(ymax + jnp.log(tot))
            w = w / tot
            grads.append(Fi.T @ w)
            if z is not None:
                Fw = Fi * w[:, None]
                Hi = Fi.T @ Fw - jnp.outer(Fi.T @ w, Fi.T @ w)
                hesss.append(Hi)
        f = jnp.stack(vals)
        Df = jnp.stack(grads)
        if z is None:
            return f, Df
        H = sum(jnp.asarray(z)[i] * hesss[i] for i in range(mnl + 1))
        return f, Df, H

    return cp(F_gp, G, h, None, A, b, kktsolver=kktsolver, options=options)
