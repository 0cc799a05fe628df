"""conelp: cone LP via the extended self-dual embedding, plus the
natural-form wrappers lp/socp/sdp.

Reference semantics: src/python/coneprog.py conelp :31 (self-dual embedding
with tau/kappa, Mehrotra predictor-corrector, infeasibility certificates),
lp :2550, socp :3044, sdp :3597.  See coneprog.py in this package for the
architectural notes; conelp shares the functional lax.while_loop design of
coneqp with two extra scalar variables (tau, kappa) and the certificate
logic of the embedding.

Newton system solved each step (f6 in the reference, coneprog.py:1130):

    A'dy + G'dz + c dtau                  = bx
    A dx - b dtau                          = by
    G dx + ds - h dtau                     = bz
    c'dx + b'dy + h'dz + dkappa            = bt
    lambda o (W^{-T}ds + W dz)             = d_s
    kappa dtau + tau dkappa                = d_kappa

reduced onto the 3x3 KKT factorization by eliminating ds and dkappa and
expanding (dx,dy,dz) = (xt,yt,zt) + dtau*(x1,y1,z1) with (x1,y1,z1) =
K^{-1}(-c, b, h) precomputed once per factorization.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from .. import cones, kkt
from ..cones import ConeDims
from .coneprog import (
    RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR,
    _STATUS_STR, STEP, EXPON, Options, _resolve_options, _asarray, _relgap,
    VecOps, DEFAULT_VECOPS, _make_vecops, _tree_select, _tree_scal,
    _tree_dot, _empty_vec, _empty_mat)


def conelp(c, G, h, dims=None, A=None, b=None, primalstart=None,
           dualstart=None, kktsolver=None, options=None, xnewcopy=None,
           xdot=None, xscal=None, xaxpy=None, ynewcopy=None, ydot=None,
           yscal=None, yaxpy=None):
    """Solve the cone LP pair (reference coneprog.py:31)

        minimize  c'x                 maximize  -h'z - b'y
        s.t.      G x + s = h         s.t.      G'z + A'y + c = 0
                  A x = b                       z >= 0
                  s >= 0

    returning the reference's result dict including infeasibility
    certificates: on 'primal infeasible', (y, z) certify h'z + b'y = -1,
    G'z + A'y = 0, z >= 0; on 'dual infeasible', (x, s) certify c'x = -1,
    Gx + s = 0, Ax = 0, s >= 0.

    Custom vector spaces (reference coneprog.py:378-402): passing any of
    xnewcopy/xdot/xscal/xaxpy (resp. the y* variants) makes x and c (resp.
    y and b) abstract pytrees; G (and A) must then be operators and
    kktsolver a custom factor.  Hooks are pure jax-traceable functions —
    see `solvers.coneqp` for the exact functional signatures.
    """
    from .coneprog import _profile_ctx
    with _profile_ctx(options):
        return _conelp(c, G, h, dims, A, b, primalstart, dualstart,
                       kktsolver, options, xnewcopy, xdot, xscal, xaxpy,
                       ynewcopy, ydot, yscal, yaxpy)


def _conelp(c, G, h, dims, A, b, primalstart, dualstart, kktsolver,
            options, xnewcopy, xdot, xscal, xaxpy, ynewcopy, ydot, yscal,
            yaxpy):
    o, dtype, merged = _resolve_options(options)
    custom_x = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy))
    custom_y = any(f is not None for f in (ynewcopy, ydot, yscal, yaxpy))
    xops = _make_vecops(xnewcopy, xdot, xscal, xaxpy)
    yops = _make_vecops(ynewcopy, ydot, yscal, yaxpy)
    if custom_x and not (callable(G) and callable(kktsolver)):
        raise ValueError("custom x vector space requires operator-form G "
                         "and a custom kktsolver")
    if custom_y and not (A is not None and callable(A) and b is not None):
        raise ValueError("custom y vector space requires operator-form A "
                         "and b")

    if not custom_x:
        c = _asarray(c, dtype, name="c")
        n = c.shape[0]
    else:
        n = None
    if dims is None:
        dims = ConeDims(l=int(np.asarray(h).size))
    dims = ConeDims.from_dict(dims)
    if dims.degree == 0:
        raise ValueError("the cone must be nonempty")
    h = _asarray(h, dtype, shape=(dims.size,), name="h")
    has_y = 1
    if not custom_y:
        b = _asarray(b, dtype, name="b") if b is not None else _empty_vec(dtype)
        has_y = b.shape[0]

    G_is_op = callable(G)
    A_is_op = A is not None and callable(A)
    Ga = None if G_is_op else _asarray(G, dtype, shape=(dims.size, n),
                                       name="G")
    Aa = None
    if not A_is_op:
        Aa = (_empty_mat(n, dtype) if A is None and n is not None
              else _asarray(A, dtype, name="A"))

    if kktsolver is None:
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    if isinstance(kktsolver, str) and (G_is_op or A_is_op):
        raise ValueError("operator-form G/A require a custom kktsolver")

    ps = None
    if primalstart is not None:
        px = (primalstart["x"] if custom_x
              else _asarray(primalstart["x"], dtype))
        ps = (px, _asarray(primalstart["s"], dtype))
    dst = None
    if dualstart is not None:
        if custom_y:
            dy = dualstart.get("y")
        else:
            dy = (_asarray(dualstart.get("y"), dtype)
                  if dualstart.get("y") is not None
                  else _empty_vec(dtype))
        dst = (dy, _asarray(dualstart["z"], dtype))

    o = o.resolve_refinement(dims, kktsolver)
    # fast path: standard array inputs reuse a cached jitted solver (no
    # retracing on repeated same-shape solves); its errors propagate
    if (isinstance(kktsolver, str) and not (G_is_op or A_is_op)
            and ps is None and dst is None and not (custom_x or custom_y)):
        from .coneprog import _cached_lp_solver_full
        solve_fn = _cached_lp_solver_full(dims, kktsolver, o)
        return _conelp_result_from_pack(solve_fn(c, Ga, h, Aa, b), dims)

    # non-fast paths (custom kktsolver / operators / warm starts): apply
    # the s-block storage convention eagerly, then build the factor from
    # the symmetrized data
    h = cones.sym_from_lower(dims, h)
    if Ga is not None:
        Ga = cones.sym_from_lower_cols(dims, Ga)
    if isinstance(kktsolver, str):
        factor = kkt.make_kkt_solver(kktsolver, dims, Ga, Aa, None,
                                     reg=o.kktreg, ozaki=o.ozaki,
                                     facref=o.facref)
    else:
        factor = kktsolver
    gmv = G if G_is_op else (lambda x, trans=False:
                             (Ga.T @ x if trans else Ga @ x))
    amv = A if A_is_op else (lambda x, trans=False:
                             (Aa.T @ x if trans else Aa @ x))
    state = _conelp_core(c, Ga, h, Aa, b, dims, o, factor, gmv, amv,
                         dtype, ps, dst, xops=xops, yops=yops,
                         has_y=(has_y if (custom_x or custom_y) else None))
    return _conelp_result(state, c, h, b, dims,
                          xops=xops, yops=yops,
                          has_y=(has_y if (custom_x or custom_y) else None))


def _conelp_core(c, Ga, h, Aa, b, dims, o: Options, factor, gmv, amv,
                 dtype, primalstart, dualstart,
                 xops: VecOps = DEFAULT_VECOPS,
                 yops: VecOps = DEFAULT_VECOPS, has_y=None):
    """Pure, jit-traceable conelp driver: the self-dual-embedding IPM as
    one lax.while_loop; returns the final state arrays (no host syncs).

    x and y live in abstract vector spaces given by `xops`/`yops`
    (reference coneprog.py:378-402); the defaults handle arrays and
    arbitrary pytrees."""
    p = has_y if has_y is not None else b.shape[0]
    deg = dims.degree
    e = cones.cone_e(dims, dtype)

    resx0 = jnp.maximum(1.0, xops.norm(c))
    resy0 = jnp.maximum(1.0, yops.norm(b)) if p else jnp.asarray(
        1.0, dtype)
    resz0 = jnp.maximum(1.0, cones.snrm2(dims, h))

    def initial_point():
        W0 = cones.identity_scaling(dims, dtype)
        solve0 = factor(W0)
        if primalstart is None and dualstart is None:
            # common path: one batched eigendecomposition for both
            # boundary distances
            x0, _, z0p = solve0(xops.zero(c), b, h)
            s0 = -z0p
            x1, y0, z0 = solve0(xops.scal(-1.0, c), yops.zero(b),
                                jnp.zeros((dims.size,), dtype))
            ts, tz = cones.max_step2(dims, s0, z0)
            s0 = jnp.where(ts >= -1e-8 * jnp.maximum(1.0, jnp.abs(ts)),
                           s0 + (1.0 + ts) * e, s0)
            z0 = jnp.where(tz >= -1e-8 * jnp.maximum(1.0, jnp.abs(tz)),
                           z0 + (1.0 + tz) * e, z0)
            return x0, y0, s0, z0
        if primalstart is None:
            x0, _, z0 = solve0(xops.zero(c), b, h)
            s0 = -z0
            ts = cones.max_step(dims, s0)
            s0 = jnp.where(ts >= -1e-8 * jnp.maximum(1.0, jnp.abs(ts)),
                           s0 + (1.0 + ts) * e, s0)
        else:
            x0, s0 = primalstart
        if dualstart is None:
            x1, y0, z0 = solve0(xops.scal(-1.0, c), yops.zero(b),
                                jnp.zeros((dims.size,), dtype))
            tz = cones.max_step(dims, z0)
            z0 = jnp.where(tz >= -1e-8 * jnp.maximum(1.0, jnp.abs(tz)),
                           z0 + (1.0 + tz) * e, z0)
        else:
            y0, z0 = dualstart
        return x0, y0, s0, z0

    def residuals(x, y, s, z, tau, kappa):
        # rx = G'z + A'y + tau c   (x-space)
        rx = xops.axpy(gmv(z, trans=True), xops.scal(tau, c))
        if p:
            rx = xops.axpy(amv(y, trans=True), rx)
        # ry = A x - tau b          (y-space)
        ry = yops.axpy(b, amv(x), -tau) if p else b
        rz = gmv(x) + s - h * tau
        rt = kappa + xops.dot(c, x) + (yops.dot(b, y) if p else 0.0) + \
            cones.sdot(dims, h, z)
        return rx, ry, rz, rt

    def metrics_of(x, y, s, z, tau, kappa):
        rx, ry, rz, rt = residuals(x, y, s, z, tau, kappa)
        gap = cones.sdot(dims, s, z) / (tau * tau)
        pcost = xops.dot(c, x) / tau
        dcost = -(cones.sdot(dims, h, z) +
                  (yops.dot(b, y) if p else 0.0)) / tau
        pres = jnp.maximum(
            (yops.norm(ry) / resy0 if p else 0.0),
            cones.snrm2(dims, rz) / resz0) / tau
        dres = xops.norm(rx) / resx0 / tau
        # infeasibility certificates
        hz_by = cones.sdot(dims, h, z) + (yops.dot(b, y) if p else 0.0)
        cx = xops.dot(c, x)
        # || G'z + A'y || / resx0 scaled by -1/(h'z+b'y) when h'z+b'y < 0
        hrx = gmv(z, trans=True)
        if p:
            hrx = xops.axpy(amv(y, trans=True), hrx)
        pinfres = jnp.where(
            hz_by < 0.0, xops.norm(hrx) / resx0 / (-hz_by), jnp.inf)
        hry = amv(x) if p else b
        hrz = gmv(x) + s
        dinfres = jnp.where(
            cx < 0.0,
            jnp.maximum(yops.norm(hry) / resy0 if p else 0.0,
                        cones.snrm2(dims, hrz) / resz0) / (-cx),
            jnp.inf)
        return (rx, ry, rz, rt,
                dict(pcost=pcost, dcost=dcost, gap=gap,
                     relgap=_relgap(gap, pcost, dcost),
                     pres=pres, dres=dres, pinfres=pinfres,
                     dinfres=dinfres))

    def f6_factory(solve, lmbda, W, tau, kappa):
        # (x1,y1,z1) = K^{-1}(-c, b, h), once per factorization
        x1, y1, z1 = solve(xops.scal(-1.0, c), b, h)
        dg = xops.dot(c, x1) + (yops.dot(b, y1) if p else 0.0) + \
            cones.sdot(dims, h, z1) - kappa / tau

        def f6_no_ir(bx, by, bz, bt, d_s, d_k):
            tmp = cones.sinv(dims, lmbda, d_s)
            bzt = bz - cones.scale(dims, W, tmp, trans=True)
            xt, yt, zt = solve(bx, by, bzt)
            btt = bt - d_k / tau
            num = btt - (xops.dot(c, xt) +
                         (yops.dot(b, yt) if p else 0.0) +
                         cones.sdot(dims, h, zt))
            dtau = num / dg
            dx = xops.axpy(x1, xt, dtau)
            dy = yops.axpy(y1, yt, dtau) if p else yt
            dz = zt + dtau * z1
            ds = cones.scale(dims, W,
                             tmp - cones.scale(dims, W, dz), trans=True)
            dk = (d_k - kappa * dtau) / tau
            return dx, dy, dz, dtau, ds, dk

        def f6(bx, by, bz, bt, d_s, d_k):
            d0 = f6_no_ir(bx, by, bz, bt, d_s, d_k)
            if not o.refinement:
                return d0

            def refine(i, d):
                dx, dy, dz, dtau, ds, dk = d
                # r1 = bx - (G'dz + A'dy + dtau c)
                t = xops.axpy(gmv(dz, trans=True), xops.scal(dtau, c))
                if p:
                    t = xops.axpy(amv(dy, trans=True), t)
                r1 = xops.axpy(t, bx, -1.0)
                # r2 = by - (A dx - dtau b)
                if p:
                    r2 = yops.axpy(yops.axpy(b, amv(dx), -dtau), by, -1.0)
                else:
                    r2 = by
                r3 = bz - (gmv(dx) + ds - h * dtau)
                r4 = bt - (xops.dot(c, dx) +
                           (yops.dot(b, dy) if p else 0.0) +
                           cones.sdot(dims, h, dz) + dk)
                r5 = d_s - cones.sprod(
                    dims, lmbda,
                    cones.scale(dims, W, ds, trans=True, inverse=True) +
                    cones.scale(dims, W, dz), diag=True)
                r6 = d_k - (kappa * dtau + tau * dk)
                ex, ey, ez, et, es, ek = f6_no_ir(r1, r2, r3, r4, r5, r6)
                dx = xops.axpy(ex, dx)
                dy = yops.axpy(ey, dy) if p else dy
                return (dx, dy, dz + ez, dtau + et, ds + es, dk + ek)

            # fori_loop: one instance of the 6-var solve subgraph for all
            # refinement passes (compile-time control)
            return jax.lax.fori_loop(0, o.refinement, refine, d0)

        return f6

    def body(carry):
        x, y, s, z, tau, kappa, it, status, m = carry
        rx, ry, rz, rt, m = metrics_of(x, y, s, z, tau, kappa)
        if o.show_progress:
            jax.debug.print(
                "{it:2d}: {pc: .4e} {dc: .4e} {gap: .0e} {pr: .0e} "
                "{dr: .0e} {kt: .0e}",
                it=it, pc=m["pcost"], dc=m["dcost"], gap=m["gap"],
                pr=m["pres"], dr=m["dres"], kt=kappa / tau)
        converged = (m["pres"] <= o.feastol) & (m["dres"] <= o.feastol) & (
            (m["gap"] <= o.abstol) | (jnp.isfinite(m["relgap"]) &
                                      (m["relgap"] <= o.reltol)))
        pinf = m["pinfres"] <= o.feastol
        dinf = m["dinfres"] <= o.feastol
        new_status = jnp.where(
            converged, OPTIMAL,
            jnp.where(pinf, PRIMAL_INFEASIBLE,
                      jnp.where(dinf, DUAL_INFEASIBLE,
                                jnp.where(it >= o.maxiters, UNKNOWN,
                                          RUNNING)))).astype(jnp.int32)

        def do_step(args):
            x, y, s, z, tau, kappa = args
            W, lmbda = cones.compute_scaling(dims, s, z)
            solve = factor(W)
            f6 = f6_factory(solve, lmbda, W, tau, kappa)
            lmbdasq = cones.ssqr(dims, lmbda)
            mu = (cones.sdot(dims, lmbda, lmbda) + tau * kappa) / (deg + 1)

            # Mehrotra predictor (i=0) then corrector (i=1) as one
            # lax.scan so the 6-var solve subgraph is instanced once
            # (compile-time control); step-limit quantities ride the
            # carry between the phases.
            def phase(carry, i):
                (dxp, dyp, dzp, dtp, dsp, dkp,
                 dsw_p, dzw_p, tlim_p) = carry

                # arithmetic select instead of lax.cond: both phase rhs
                # are cheap, and cond nested in scan nested in while_loop
                # compiles slowly.  At i=0 the carry is all-zero, so the
                # combined expression is finite and simply discarded by
                # the select.
                step_a = jnp.minimum(1.0, tlim_p)
                sigma = jnp.clip(1.0 - step_a, 0.0, 1.0) ** EXPON
                d_s_c = -lmbdasq - cones.sprod(dims, dsw_p, dzw_p) + \
                    sigma * mu * e
                d_k_c = -tau * kappa - dtp * dkp + sigma * mu
                is_aff = i == 0
                r = jnp.where(is_aff, 1.0, 1.0 - sigma)
                d_s = jnp.where(is_aff, -lmbdasq, d_s_c)
                d_k = jnp.where(is_aff, -tau * kappa, d_k_c)
                dx, dy, dz, dt, ds, dk = f6(
                    xops.scal(-r, rx), yops.scal(-r, ry), -r * rz,
                    -r * rt, d_s, d_k)
                ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
                dz_w = cones.scale(dims, W, dz)
                t_cone = 1.0 / jnp.maximum(
                    _inv_step(dims, lmbda, ds_w, dz_w), 1e-30)
                tlim = jnp.minimum(t_cone, _tk_step(tau, kappa, dt, dk))
                return (dx, dy, dz, dt, ds, dk, ds_w, dz_w, tlim), None

            zero_carry = (xops.zero(x), yops.zero(y), jnp.zeros_like(z),
                          jnp.zeros_like(tau), jnp.zeros_like(s),
                          jnp.zeros_like(kappa), jnp.zeros_like(s),
                          jnp.zeros_like(z), jnp.zeros_like(tau))
            (dx, dy, dz, dt, ds, dk, _, _, tlim), _ = jax.lax.scan(
                phase, zero_carry, jnp.arange(2))
            step = jnp.minimum(STEP * tlim, 1.0)

            xn = xops.axpy(dx, x, step)
            yn = yops.axpy(dy, y, step) if p else y
            sn, zn = s + step * ds, z + step * dz
            tn, kn = tau + step * dt, kappa + step * dk
            bad = ~jnp.isfinite(xops.dot(xn, xn) + jnp.dot(sn, sn) +
                                jnp.dot(zn, zn) + tn + kn) | (tn <= 0)
            st = jnp.where(bad, jnp.int32(SINGULAR), jnp.int32(RUNNING))
            pick = lambda new, old: _tree_select(bad, old, new)
            return (pick(xn, x), pick(yn, y), pick(sn, s), pick(zn, z),
                    pick(tn, tau), pick(kn, kappa), st)

        def no_step(args):
            x, y, s, z, tau, kappa = args
            return x, y, s, z, tau, kappa, new_status

        xn, yn, sn, zn, tn, kn, st = jax.lax.cond(
            new_status == RUNNING, do_step, no_step,
            (x, y, s, z, tau, kappa))
        return xn, yn, sn, zn, tn, kn, it + 1, st, m

    def cond(carry):
        return carry[7] == RUNNING

    if o.show_progress:
        print("     pcost       dcost       gap    pres   dres   k/t")
    x0, y0, s0, z0 = initial_point()
    tau0 = jnp.asarray(1.0, dtype)
    kappa0 = jnp.asarray(1.0, dtype)
    _, _, _, _, m0 = metrics_of(x0, y0, s0, z0, tau0, kappa0)
    carry0 = (x0, y0, s0, z0, tau0, kappa0, jnp.int32(0),
              jnp.int32(RUNNING), m0)
    return jax.lax.while_loop(cond, body, carry0)


def _finalize_pack(state, c, h, b, dims):
    """Jit-traceable result post-processing: computes, branch-free, every
    array `_conelp_result` needs — the per-status iterate scalings
    (1/tau for optimal/unknown, certificate scalings on infeasible) and
    the boundary distances — so the whole solve + finalize is ONE
    compiled program instead of a dozen small eager ones."""
    x, y, s, z, tau, kappa, it, status, m = state
    cx = jnp.dot(c, x)
    hz_by = cones.sdot(dims, h, z) + (jnp.dot(b, y) if b.shape[0]
                                      else 0.0)
    inv_tau = 1.0 / tau
    scale_x = jnp.where(status == DUAL_INFEASIBLE,
                        -1.0 / cx, inv_tau)
    scale_yz = jnp.where(status == PRIMAL_INFEASIBLE,
                         -1.0 / hz_by, inv_tau)
    xs, ss = x * scale_x, s * scale_x
    ys, zs = y * scale_yz, z * scale_yz
    ts, tz = cones.max_step2(dims, ss, zs)
    # all scalar outputs ride ONE vector: the result-dict build fetches
    # 5 leaves instead of ~17 (each tiny-leaf device_get costs ~30 us
    # of conversion overhead — measured ~0.9 ms/solve on the 2 ms warm
    # userguide SDP before this)
    meta = jnp.stack([
        -ts, -tz, tau, it.astype(x.dtype), status.astype(x.dtype),
        m["pcost"], m["dcost"], m["gap"], m["relgap"], m["pres"],
        m["dres"], m["pinfres"], m["dinfres"]])
    return dict(x=xs, y=ys, s=ss, z=zs, meta=meta)


def _conelp_result_from_pack(pack, dims):
    """Build the reference's result dict from a fetched finalize pack
    (no device math on this path)."""
    pack = jax.device_get(pack)
    (slack_s, slack_z, tau, it, statusf, pcost, dcost, gap, relgap,
     pres, dres, pinfres, dinfres) = (float(v) for v in pack["meta"])
    status = int(statusf)
    res = {"status": _STATUS_STR.get(status, "unknown"),
           "iterations": int(it) - 1}
    metrics = {
        "primal objective": pcost,
        "dual objective": dcost,
        "gap": gap,
        "relative gap": relgap if math.isfinite(relgap) else None,
        "primal infeasibility": pres,
        "dual infeasibility": dres,
        "residual as primal infeasibility certificate":
            pinfres if math.isfinite(pinfres) else None,
        "residual as dual infeasibility certificate":
            dinfres if math.isfinite(dinfres) else None,
    }
    if status == PRIMAL_INFEASIBLE:
        res.update(x=None, s=None, y=pack["y"], z=pack["z"])
        metrics.update({"primal objective": None, "gap": None,
                        "relative gap": None, "dual objective": 1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "primal slack": None,
                        "dual slack": slack_z})
    elif status == DUAL_INFEASIBLE:
        res.update(x=pack["x"], s=pack["s"], y=None, z=None)
        metrics.update({"dual objective": None, "gap": None,
                        "relative gap": None, "primal objective": -1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "dual slack": None,
                        "primal slack": slack_s})
    else:
        res.update(x=pack["x"], s=pack["s"], y=pack["y"], z=pack["z"])
        metrics["primal slack"] = slack_s
        metrics["dual slack"] = slack_z
    res.update(metrics)
    return res


def _conelp_result(state, c, h, b, dims, xops: VecOps = DEFAULT_VECOPS,
                   yops: VecOps = DEFAULT_VECOPS, has_y=None):
    """Host-side conversion of the final state into the reference's
    result dict (certificate scaling, status strings)."""
    x, y, s, z, tau, kappa, it, status, m = state
    p = has_y if has_y is not None else b.shape[0]
    status = int(status)
    iterations = int(it) - 1

    # scale the returned iterates per the reference's conventions
    res = {"status": _STATUS_STR.get(status, "unknown"),
           "iterations": iterations}
    relgap = float(m["relgap"])
    pinfres = float(m["pinfres"])
    dinfres = float(m["dinfres"])
    metrics = {
        "primal objective": float(m["pcost"]),
        "dual objective": float(m["dcost"]),
        "gap": float(m["gap"]),
        "relative gap": relgap if math.isfinite(relgap) else None,
        "primal infeasibility": float(m["pres"]),
        "dual infeasibility": float(m["dres"]),
        "residual as primal infeasibility certificate":
            pinfres if math.isfinite(pinfres) else None,
        "residual as dual infeasibility certificate":
            dinfres if math.isfinite(dinfres) else None,
    }
    if status == PRIMAL_INFEASIBLE:
        hz_by = float(cones.sdot(dims, h, z) +
                      (yops.dot(b, y) if p else 0.0))
        scale_cert = -1.0 / hz_by
        res.update(x=None, s=None, y=yops.scal(scale_cert, y),
                   z=z * scale_cert)
        metrics.update({"primal objective": None, "gap": None,
                        "relative gap": None,
                        "dual objective": 1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "primal slack": None,
                        "dual slack": -float(cones.max_step(
                            dims, z * scale_cert))})
    elif status == DUAL_INFEASIBLE:
        cx = float(xops.dot(c, x))
        scale_cert = -1.0 / cx
        res.update(x=xops.scal(scale_cert, x), s=s * scale_cert, y=None,
                   z=None)
        metrics.update({"dual objective": None, "gap": None,
                        "relative gap": None,
                        "primal objective": -1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "dual slack": None,
                        "primal slack": -float(cones.max_step(
                            dims, s * scale_cert))})
    else:
        tauf = float(tau)
        res.update(x=xops.scal(1.0 / tauf, x), s=s / tauf,
                   y=yops.scal(1.0 / tauf, y), z=z / tauf)
        metrics["primal slack"] = -float(cones.max_step(dims, s)) / tauf
        metrics["dual slack"] = -float(cones.max_step(dims, z)) / tauf
    res.update(metrics)
    return res


def _inv_step(dims, lmbda, ds_w, dz_w):
    """max(ts, tz, 0): reciprocal of the max feasible cone step (one
    batched eigendecomposition for both directions)."""
    ts, tz = cones.max_step2(dims, cones.scale2(dims, lmbda, ds_w),
                             cones.scale2(dims, lmbda, dz_w))
    return jnp.maximum(jnp.maximum(ts, tz), 0.0)


def _tk_step(tau, kappa, dt, dk):
    """max feasible step keeping tau, kappa > 0."""
    t_tau = jnp.where(dt < 0, -tau / dt, jnp.inf)
    t_kap = jnp.where(dk < 0, -kappa / dk, jnp.inf)
    return jnp.minimum(t_tau, t_kap)


# ---------------------------------------------------------------------------
# Natural-form wrappers (reference coneprog.py lp:2550, socp:3044, sdp:3597)
# ---------------------------------------------------------------------------


def _ruiz_equilibrate(c, G, h, A, b, iters=6):
    """Ruiz equilibration of an LP: returns scaled data plus the row/col
    scalings (dr, dc) with G' = diag(dr) G diag(dc).  l-cone only."""
    G = np.asarray(G, dtype=float)
    c = np.asarray(c, dtype=float).reshape(-1)
    h = np.asarray(h, dtype=float).reshape(-1)
    m, n = G.shape
    Aa = np.asarray(A, dtype=float).reshape(-1, n) if A is not None \
        else np.zeros((0, n))
    dr = np.ones(m)
    dra = np.ones(Aa.shape[0])
    dc = np.ones(n)
    Gs, As = G.copy(), Aa.copy()
    for _ in range(iters):
        rmax = np.maximum(np.abs(Gs).max(axis=1), 1e-12)
        ramax = np.maximum(np.abs(As).max(axis=1), 1e-12) \
            if len(As) else np.ones(0)
        stacked = np.vstack([Gs, As]) if len(As) else Gs
        cmax = np.maximum(np.abs(stacked).max(axis=0), 1e-12)
        sr = 1.0 / np.sqrt(rmax)
        sra = 1.0 / np.sqrt(ramax)
        sc = 1.0 / np.sqrt(cmax)
        Gs = Gs * sr[:, None] * sc[None, :]
        if len(As):
            As = As * sra[:, None] * sc[None, :]
        dr *= sr
        dra *= sra
        dc *= sc
    return (c * dc, Gs, h * dr,
            As if A is not None else None,
            (np.asarray(b, dtype=float).reshape(-1) * dra
             if b is not None else None),
            dr, dra, dc)


def _np_slack(s, ml, mq):
    """-max_step over an l/q cone layout: min margin to the boundary
    (reference misc.max_step via coneprog.py:2965-2966)."""
    vals = []
    if ml:
        vals.append(np.min(s[:ml]))
    ofs = ml
    for k in mq:
        blk = s[ofs:ofs + k]
        vals.append(blk[0] - np.linalg.norm(blk[1:]))
        ofs += k
    return float(min(vals)) if vals else None


def _bridge_cone_result(status, x, z, y, c, G, h, A, b, ml, mq, P=None):
    """Map a generic bridge return (status string, x, z, y) onto the
    reference's solution dict — the shared result math of the reference's
    external-solver dispatch (coneprog.py:4427-4560, same computations for
    gurobi as for mosek)."""
    c = np.asarray(c, dtype=float).reshape(-1)
    h = (np.asarray(h, dtype=float).reshape(-1) if h is not None
         else np.zeros(0))
    Gm = (np.asarray(G, dtype=float).reshape(len(h), -1) if G is not None
          else np.zeros((0, len(c))))
    n = len(c)
    Am = (np.asarray(A, dtype=float).reshape(-1, n)
          if A is not None else np.zeros((0, n)))
    bv = (np.asarray(b, dtype=float).reshape(-1)
          if b is not None else np.zeros(0))
    Pm = (np.asarray(P, dtype=float).reshape(n, n)
          if P is not None else None)
    resx0 = max(1.0, np.linalg.norm(c))
    resy0 = max(1.0, np.linalg.norm(bv))
    resz0 = max(1.0, np.linalg.norm(h))
    sol = dict.fromkeys((
        "x", "s", "y", "z", "primal objective", "dual objective", "gap",
        "relative gap", "primal infeasibility", "dual infeasibility",
        "residual as primal infeasibility certificate",
        "residual as dual infeasibility certificate",
        "primal slack", "dual slack"))
    sol["status"] = status
    if status != "optimal" or x is None:
        return sol
    xv = np.asarray(x, dtype=float).reshape(-1)
    zv = (np.asarray(z, dtype=float).reshape(-1) if z is not None
          else np.zeros(len(h)))
    yv = (np.asarray(y, dtype=float).reshape(-1) if y is not None
          else np.zeros(Am.shape[0]))
    sv = h - Gm @ xv
    quad = 0.5 * xv @ Pm @ xv if Pm is not None else 0.0
    pcost = float(c @ xv + quad)
    dcost = float(-h @ zv - bv @ yv - quad)
    gap = float(sv @ zv)
    rx = c + Gm.T @ zv + Am.T @ yv
    if Pm is not None:
        rx = rx + Pm @ xv
    resx = np.linalg.norm(rx) / resx0
    resy = np.linalg.norm(bv - Am @ xv) / resy0
    resz = np.linalg.norm(Gm @ xv + sv - h) / resz0
    sol.update({
        "x": xv, "s": sv, "y": yv, "z": zv,
        "primal objective": pcost, "dual objective": dcost,
        "gap": gap,
        "relative gap": (gap / -pcost if pcost < 0.0 else
                         gap / dcost if dcost > 0.0 else None),
        "primal infeasibility": float(max(resy, resz)),
        "dual infeasibility": float(resx),
        "primal slack": _np_slack(sv, ml, mq),
        "dual slack": _np_slack(zv, ml, mq)})
    return sol


def _mosek_cone_result(solsta, x, z, y, c, G, h, A, b, ml, mq, P=None):
    """Map a MOSEK bridge return (solsta, x, z, y) onto the reference's
    solution dict, including residuals, slacks, and scaled infeasibility
    certificates (reference coneprog.py:2923-3036 for lp, :4432-4560 for
    qp, :3399-3520 for socp)."""
    import mosek

    c = np.asarray(c, dtype=float).reshape(-1)
    h = np.asarray(h, dtype=float).reshape(-1)
    Gm = np.asarray(G, dtype=float).reshape(len(h), -1)
    m, n = Gm.shape
    Am = (np.asarray(A, dtype=float).reshape(-1, n)
          if A is not None else np.zeros((0, n)))
    bv = (np.asarray(b, dtype=float).reshape(-1)
          if b is not None else np.zeros(0))
    Pm = (np.asarray(P, dtype=float).reshape(n, n)
          if P is not None else None)
    resx0 = max(1.0, np.linalg.norm(c))
    resy0 = max(1.0, np.linalg.norm(bv))
    resz0 = max(1.0, np.linalg.norm(h))
    sol = dict.fromkeys((
        "x", "s", "y", "z", "primal objective", "dual objective", "gap",
        "relative gap", "primal infeasibility", "dual infeasibility",
        "residual as primal infeasibility certificate",
        "residual as dual infeasibility certificate",
        "primal slack", "dual slack"))

    near_opt = getattr(mosek.solsta, "near_optimal", None)
    if solsta in (mosek.solsta.optimal, near_opt):
        sol["status"] = ("optimal" if solsta is mosek.solsta.optimal
                         else "near optimal")
        xv = np.asarray(x, dtype=float).reshape(-1)
        zv = np.asarray(z, dtype=float).reshape(-1)
        yv = (np.asarray(y, dtype=float).reshape(-1)
              if y is not None else np.zeros(0))
        sv = h - Gm @ xv
        quad = 0.5 * xv @ Pm @ xv if Pm is not None else 0.0
        pcost = float(c @ xv + quad)
        dcost = float(-h @ zv - bv @ yv - quad)
        gap = float(sv @ zv)
        rx = c + Gm.T @ zv + Am.T @ yv
        if Pm is not None:
            rx = rx + Pm @ xv
        resx = np.linalg.norm(rx) / resx0
        resy = np.linalg.norm(bv - Am @ xv) / resy0
        resz = np.linalg.norm(Gm @ xv + sv - h) / resz0
        sol.update({
            "x": xv, "s": sv, "y": yv, "z": zv,
            "primal objective": pcost, "dual objective": dcost,
            "gap": gap,
            "relative gap": (gap / -pcost if pcost < 0.0 else
                             gap / dcost if dcost > 0.0 else None),
            "primal infeasibility": float(max(resy, resz)),
            "dual infeasibility": float(resx),
            "primal slack": _np_slack(sv, ml, mq),
            "dual slack": _np_slack(zv, ml, mq)})
    elif solsta is mosek.solsta.prim_infeas_cer:
        sol["status"] = "primal infeasible"
        zv = np.asarray(z, dtype=float).reshape(-1)
        yv = (np.asarray(y, dtype=float).reshape(-1)
              if y is not None else np.zeros(0))
        scal = 1.0 / (-h @ zv - bv @ yv)
        zv, yv = zv * scal, yv * scal
        sol.update({
            "y": yv, "z": zv, "dual objective": 1.0,
            "residual as primal infeasibility certificate": float(
                np.linalg.norm(-Am.T @ yv - Gm.T @ zv) / resx0),
            "dual slack": _np_slack(zv, ml, mq)})
    elif solsta == mosek.solsta.dual_infeas_cer:
        sol["status"] = "dual infeasible"
        xv = np.asarray(x, dtype=float).reshape(-1)
        xv = xv * (-1.0 / float(c @ xv))
        sv = -Gm @ xv
        resy = np.linalg.norm(Am @ xv) / resy0
        resz = np.linalg.norm(Gm @ xv + sv) / resz0
        sol.update({
            "x": xv, "s": sv, "primal objective": -1.0,
            "residual as dual infeasibility certificate": float(
                max(resy, resz)),
            "primal slack": _np_slack(sv, ml, mq)})
    else:
        sol["status"] = "unknown"
    return sol


def _dsdp_result(dsdpstatus, x, zl, zs, c, Gl, hl, Gs, hs):
    """Full result-dict mapping for solvers.sdp(solver='dsdp') — the
    reference's DSDP branch (coneprog.py:3924-4113): status translation,
    certificate scaling, residuals, slacks, and the complete key set."""
    c = np.asarray(c, dtype=float).reshape(-1)
    n = len(c)
    ml = 0 if hl is None else int(np.asarray(hl).size)
    Glm = (np.asarray(Gl, dtype=float).reshape(ml, n) if ml
           else np.zeros((0, n)))
    hlv = (np.asarray(hl, dtype=float).reshape(-1) if ml
           else np.zeros(0))
    Gs = Gs or []
    hs = hs or []
    ms = [int(np.asarray(hk).shape[0]) for hk in hs]
    Gsm = [np.asarray(Gk, dtype=float).reshape(m * m, n)
           for Gk, m in zip(Gs, ms)]
    hsm = [np.asarray(hk, dtype=float).reshape(m, m)
           for hk, m in zip(hs, ms)]

    resx0 = max(1.0, np.linalg.norm(c))
    rh = [np.linalg.norm(hlv)] + [np.linalg.norm(hk) for hk in hsm]
    resz0 = max(1.0, np.linalg.norm(rh))

    def _slack(sl_, ss_):
        vals = ([float(np.min(sl_))] if ml else []) + \
            [float(np.linalg.eigvalsh(0.5 * (S + S.T))[0]) for S in ss_]
        return min(vals) if vals else None

    def _gxT(zl_, zs_):
        """G'z over the l/s blocks (full symmetric storage)."""
        out = (Glm.T @ zl_ if ml else np.zeros(n))
        for Gk, Z in zip(Gsm, zs_):
            out = out + Gk.T @ Z.reshape(-1)
        return out

    def _gx(x_):
        """(Gl x, [mat(Gs_k x)])"""
        sl_ = Glm @ x_ if ml else np.zeros(0)
        ss_ = [(Gk @ x_).reshape(m, m) for Gk, m in zip(Gsm, ms)]
        return sl_, ss_

    keys = ("x", "sl", "ss", "y", "zl", "zs", "primal objective",
            "dual objective", "gap", "relative gap",
            "primal infeasibility", "dual infeasibility",
            "residual as primal infeasibility certificate",
            "residual as dual infeasibility certificate",
            "primal slack", "dual slack")
    sol = dict.fromkeys(keys)

    if dsdpstatus == "DSDP_UNBOUNDED":
        sol["status"] = "dual infeasible"
        xv = np.asarray(x, dtype=float).reshape(-1)
        xv = xv * (-1.0 / float(c @ xv))
        sl_, ss_ = _gx(xv)
        sl_, ss_ = -sl_, [-0.5 * (S + S.T) for S in ss_]
        glx, gsx = _gx(xv)
        rz = np.concatenate([glx + sl_] +
                            [(S + gs).reshape(-1)
                             for S, gs in zip(ss_, gsx)]) \
            if (ml or ms) else np.zeros(0)
        sol.update({
            "x": xv, "sl": sl_, "ss": ss_, "primal objective": -1.0,
            "residual as dual infeasibility certificate":
                float(np.linalg.norm(rz) / resz0),
            "primal slack": _slack(sl_, ss_)})
        return sol

    if dsdpstatus == "DSDP_INFEASIBLE":
        sol["status"] = "primal infeasible"
        zlv = (np.asarray(zl, dtype=float).reshape(-1) if ml
               else np.zeros(0))
        zsv = [np.asarray(Z, dtype=float).reshape(m, m)
               for Z, m in zip(zs or [], ms)]
        hz = float(hlv @ zlv) + sum(
            float(np.sum(hk * Z)) for hk, Z in zip(hsm, zsv))
        scal = 1.0 / (-hz)
        zlv = zlv * scal
        zsv = [0.5 * (Z + Z.T) * scal for Z in zsv]
        rx = -_gxT(zlv, zsv)
        sol.update({
            "y": np.zeros(0), "zl": zlv, "zs": zsv,
            "dual objective": 1.0,
            "residual as primal infeasibility certificate":
                float(np.linalg.norm(rx) / resx0),
            "dual slack": _slack(zlv, zsv)})
        return sol

    sol["status"] = ("optimal" if dsdpstatus == "DSDP_PDFEASIBLE"
                     else "unknown")
    if x is None or zl is None and ml:
        return sol
    xv = np.asarray(x, dtype=float).reshape(-1)
    zlv = (np.asarray(zl, dtype=float).reshape(-1) if ml
           else np.zeros(0))
    zsv = [0.5 * (np.asarray(Z, dtype=float).reshape(m, m) +
                  np.asarray(Z, dtype=float).reshape(m, m).T)
           for Z, m in zip(zs or [], ms)]
    glx, gsx = _gx(xv)
    sl_ = hlv - glx
    ss_ = [0.5 * ((hk - gs) + (hk - gs).T) for hk, gs in zip(hsm, gsx)]
    pcost = float(c @ xv)
    dcost = -float(hlv @ zlv) - sum(
        float(np.sum(hk * Z)) for hk, Z in zip(hsm, zsv))
    gap = float(sl_ @ zlv) + sum(
        float(np.sum(S * Z)) for S, Z in zip(ss_, zsv))
    relgap = (gap / -pcost if pcost < 0.0 else
              gap / dcost if dcost > 0.0 else None)
    rx = c + _gxT(zlv, zsv)
    resx = float(np.linalg.norm(rx) / resx0)
    rz = np.concatenate(
        [glx + sl_ - hlv] +
        [(gs + S - hk).reshape(-1)
         for gs, S, hk in zip(gsx, ss_, hsm)]) if (ml or ms) else \
        np.zeros(0)
    resz = float(np.linalg.norm(rz) / resz0)
    pinfres = dinfres = None
    if sol["status"] != "optimal" and dcost > 0.0:
        pinfres = float(np.linalg.norm(_gxT(zlv, zsv)) / resx0 / dcost)
    if sol["status"] != "optimal" and pcost < 0.0:
        rzc = np.concatenate(
            [glx + sl_] + [(gs + S).reshape(-1)
                           for gs, S in zip(gsx, ss_)])
        dinfres = float(np.linalg.norm(rzc) / resz0 / -pcost)
    sol.update({
        "x": xv, "sl": sl_, "ss": ss_, "y": np.zeros(0),
        "zl": zlv, "zs": zsv,
        "primal objective": pcost, "dual objective": dcost,
        "gap": gap, "relative gap": relgap,
        "primal infeasibility": resz, "dual infeasibility": resx,
        "residual as primal infeasibility certificate": pinfres,
        "residual as dual infeasibility certificate": dinfres,
        "primal slack": _slack(sl_, ss_),
        "dual slack": _slack(zlv, zsv)})
    return sol


def lp(c, G, h, A=None, b=None, solver=None, primalstart=None,
       dualstart=None, kktsolver=None, options=None):
    """LP: minimize c'x s.t. Gx <= h, Ax = b.  `solver` accepts None
    (native conelp), 'glpk' (HiGHS-backed bridge), 'osqp' (native JAX
    ADMM), or 'mosek' (requires the mosek package) — the reference's
    dispatch contract (coneprog.py:2807-2838)."""
    if solver == "glpk":
        from .. import glpk
        return glpk.lp_bridge(c, G, h, A, b, options=options)
    if solver == "osqp":
        from .. import osqp as _osqp
        return _osqp.qp_bridge(None, c, G, h, A, b, options=options)
    if solver == "gurobi":
        # reference coneprog.py:2834-2845: LP through gurobi.qp with P=None
        from .. import gurobi as _gurobi
        opts = (options or {}).get("gurobi")
        status, x, z, y = _gurobi.qp(c, G, h, A, b, None, options=opts)
        ml = np.asarray(h).size
        return _bridge_cone_result(status, x, z, y, c, G, h, A, b, ml, [])
    if solver == "mosek":
        from .. import msk
        opts = (options or {}).get("mosek")
        if opts:
            solsta, x, z, y = msk.lp(c, G, h, A, b, options=opts)
        else:
            solsta, x, z, y = msk.lp(c, G, h, A, b)
        hv = np.asarray(h, dtype=float).reshape(-1)
        return _mosek_cone_result(solsta, x, z, y, c, G, h, A, b,
                                  len(hv), [])
    h = np.asarray(h, dtype=float).reshape(-1)
    if options and options.get("equilibrate"):
        # Ruiz presolve for badly scaled LPs (build-side option; see
        # docs/coneprog.md).  Solve the scaled problem, unscale iterates.
        cs, Gs, hs, As, bs, dr, dra, dc = _ruiz_equilibrate(
            np.asarray(c, dtype=float).reshape(-1), G, h, A, b)
        opts2 = {k: v for k, v in options.items() if k != "equilibrate"}
        sol = conelp(cs, Gs, hs, {"l": h.shape[0]}, As, bs,
                     kktsolver=kktsolver, options=opts2)
        sol = dict(sol)
        if sol.get("x") is not None:
            sol["x"] = np.asarray(sol["x"]).reshape(-1) * dc
        if sol.get("s") is not None:
            sol["s"] = np.asarray(sol["s"]).reshape(-1) / dr
        if sol.get("z") is not None:
            sol["z"] = np.asarray(sol["z"]).reshape(-1) * dr
        if A is not None and sol.get("y") is not None:
            sol["y"] = np.asarray(sol["y"]).reshape(-1) * dra
        return sol
    return conelp(c, G, h, {"l": h.shape[0]}, A, b,
                  primalstart=primalstart, dualstart=dualstart,
                  kktsolver=kktsolver, options=options)


def socp(c, Gl=None, hl=None, Gq=None, hq=None, A=None, b=None,
         solver=None, primalstart=None, dualstart=None, kktsolver=None,
         options=None):
    """SOCP in natural form: minimize c'x s.t. Gl x <= hl plus
    second-order cone blocks s_k = h_k - G_k x in Q (reference
    coneprog.py:3044).  solver='mosek' dispatches to the MOSEK bridge
    (requires the mosek package), as the reference (coneprog.py:3363)."""
    if solver == "mosek":
        from .. import msk
        opts = (options or {}).get("mosek")
        if opts:
            solsta, x, zl, zq = msk.socp(c, Gl, hl, Gq, hq, options=opts)
        else:
            solsta, x, zl, zq = msk.socp(c, Gl, hl, Gq, hq)
        ml = 0 if hl is None else np.asarray(hl).size
        mq = [np.asarray(hk).size for hk in (hq or [])]
        Gfull = np.vstack(
            ([np.asarray(Gl, dtype=float).reshape(ml, -1)] if ml else [])
            + [np.asarray(Gk, dtype=float).reshape(mk, -1)
               for Gk, mk in zip(Gq or [], mq)])
        hfull = np.concatenate(
            ([np.asarray(hl, dtype=float).reshape(-1)] if ml else [])
            + [np.asarray(hk, dtype=float).reshape(-1) for hk in (hq or [])])
        z = (np.concatenate([np.asarray(zl).reshape(-1)]
                            + [np.asarray(zk).reshape(-1) for zk in zq])
             if zl is not None else None)
        sol = _mosek_cone_result(solsta, x, z, None, c, Gfull, hfull,
                                 A, b, ml, mq)
        # split the stacked s/z back into the socp natural form
        # (reference coneprog.py:3470-3490)
        for key, parts in (("s", ("sl", "sq")), ("z", ("zl", "zq"))):
            v = sol.pop(key)
            if v is None:
                sol[parts[0]], sol[parts[1]] = None, None
            else:
                sol[parts[0]] = v[:ml]
                blocks, ofs = [], ml
                for k in mq:
                    blocks.append(v[ofs:ofs + k])
                    ofs += k
                sol[parts[1]] = blocks
        return sol
    c = np.asarray(c, dtype=float).reshape(-1)
    Gs, hs, ql = [], [], []
    l = 0
    if Gl is not None:
        Gl = np.asarray(Gl, dtype=float)
        hl = np.asarray(hl, dtype=float).reshape(-1)
        Gs.append(Gl.reshape(len(hl), -1))
        hs.append(hl)
        l = len(hl)
    Gq = Gq or []
    hq = hq or []
    for Gk, hk in zip(Gq, hq):
        Gk = np.asarray(Gk, dtype=float)
        hk = np.asarray(hk, dtype=float).reshape(-1)
        Gs.append(Gk.reshape(len(hk), -1))
        hs.append(hk)
        ql.append(len(hk))
    G = np.vstack(Gs)
    h = np.concatenate(hs)
    dims = ConeDims(l=l, q=tuple(ql))
    sol = conelp(c, G, h, dims, A, b, primalstart=primalstart,
                 dualstart=dualstart, kktsolver=kktsolver, options=options)
    # split multipliers back into natural blocks
    sol = dict(sol)
    z, s = sol.get("z"), sol.get("s")
    if z is not None:
        zl = np.asarray(z)[:l]
        zq = []
        ofs = l
        for m in ql:
            zq.append(np.asarray(z)[ofs:ofs + m])
            ofs += m
        sol["zl"], sol["zq"] = zl, zq
    if s is not None:
        sl = np.asarray(s)[:l]
        sq = []
        ofs = l
        for m in ql:
            sq.append(np.asarray(s)[ofs:ofs + m])
            ofs += m
        sol["sl"], sol["sq"] = sl, sq
    return sol


def sdp(c, Gl=None, hl=None, Gs=None, hs=None, A=None, b=None,
        solver=None, primalstart=None, dualstart=None, kktsolver=None,
        options=None):
    """SDP in natural form: minimize c'x s.t. Gl x <= hl and
    sum_i x_i (Gs[k] column i, reshaped) <= hs[k] in the PSD order
    (reference coneprog.py:3597; Gs[k] columns are vectorized coefficient
    matrices, hs[k] square matrices).  solver='dsdp' routes through the
    DSDP-interface bridge (reference coneprog.py:3924)."""
    if solver == "dsdp":
        if A is not None:
            raise ValueError("sdp() with the solver = 'dsdp' option does "
                             "not handle problems with equality "
                             "constraints")
        from .. import dsdp as _dsdp
        from . import options as global_options
        # solvers.options['dsdp'] (reference coneprog.py:3930) merged
        # under per-call options; solvers.sdp callers expect
        # conelp-level accuracy from every route, so tighten the
        # dual-scaling gap beyond the DSDP interface default (1e-5)
        # unless the user set it explicitly
        dopts = dict(global_options.get("dsdp") or {})
        dopts.update((options or {}).get("dsdp") or {})
        dopts.setdefault("DSDP_GapTolerance", 1e-8)
        status, x, r, zl, zs = _dsdp.sdp(c, Gl, hl, Gs, hs,
                                         options=dopts)
        return _dsdp_result(status, x, zl, zs, c, Gl, hl, Gs, hs)
    c = np.asarray(c, dtype=float).reshape(-1)
    Gparts, hparts, sl = [], [], []
    l = 0
    if Gl is not None:
        Gl = np.asarray(Gl, dtype=float)
        hl = np.asarray(hl, dtype=float).reshape(-1)
        Gparts.append(Gl.reshape(len(hl), -1))
        hparts.append(hl)
        l = len(hl)
    Gs = Gs or []
    hs = hs or []
    for Gk, hk in zip(Gs, hs):
        Gk = np.asarray(Gk, dtype=float)
        hk = np.asarray(hk, dtype=float)
        m = hk.shape[0]
        Gparts.append(Gk.reshape(m * m, -1))
        hparts.append(hk.reshape(-1))
        sl.append(m)
    G = np.vstack(Gparts)
    h = np.concatenate(hparts)
    dims = ConeDims(l=l, s=tuple(sl))
    sol = conelp(c, G, h, dims, A, b, primalstart=primalstart,
                 dualstart=dualstart, kktsolver=kktsolver, options=options)
    sol = dict(sol)
    z, s = sol.get("z"), sol.get("s")
    for key, vec in (("z", z), ("s", s)):
        if vec is None:
            continue
        v = np.asarray(vec)
        sol[key + "l"] = v[:l]
        blocks = []
        ofs = l
        for m in sl:
            blocks.append(v[ofs:ofs + m * m].reshape(m, m))
            ofs += m * m
        sol[key + "s"] = blocks
    return sol
