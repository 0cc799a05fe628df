"""Pluggable KKT factorization strategies.

Equivalents of the reference's five KKT strategies
(reference src/python/misc.py: kkt_ldl :1055, kkt_ldl2 :1128, kkt_chol
:1213, kkt_chol2 :1352, kkt_qr :1570).  Each strategy is a function

    make_kkt_solver(name, dims, G, A, P=None, mnl=0, reg=0.0)
        -> factor(W, H=None, Df=None)
        -> solve(bx, by, bz) -> (ux, uy, uz)

solving the (scaled) Newton system

    [ P+H  A'  Geff'       ] [ux]   [bx]
    [ A    0   0           ] [uy] = [by]
    [ Geff 0  -W'W         ] [uz]   [bz]

where Geff = [Df; G] when a nonlinear block Df is present (its mnl rows are
scaled like extra 'l' entries — the reference's 'dnl' part), and W is the
Nesterov-Todd scaling for dims.with_extra_l(mnl).

All strategies are pure functions of jnp arrays and trace cleanly under jit;
matrix-free G/A require a custom kktsolver at the solver level, exactly like
the reference (coneprog.py:286-402 customization contract).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from . import cones
from .cones import ConeDims

STRATEGIES = ("ldl", "ldl2", "chol", "chol2", "qr", "chol2_mixed",
              "chol2_mixed_nofb")


def make_kkt_solver(name, dims: ConeDims, G, A=None, P=None, mnl: int = 0,
                    reg: float = 0.0, ozaki=None, facref=None):
    """ozaki: None = follow config.ozaki_refine; True/False force the
    exact-split refinement matvec for the mixed strategies.  The batched
    mixed driver passes True (many lanes amortize the slice matmuls);
    everything else defaults to the config flag."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown kktsolver {name!r}; expected one of "
                         f"{STRATEGIES}")
    n = G.shape[1] if G is not None else (A.shape[1] if A is not None
                                          else P.shape[1])
    dtype = G.dtype if G is not None else jnp.asarray(P).dtype
    if A is None:
        A = jnp.zeros((0, n), dtype=dtype)
    edims = dims.with_extra_l(mnl) if mnl else dims
    fn = {"chol2": _kkt_chol2, "chol": _kkt_chol, "qr": _kkt_qr,
          "ldl": _kkt_ldl, "ldl2": _kkt_ldl2,
          "chol2_mixed": partial(_kkt_chol2_mixed, ozaki=ozaki,
                                 facref=facref),
          # chol2_mixed without the per-instance f64-factor fallback:
          # the vmap-friendly variant (under vmap lax.cond lowers to a
          # select, so the fallback branch would execute — and pay the
          # f64 factorization — for EVERY lane).  Batch drivers
          # pair it with a host-side f64 re-solve of failed lanes
          # (parallel/batch.py batched_qp_solver_mixed).
          "chol2_mixed_nofb": partial(_kkt_chol2_mixed,
                                      fallback=False,
                                      ozaki=ozaki,
                                      facref=facref)}[name]
    return partial(fn, dims, edims, G, A, P, mnl, reg)


def _geff(G, Df, mnl):
    if mnl:
        if Df is None:
            raise ValueError("Df required when mnl > 0")
        return jnp.concatenate([Df, G], axis=0) if G.shape[0] else Df
    return G


def _keff(P, H, n, dtype):
    K = 0.0
    if P is not None:
        K = K + P
    if H is not None:
        K = K + H
    if isinstance(K, float):
        return jnp.zeros((n, n), dtype=dtype)
    return K


def _chol_spd(K, reg):
    if reg:
        K = K + reg * jnp.eye(K.shape[0], dtype=K.dtype)
    return jnp.linalg.cholesky(K)


def _chol_solve(L, b):
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L.T, y, lower=False)


# ---------------------------------------------------------------------------
# chol2 — condensed normal equations (reference misc.py:1352 kkt_chol2)
# ---------------------------------------------------------------------------

def _kkt_chol2(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    """Eliminate uz, factor K = P + H + Gs'Gs (Gs = W^{-T} Geff), then a
    Schur complement over A.  The workhorse strategy: two Cholesky
    factorizations, everything matmul-shaped."""
    n, p = G.shape[1], A.shape[0]
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    K = _keff(P, H, n, G.dtype) + Gs.T @ Gs
    L = _chol_spd(K, reg)
    if p:
        KiAt = _chol_solve(L, A.T)           # K^{-1} A'
        S = A @ KiAt                          # Schur complement
        Ls = _chol_spd(S, reg)
    else:
        KiAt = Ls = None

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)  # W^{-T} bz
        f = bx + Gs.T @ bzs
        if p:
            Kif = _chol_solve(L, f)
            uy = _chol_solve(Ls, A @ Kif - by)
            ux = Kif - KiAt @ uy
        else:
            ux = _chol_solve(L, f)
            uy = jnp.zeros((0,), dtype=bx.dtype)
        # uz = (W'W)^{-1} (Geff ux - bz) = W^{-1} (Gs ux - W^{-T} bz)
        uz = cones.scale(edims, W, Gs @ ux - bzs, inverse=True)
        return ux, uy, uz

    return solve


# ---------------------------------------------------------------------------
# chol2_mixed — factor in float32, recover float64 accuracy by iterative
# refinement against the f64 condensed matrix.  (No reference counterpart
# — this is a build-side strategy; whether it beats all-f64 chol2 depends
# on the device's f64 rate.)
# ---------------------------------------------------------------------------

def _hoist_closure(fn, *ops_flat):
    """Closure conversion that hoists ALL traced constants.

    `jax.closure_convert` hoists only AD-perturbed constants, so values
    captured from an enclosing vmap (BatchTracers) stay hidden in the
    jaxpr — exactly what custom_vmap must see as arguments.  Tracing
    with make_jaxpr records them as jaxpr consts (with their per-lane
    avals); re-evaluating the jaxpr with the consts passed explicitly
    makes them formal inputs."""
    closed, oshape = jax.make_jaxpr(fn, return_shape=True)(*ops_flat)
    out_tree = jax.tree_util.tree_structure(oshape)
    jaxpr, consts = closed.jaxpr, list(closed.consts)

    def conv(ops_l, consts_l):
        outs = jax.core.eval_jaxpr(jaxpr, consts_l, *ops_l)
        return jax.tree_util.tree_unflatten(out_tree, outs)

    return conv, consts


def cond_any(pred, true_fn, false_fn, *ops):
    """`lax.cond(pred, true_fn, false_fn, *ops)` whose VMAPPED lowering
    guards on `pred.any()`: the (expensive) true branch runs once for
    the whole batch only when some lane actually needs it, with
    per-lane selection of the results — instead of vmap's default
    select lowering that executes it for every lane on every call.

    This is what makes the f64-factor fallback of `chol2_mixed` viable
    inside group-vmapped drivers (parallel/batch.py seq groups): the
    fallback fires on the rare ill-conditioned lane, and a group whose
    lanes are all well-conditioned pays nothing for it.  Both branches
    may close over traced values (including batch tracers) — closures
    are lifted via `_hoist_closure`."""
    from jax.custom_batching import custom_vmap

    ops_flat, ops_tree = jax.tree_util.tree_flatten(tuple(ops))

    def tf(*leaves):
        return true_fn(*jax.tree_util.tree_unflatten(ops_tree, leaves))

    def ff(*leaves):
        return false_fn(*jax.tree_util.tree_unflatten(ops_tree, leaves))

    tconv, tconsts = _hoist_closure(tf, *ops_flat)
    fconv, fconsts = _hoist_closure(ff, *ops_flat)

    @custom_vmap
    def cf(pred, ops_l, tc, fc):
        return jax.lax.cond(pred, lambda: tconv(ops_l, tc),
                            lambda: fconv(ops_l, fc))

    @cf.def_vmap
    def _rule(axis_size, in_batched, pred, ops_l, tc, fc):
        def bcast(x, b):
            return x if b else jnp.broadcast_to(
                x, (axis_size,) + jnp.shape(x))

        def bmap(seq, bseq):
            bl = jax.tree_util.tree_leaves(bseq)
            return [bcast(x, b) for x, b in zip(seq, bl)]

        tm = jax.tree_util.tree_map
        pred_b = bcast(pred, jax.tree_util.tree_leaves(in_batched[0])[0])
        ops_b = bmap(ops_l, in_batched[1])
        tc_b = bmap(tc, in_batched[2])
        fc_b = bmap(fc, in_batched[3])

        def vmapped(conv, ops_v, consts_v):
            if not ops_v and not consts_v:
                # constant branch (e.g. a zeros builder): evaluate once
                # and broadcast across lanes
                out1 = conv([], [])
                return tm(lambda a: jnp.broadcast_to(
                    a, (axis_size,) + a.shape), out1)
            return jax.vmap(lambda o, f: conv(o, f))(ops_v, consts_v)

        def run_false():
            return vmapped(fconv, ops_b, fc_b)

        def run_both():
            tv = vmapped(tconv, ops_b, tc_b)
            fv = run_false()
            return tm(lambda a, b2: jnp.where(
                pred_b.reshape((axis_size,) + (1,) * (a.ndim - 1)),
                a, b2), tv, fv)

        out = jax.lax.cond(jnp.any(pred_b), run_both, run_false)
        return out, tm(lambda _: True, out)

    return cf(pred, ops_flat, tconsts, fconsts)


def _mixed_core(kmul, K32, dtype, k64_build, max_refine=30,
                rtol_factor=500.0, fallback=True, keq64_build=None):
    """Adaptive mixed-precision SPD solver core: equilibrated float32
    Cholesky + float64 iterative refinement against the *operator* kmul,
    with an automatic float64-factor fallback when the measured
    refinement contraction says f32 carries
    too little information (cond approaching 1/eps_f32 — the regime that
    capped the round-1 implementation at ~1e-6).

    - kmul(x): exact (f64) matrix-vector product with the SPD matrix —
      operator form, so the dense f64 matrix need never be built on the
      fast path.
    - K32: the dense f32 matrix to factor (built with f32 matmuls).
    - k64_build(): dense f64 matrix, evaluated under lax.cond only when
      the fallback factorization is actually needed.

    The contraction is *measured* with a probe solve at factor time;
    refinement runs as a residual-guarded lax.while_loop with a stall
    exit instead of a fixed unroll."""
    eps64 = jnp.finfo(dtype).eps
    dsc32 = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(K32), 1e-30))
    Keq32 = K32 * dsc32[:, None] * dsc32[None, :]
    L32 = _chol_spd(Keq32, 0.0)
    dsc = dsc32.astype(dtype)

    D32 = None
    if keq64_build is not None:
        # One-shot FACTOR refinement: with
        # E = Keq - L0 L0' computed to ~1e-12 (exact-split Gram,
        # ops/ozaki.ata), the lower-triangular correction
        # D = L0 · Φ(L0^{-1} E L0^{-T}) (Φ = strict lower + half diag)
        # makes (L0+D)(L0+D)' ≈ Keq to O(eps32²).  The refined
        # preconditioner is applied FIRST-ORDER around the base solve
        # S0 = (L0 L0')^{-1}:
        #   (MM')^{-1} r ≈ u − S0(D·L0'u + L0·D'u),  u = S0 r
        # — all-f32 ops, and S0 reuses the f32 factor.
        # This extends the fast-contraction regime by ~1.5 decades of
        # conditioning, collapsing the PCG refinement step count at
        # cond ~1e7.  Setup: one split Gram + two n-RHS f32 triangular
        # solves + one f32 GEMM per factorization.
        Keq64 = keq64_build(dsc)
        from .ops.ozaki import ata as _ata
        L0_64 = L32.astype(dtype)
        E32 = (Keq64 - _ata(jnp.swapaxes(L0_64, -1, -2))).astype(
            K32.dtype)
        F1 = solve_triangular(L32, E32, lower=True)
        F = solve_triangular(L32, F1.T, lower=True).T
        Phi = jnp.tril(F, -1) + 0.5 * jnp.diag(jnp.diagonal(F))
        D32 = L32 @ Phi

    def m_apply(r):
        # approximate K^{-1} r through the equilibrated f32 factor
        # (with the optional first-order refined-factor expansion)
        r32 = (dsc * r).astype(K32.dtype)
        if D32 is None:
            return dsc * _chol_solve(L32, r32).astype(dtype)
        u = _chol_solve(L32, r32)
        w = D32 @ (L32.T @ u) + L32 @ (D32.T @ u)
        z = u - _chol_solve(L32, w)
        return dsc * z.astype(dtype)

    if fallback:
        # probe the actual refinement contraction rate
        b0 = dsc / jnp.linalg.norm(dsc)
        x0 = m_apply(b0)
        r0 = b0 - kmul(x0)
        x1 = x0 + m_apply(r0)
        r1 = b0 - kmul(x1)
        n0 = jnp.linalg.norm(r0)
        n1 = jnp.linalg.norm(r1)
        contr = n1 / jnp.maximum(n0, 1e-300)
        bad = (~jnp.isfinite(contr)) | (contr > 0.5) | (~jnp.isfinite(n0))

        L64 = cond_any(
            bad, lambda: jnp.linalg.cholesky(k64_build()),
            lambda: jnp.zeros(K32.shape, dtype))

        def solve64(b):
            y = solve_triangular(L64, b, lower=True)
            return solve_triangular(L64.T, y, lower=False)

    def solve32(b):
        # Preconditioned CG on K x = b with the equilibrated f32 factor
        # as the preconditioner.  Each step costs one exact (f64) kmul +
        # one f32 factor solve, like plain iterative refinement, but PCG
        # contracts at the square-root rate, so where the f64 kmul
        # dominates the step, halving the step count halves the KKT
        # solve.
        bn = jnp.linalg.norm(b)
        tol = rtol_factor * eps64 * jnp.maximum(bn, 1e-300)

        # PCG residual norms are not monotone, so the stall exit tracks
        # the best iterate in a short window instead of per-step
        # progress; the best-so-far x is what is returned.
        def cond_fn(c):
            (x_, r_, z_, p_, rz_, xb, rb, since, k) = c
            return ((rb > tol) & (k < max_refine) & (since < 8) &
                    jnp.isfinite(rb))

        def body(c):
            (x_, r_, z_, p_, rz_, xb, rb, since, k) = c
            Kp = kmul(p_)
            pKp = jnp.vdot(p_, Kp)
            alpha = rz_ / jnp.where(pKp > 0, pKp, jnp.inf)
            x_ = x_ + alpha * p_
            r_ = r_ - alpha * Kp
            z_ = m_apply(r_)
            rz2 = jnp.vdot(r_, z_)
            # rz can go negative (the f32 preconditioner is only
            # approximately PD); a magnitude floor must preserve sign or
            # beta explodes
            beta = jnp.where(jnp.abs(rz_) > 1e-300, rz2 / rz_, 0.0)
            p_ = z_ + beta * p_
            rn = jnp.linalg.norm(r_)
            better = jnp.isfinite(rn) & (rn < rb)
            xb = jnp.where(better, x_, xb)
            rb = jnp.where(better, rn, rb)
            since = jnp.where(better, 0, since + 1)
            return (x_, r_, z_, p_, rz2, xb, rb, since, k + 1)

        x0 = m_apply(b)
        r0 = b - kmul(x0)
        z0 = m_apply(r0)
        rn0 = jnp.linalg.norm(r0)
        c0 = (x0, r0, z0, z0, jnp.vdot(r0, z0), x0, rn0,
              jnp.int32(0), jnp.int32(0))
        out = jax.lax.while_loop(cond_fn, body, c0)
        return out[5]

    if not fallback:
        return solve32

    def ksolve(b):
        return cond_any(bad, solve64, solve32, b)

    return ksolve


def mixed_spd_solver(K, reg=0.0, cdt=None, max_refine=30,
                     rtol_factor=50.0, fallback=True, ozaki=None,
                     facref=None):
    """Dense-matrix convenience wrapper around `_mixed_core` (used for
    Schur complements and standalone SPD solves).  `ozaki`/`facref`
    default to the config flags but callers that thread per-strategy
    overrides (e.g. `_kkt_chol2_mixed`) pass them explicitly so cached
    programs key on the override, not on mutable config state."""
    from . import config
    cdt = cdt or config.compute_dtype
    if reg:
        K = K + reg * jnp.eye(K.shape[0], dtype=K.dtype)
    if ozaki is None:
        ozaki = config.ozaki_refine
    if facref is None:
        facref = config.factor_refine
    if ozaki:
        from .ops.ozaki import OzakiOperator
        kmul = OzakiOperator(K).mv
    else:
        kmul = lambda x: K @ x
    keq = None
    if facref:
        keq = lambda dsc: K * dsc[:, None] * dsc[None, :]
    return _mixed_core(kmul, K.astype(cdt), K.dtype,
                       lambda: K, max_refine, rtol_factor, fallback,
                       keq64_build=keq)


def _kkt_chol2_mixed(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None,
                     fallback=True, ozaki=None, facref=None):
    """Condensed normal equations with the adaptive mixed-precision SPD
    solver at the reference's 1e-7 tolerances (coneprog.py:440-454): the
    O(N n^2) normal-equations product K = P + Gs'Gs is formed in
    float32; float64 work
    on the fast path is limited to O(N n) operator products inside the
    refinement loop; the dense f64 K is built (and factored) under
    lax.cond only in the rare ill-conditioned iterations."""
    from . import config
    cdt = config.compute_dtype
    n, p = G.shape[1], A.shape[0]
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    Gs32 = Gs.astype(cdt)
    Kx32 = _keff(P, H, n, G.dtype).astype(cdt) + Gs32.T @ Gs32
    if reg:
        Kx32 = Kx32 + jnp.asarray(reg, cdt) * jnp.eye(n, dtype=cdt)

    if ozaki is None:
        ozaki = config.ozaki_refine
    if ozaki:
        # exact-split f64 products from f32 matmuls (ops/ozaki.py)
        from .ops.ozaki import OzakiOperator
        gop = OzakiOperator(Gs)
        pop = OzakiOperator(P) if P is not None else None
        hop = OzakiOperator(H) if H is not None else None

        def kmul(x):
            out = gop.normal_mv(x)
            if pop is not None:
                out = out + pop.mv(x)
            if hop is not None:
                out = out + hop.mv(x)
            if reg:
                out = out + reg * x
            return out
    else:
        def kmul(x):
            out = Gs.T @ (Gs @ x)
            if P is not None:
                out = out + P @ x
            if H is not None:
                out = out + H @ x
            if reg:
                out = out + reg * x
            return out

    def k64_build():
        K = _keff(P, H, n, G.dtype) + Gs.T @ Gs
        if reg:
            K = K + reg * jnp.eye(n, dtype=G.dtype)
        return K

    if facref is None:
        facref = config.factor_refine
    keq64_build = None
    if facref:
        from .ops.ozaki import ata as _ata

        def keq64_build(dsc):
            # equilibrated f64 K at ~1e-12 accuracy WITHOUT f64 matmuls:
            # the Gram is an exact-split f32 product, the rest is
            # elementwise f64
            K = _keff(P, H, n, G.dtype) + _ata(Gs)
            if reg:
                K = K + reg * jnp.eye(n, dtype=G.dtype)
            return K * dsc[:, None] * dsc[None, :]

    ksolve = _mixed_core(kmul, Kx32, G.dtype, k64_build,
                         fallback=fallback, keq64_build=keq64_build)
    if p:
        KiAt = jax.vmap(ksolve, in_axes=1, out_axes=1)(A.T)
        S = A @ KiAt
        ssolve = mixed_spd_solver(S, reg, fallback=fallback,
                                  ozaki=ozaki, facref=facref)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        f = bx + Gs.T @ bzs
        if p:
            Kif = ksolve(f)
            uy = ssolve(A @ Kif - by)
            ux = Kif - KiAt @ uy
        else:
            ux = ksolve(f)
            uy = jnp.zeros((0,), dtype=bx.dtype)
        uz = cones.scale(edims, W, Gs @ ux - bzs, inverse=True)
        return ux, uy, uz

    return solve


# ---------------------------------------------------------------------------
# chol — null-space method with Cholesky (reference misc.py:1213 kkt_chol)
# ---------------------------------------------------------------------------

def _nullspace(A):
    """Full QR of A' -> (Q1 (n,p), Q2 (n,n-p), R1 (p,p))."""
    n = A.shape[1]
    p = A.shape[0]
    Q, R = jnp.linalg.qr(A.T, mode="complete")
    return Q[:, :p], Q[:, p:], R[:p, :p]


def _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df, spd_solver):
    """Common null-space elimination: x = Q1 w + Q2 v with A' = Q R."""
    n, p = G.shape[1], A.shape[0]
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    K = _keff(P, H, n, G.dtype) + Gs.T @ Gs
    if p:
        Q1, Q2, R1 = _nullspace(A)
        Kred = Q2.T @ K @ Q2
        solve_red = spd_solver(Kred, reg)

        def solve(bx, by, bz):
            bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
            f = bx + Gs.T @ bzs
            w = solve_triangular(R1.T, by, lower=True)
            v = solve_red(Q2.T @ (f - K @ (Q1 @ w)))
            ux = Q1 @ w + Q2 @ v
            uy = solve_triangular(R1, Q1.T @ (f - K @ ux), lower=False)
            uz = cones.scale(edims, W, Gs @ ux - bzs, inverse=True)
            return ux, uy, uz
    else:
        solve_full = spd_solver(K, reg)

        def solve(bx, by, bz):
            bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
            ux = solve_full(bx + Gs.T @ bzs)
            uy = jnp.zeros((0,), dtype=bx.dtype)
            uz = cones.scale(edims, W, Gs @ ux - bzs, inverse=True)
            return ux, uy, uz

    return solve


def _spd_chol(K, reg):
    L = _chol_spd(K, reg)
    return lambda b: _chol_solve(L, b)


def _spd_qr(K, reg):
    # QR of the (symmetric PSD) reduced matrix: more robust than Cholesky
    # for nearly singular K; mirrors the role of the reference's kkt_qr.
    if reg:
        K = K + reg * jnp.eye(K.shape[0], dtype=K.dtype)
    Q, R = jnp.linalg.qr(K)
    return lambda b: solve_triangular(R, Q.T @ b, lower=False)


def _kkt_chol(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    return _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df, _spd_chol)


def _kkt_qr(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    return _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df, _spd_qr)


# ---------------------------------------------------------------------------
# ldl / ldl2 — regularized quasidefinite factorizations
# (reference misc.py:1055 kkt_ldl, :1128 kkt_ldl2)
# ---------------------------------------------------------------------------

DEFAULT_KKTREG = 1e-9


def ldl_nopiv(M, block: int = 64):
    """Unpivoted blocked LDL' factorization of a quasidefinite matrix.

    Returns (L, d) with M = L diag(d) L', L unit lower triangular.  Valid
    for quasidefinite M (symmetric with a [+ -] signed structure after
    regularization — the QDLDL/OSQP approach); the IPM applies iterative
    refinement on top.  Blocked right-looking: the O(n) sequential work is
    confined to `block`-sized panels, trailing updates are matmuls.
    """
    n = M.shape[0]
    nb = -(-n // block) * block
    if nb != n:
        Mp = jnp.zeros((nb, nb), M.dtype).at[:n, :n].set(M)
        Mp = Mp.at[jnp.arange(n, nb), jnp.arange(n, nb)].set(1.0)
    else:
        Mp = M
    L = jnp.zeros_like(Mp)
    d = jnp.zeros((nb,), M.dtype)

    for k0 in range(0, nb, block):
        # panel = trailing columns [k0:k0+block) of the updated matrix
        Akk = Mp[k0:k0 + block, k0:k0 + block]
        Ask = Mp[k0 + block:, k0:k0 + block]

        # factor the diagonal block with a fori_loop of masked rank-1 updates
        def body(j, carry):
            Akk, Lkk, dk = carry
            pivot = Akk[j, j]
            col = Akk[:, j] / pivot
            idx = jnp.arange(block)
            col = jnp.where(idx > j, col, 0.0).at[j].set(1.0)
            Lkk = Lkk.at[:, j].set(col)
            dk = dk.at[j].set(pivot)
            upd = jnp.outer(col, col) * pivot
            mask = (idx[:, None] > j) & (idx[None, :] > j)
            Akk = Akk - jnp.where(mask, upd, 0.0)
            return Akk, Lkk, dk

        _, Lkk, dk = jax.lax.fori_loop(
            0, block, body,
            (Akk, jnp.zeros((block, block), M.dtype),
             jnp.zeros((block,), M.dtype)))

        # off-diagonal panel: Lsk = Ask L_kk^{-T} D^{-1}
        if Ask.shape[0]:
            Lsk = solve_triangular(Lkk, Ask.T, lower=True).T / dk[None, :]
            # trailing update: M22 -= Lsk D Lsk'
            upd = (Lsk * dk[None, :]) @ Lsk.T
            Mp = Mp.at[k0 + block:, k0 + block:].add(-upd)
            L = L.at[k0 + block:, k0:k0 + block].set(Lsk)
        L = L.at[k0:k0 + block, k0:k0 + block].set(Lkk)
        d = d.at[k0:k0 + block].set(dk)

    return L[:n, :n], d[:n]


def ldl_solve(L, d, b):
    y = solve_triangular(L, b, lower=True, unit_diagonal=True)
    y = y / d if y.ndim == 1 else y / d[:, None]
    return solve_triangular(L.T, y, lower=False, unit_diagonal=True)


def _kkt_ldl(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    """Full 3x3 LDL' with QDLDL-style +/- regularization (reference
    kkt_ldl with the kktreg option, misc.py:1055-1125)."""
    n, p = G.shape[1], A.shape[0]
    eps = reg or DEFAULT_KKTREG
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    N = Gs.shape[0]
    nt = n + p + N
    M = jnp.zeros((nt, nt), dtype=G.dtype)
    Kxx = _keff(P, H, n, G.dtype)
    M = M.at[:n, :n].set(Kxx + eps * jnp.eye(n, dtype=G.dtype))
    M = M.at[n:n + p, :n].set(A)
    M = M.at[:n, n:n + p].set(A.T)
    M = M.at[n + p:, :n].set(Gs)
    M = M.at[:n, n + p:].set(Gs.T)
    M = M.at[n:n + p, n:n + p].set(-eps * jnp.eye(p, dtype=G.dtype))
    M = M.at[n + p:, n + p:].set(-(1.0 + eps) * jnp.eye(N, dtype=G.dtype))
    L, dvec = ldl_nopiv(M)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        rhs = jnp.concatenate([bx, by, bzs])
        # one step of iterative refinement against the *unregularized* system
        u = ldl_solve(L, dvec, rhs)
        Mu = jnp.concatenate([
            Kxx @ u[:n] + A.T @ u[n:n + p] + Gs.T @ u[n + p:],
            A @ u[:n],
            Gs @ u[:n] - u[n + p:],
        ])
        u = u + ldl_solve(L, dvec, rhs - Mu)
        ux, uy = u[:n], u[n:n + p]
        uz = cones.scale(edims, W, u[n + p:], inverse=True)
        return ux, uy, uz

    return solve


def _kkt_ldl2(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    """2x2 condensed LDL': eliminate uz first (reference kkt_ldl2,
    misc.py:1128)."""
    n, p = G.shape[1], A.shape[0]
    eps = reg or DEFAULT_KKTREG
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    K = _keff(P, H, n, G.dtype) + Gs.T @ Gs
    nt = n + p
    M = jnp.zeros((nt, nt), dtype=G.dtype)
    M = M.at[:n, :n].set(K + eps * jnp.eye(n, dtype=G.dtype))
    M = M.at[n:, :n].set(A)
    M = M.at[:n, n:].set(A.T)
    M = M.at[n:, n:].set(-eps * jnp.eye(p, dtype=G.dtype))
    L, dvec = ldl_nopiv(M)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        rhs = jnp.concatenate([bx + Gs.T @ bzs, by])
        u = ldl_solve(L, dvec, rhs)
        Mu = jnp.concatenate([K @ u[:n] + A.T @ u[n:], A @ u[:n]])
        u = u + ldl_solve(L, dvec, rhs - Mu)
        ux, uy = u[:n], u[n:]
        uz = cones.scale(edims, W, Gs @ ux - bzs, inverse=True)
        return ux, uy, uz

    return solve
