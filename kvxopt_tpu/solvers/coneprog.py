"""Cone programming solvers: coneqp, conelp and the natural-form wrappers
lp/qp/socp/sdp.

Functional re-design of the reference's IPMs (reference
src/python/coneprog.py: conelp :31, coneqp :1440, lp :2550, socp :3044,
sdp :3597, qp :4187).  Same mathematics — primal-dual Mehrotra
predictor-corrector with Nesterov-Todd scaling, and for conelp the extended
self-dual embedding with tau/kappa and full infeasibility certificates —
but a functional architecture:

- the iteration is a `lax.while_loop` over an immutable state pytree, so a
  whole solve jit-compiles to a single XLA program;
- the NT scaling is recomputed from (s, z) each iteration (mathematically
  identical to the reference's incremental update_scaling, and cheap as
  batched dense algebra);
- all cone operations come from kvxopt_tpu.cones, KKT factorizations from
  kvxopt_tpu.kkt (pluggable, same three customization levels as the
  reference: operator-form G/A/P, custom kktsolver, per-call options).

Shapes are static; heterogeneous cone dims are handled by trace-time
unrolling over blocks.  Everything runs in options['dtype'] (default
float64; see kvxopt_tpu.config for the mixed-precision strategy).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import cones, kkt, config
from ..cones import ConeDims

# status codes carried through the jitted loop
RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR = (
    0, 1, 2, 3, 4, 5)

_STATUS_STR = {
    OPTIMAL: "optimal",
    UNKNOWN: "unknown",
    PRIMAL_INFEASIBLE: "primal infeasible",
    DUAL_INFEASIBLE: "dual infeasible",
    SINGULAR: "unknown",
}

STEP = 0.99   # fraction-to-boundary (reference coneprog.py:424)
EXPON = 3     # sigma exponent (reference coneprog.py:423)


class Options(NamedTuple):
    maxiters: int = 100
    abstol: float = 1e-7
    reltol: float = 1e-6
    feastol: float = 1e-7
    refinement: int = -1   # -1 = auto: 1 with q/s cones else 0
                           # (the reference's default, coneprog.py:436)
    show_progress: bool = False
    kktreg: float = 0.0
    sscaling: str = "eigh"  # s-block NT construction: 'eigh' (smaller
                            # program) or 'svd' (full accuracy)
    facref: object = None   # snapshot of config.factor_refine (the
                            # one-shot f32-factor correction in the
                            # mixed KKT strategies): part of the Options
                            # tuple so cached programs key on it
    ozaki: object = None    # exact-split refinement matvecs for the
                            # mixed KKT strategies: None = follow
                            # config.ozaki_refine (snapshotted at
                            # resolve time so cached programs key on
                            # it), True/False force.  The batched mixed
                            # driver forces True; single-instance solves
                            # default off

    def resolve_refinement(self, dims, kktsolver=None):
        """-1 (auto) resolves to the reference default (1 with q/s
        cones else 0, coneprog.py:436) — except with a mixed-precision
        KKT strategy, where at least one solver-level refinement step
        is required at 1e-7 tolerances even for pure-l dims: the f32
        factor + PCG solve leaves ~1e-5 KKT residuals on some
        instances, and without the outer refinement those lanes stall
        at status 'unknown'."""
        if self.refinement >= 0:
            return self
        auto = 1 if (dims.q or dims.s) else 0
        if isinstance(kktsolver, str) and "mixed" in kktsolver:
            auto = max(auto, 1)
        return self._replace(refinement=auto)


def _resolve_options(options):
    from . import options as global_options
    merged = dict(global_options)
    if options:
        merged.update(options)
    o = Options(
        maxiters=int(merged.get("maxiters", 100)),
        abstol=float(merged.get("abstol", 1e-7)),
        reltol=float(merged.get("reltol", 1e-6)),
        feastol=float(merged.get("feastol", 1e-7)),
        refinement=int(merged.get("refinement", -1)),
        show_progress=bool(merged.get("show_progress", False)),
        kktreg=float(merged.get("kktreg", 0.0) or 0.0),
        sscaling=str(merged.get("sscaling", "eigh")),
        ozaki=bool(merged.get("ozaki", config.ozaki_refine)),
        facref=bool(merged.get("facref", config.factor_refine)),
    )
    dtype = merged.get("dtype", None) or config.default_dtype
    return o, jnp.dtype(dtype), merged


@functools.lru_cache(maxsize=256)
def _empty_vec_cached(dev, dtype):
    return jnp.zeros((0,), dtype)


@functools.lru_cache(maxsize=256)
def _empty_mat_cached(dev, n, dtype):
    return jnp.zeros((0, n), dtype)


def _empty_vec(dtype):
    """Cached (0,) constant: creating it eagerly costs a device op per
    call.  Keyed by the default-device override in effect, so a solve
    under `jax.default_device` gets its own copy."""
    return _empty_vec_cached(jax.config.jax_default_device,
                             jnp.dtype(dtype))


def _empty_mat(n, dtype):
    """Cached (0, n) constant (see _empty_vec)."""
    return _empty_mat_cached(jax.config.jax_default_device, n,
                             jnp.dtype(dtype))


def _asarray(x, dtype, shape=None, name="argument"):
    if x is None:
        return None
    a = jnp.asarray(np.asarray(x), dtype=dtype)
    if a.ndim == 2 and a.shape[1] == 1 and (shape is None or len(shape) == 1):
        a = a[:, 0]
    if shape is not None and a.shape != shape:
        raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return a


def _result_dict(status, x, y, s, z, dims, metrics, iterations):
    res = {
        "status": _STATUS_STR.get(int(status), "unknown"),
        "x": x, "y": y, "s": s, "z": z,
        "iterations": int(iterations),
    }
    res.update(metrics)
    return res


class Metrics(NamedTuple):
    pcost: jnp.ndarray
    dcost: jnp.ndarray
    gap: jnp.ndarray
    relgap: jnp.ndarray
    pres: jnp.ndarray
    dres: jnp.ndarray


def _relgap(gap, pcost, dcost):
    return jnp.where(
        pcost < 0.0, gap / (-pcost),
        jnp.where(dcost > 0.0, gap / dcost, jnp.inf))


# ---------------------------------------------------------------------------
# Custom vector spaces (the reference's third customization level,
# coneprog.py:378-402: xnewcopy/xdot/xscal/xaxpy and the y* variants).
#
# JAX-native rendering: a vector-space element is any JAX *pytree* (array,
# dict/list/tuple of arrays, nested) — the JAX-native notion of "arbitrary
# Python objects" that can cross a lax.while_loop.  The default hooks below
# are pytree-generic, so structured x/y spaces work out of the box with an
# operator-form G/A and a custom kktsolver; the hooks can be overridden for
# exotic inner products.  Unlike the reference's in-place semantics, hooks
# are pure functions (xscal returns the scaled vector, xaxpy returns
# alpha*u + v); they must be jax-traceable.
# ---------------------------------------------------------------------------


def _tree_dot(u, v):
    lu = jax.tree_util.tree_leaves(u)
    lv = jax.tree_util.tree_leaves(v)
    s = 0.0
    for a, b in zip(lu, lv):
        s = s + jnp.vdot(a, b)
    return s


def _tree_scal(alpha, u):
    return jax.tree_util.tree_map(lambda a: alpha * a, u)


def _tree_axpy(u, v, alpha=1.0):
    return jax.tree_util.tree_map(lambda a, b: alpha * a + b, u, v)


def _tree_select(flag, u_true, u_false):
    """Elementwise select over a pytree (flag is a traced boolean)."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(flag, a, b), u_true, u_false)


class VecOps(NamedTuple):
    """Inner-product-space operations for one variable block (x or y).

    Functional equivalents of the reference's xnewcopy/xdot/xscal/xaxpy
    contract (reference coneprog.py:378-402); defaults handle any pytree.
    """

    dot: object = _tree_dot
    scal: object = _tree_scal
    axpy: object = _tree_axpy
    copy: object = lambda u: u  # immutable pytrees: identity is a copy

    def norm(self, u):
        return jnp.sqrt(jnp.maximum(self.dot(u, u), 0.0))

    def zero(self, like):
        return jax.tree_util.tree_map(jnp.zeros_like, like)


def _make_vecops(newcopy, dot, scal, axpy):
    kw = {}
    if dot is not None:
        kw["dot"] = dot
    if scal is not None:
        kw["scal"] = scal
    if axpy is not None:
        kw["axpy"] = axpy
    if newcopy is not None:
        kw["copy"] = newcopy
    return VecOps(**kw)


DEFAULT_VECOPS = VecOps()


def _max_feasible_step(dims, lmbda, ds_w, dz_w, limit):
    """Largest step a with s + a ds, z + a dz in the cone, given the
    W-scaled directions ds_w = W^{-T}ds, dz_w = W dz, capped at `limit` and
    damped by nothing (caller applies STEP).  One batched
    eigendecomposition for both directions."""
    ts, tz = cones.max_step2(dims, cones.scale2(dims, lmbda, ds_w),
                             cones.scale2(dims, lmbda, dz_w))
    t = jnp.maximum(jnp.maximum(ts, tz), 0.0)
    return jnp.where(t <= 0.0, limit, jnp.minimum(limit, 1.0 / t))


# ---------------------------------------------------------------------------
# coneqp
# ---------------------------------------------------------------------------


def _profile_ctx(options):
    """Opt-in jax.profiler trace capture (SURVEY §5 dev tool): with
    options['profile'] = <directory>, the whole solve — compile +
    every IPM iteration of the XLA program — is captured as a
    TensorBoard/Perfetto trace under that directory.  Documented in
    docs/gpu.md.  Inactive (and free) when the key is absent."""
    import contextlib
    from . import options as global_options
    d = dict(global_options)
    if options:
        d.update(options)
    pdir = d.get("profile")
    if not pdir:
        return contextlib.nullcontext()
    import jax.profiler
    return jax.profiler.trace(str(pdir))


def coneqp(P, q, G=None, h=None, dims=None, A=None, b=None, initvals=None,
           kktsolver=None, options=None, xnewcopy=None, xdot=None,
           xscal=None, xaxpy=None, ynewcopy=None, ydot=None, yscal=None,
           yaxpy=None):
    """Solve the cone QP

        minimize    (1/2) x'Px + q'x
        subject to  G x + s = h,  s in K
                    A x = b

    (reference coneprog.py:1440).  Returns a dict with the same keys as the
    reference: status, x/s/y/z, primal/dual objective, gap, relative gap,
    primal/dual infeasibility, primal/dual slack, iterations.

    P/G/A may be arrays (or anything numpy can convert); operator form plus
    a custom `kktsolver` callable factor(W, H=None, Df=None) -> solve is
    supported exactly like the reference's customization contract
    (coneprog.py:286-402).

    Custom vector spaces (the reference's third customization level,
    coneprog.py:378-402): passing any of xnewcopy/xdot/xscal/xaxpy makes x
    (and q) an abstract pytree; P, G (and A, if present) must then be
    operators and `kktsolver` a custom factor.  Unspecified hooks default
    to pytree-generic implementations; user hooks must be pure,
    jax-traceable functions — xscal(a, u) -> a*u, xaxpy(u, v, alpha) ->
    alpha*u + v, xdot(u, v) -> scalar (functional, not in-place).  The y*
    variants do the same for the equality-constraint space.
    """
    with _profile_ctx(options):
        return _coneqp(P, q, G, h, dims, A, b, initvals, kktsolver,
                       options, xnewcopy, xdot, xscal, xaxpy, ynewcopy,
                       ydot, yscal, yaxpy)


def _coneqp(P, q, G, h, dims, A, b, initvals, kktsolver, options,
            xnewcopy, xdot, xscal, xaxpy, ynewcopy, ydot, yscal, yaxpy):
    o, dtype, merged = _resolve_options(options)
    custom_x = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy))
    custom_y = any(f is not None for f in (ynewcopy, ydot, yscal, yaxpy))
    xops = _make_vecops(xnewcopy, xdot, xscal, xaxpy)
    yops = _make_vecops(ynewcopy, ydot, yscal, yaxpy)
    if custom_x:
        if not (callable(G) and callable(P)):
            raise ValueError("custom x vector space requires operator-form "
                             "P and G")
        if not callable(kktsolver):
            raise ValueError("custom x vector space requires a custom "
                             "kktsolver")
    if custom_y and A is None:
        raise ValueError("custom y vector space requires A")
    if custom_y and not callable(A):
        raise ValueError("custom y vector space requires operator-form A")

    if not custom_x:
        q = _asarray(q, dtype, name="q")
        n = q.shape[0]
    else:
        n = None
    if G is None and dims is None:
        raise ValueError("G and dims required (use a pure QP via A only is "
                         "not supported without inequalities)")
    if dims is None:
        dims = ConeDims(l=int(np.asarray(h).size))
    dims = ConeDims.from_dict(dims)
    if dims.degree == 0:
        raise ValueError("the cone must be nonempty")
    h = _asarray(h, dtype, shape=(dims.size,), name="h")
    if not custom_y:
        b = _asarray(b, dtype, name="b") if b is not None else _empty_vec(dtype)
        has_y = b.shape[0]
    else:
        has_y = 1

    G_is_op = callable(G)
    A_is_op = A is not None and callable(A)
    P_is_op = callable(P)
    Ga = None if G_is_op else _asarray(G, dtype, shape=(dims.size, n),
                                       name="G")
    Aa = None
    if not A_is_op:
        Aa = (_empty_mat(n, dtype) if A is None and n is not None
              else _asarray(A, dtype, name="A"))
    Pa = None if P_is_op else _asarray(P, dtype, shape=(n, n), name="P")

    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    if isinstance(kktsolver, str) and (G_is_op or A_is_op or P_is_op):
        raise ValueError("operator-form P/G/A require a custom kktsolver")

    # fast path: standard array inputs run solve + slack finalization as
    # one cached jitted program (s-block symmetrization included), so
    # repeated same-shape solves skip retracing; its errors propagate
    o = o.resolve_refinement(dims, kktsolver)
    if (isinstance(kktsolver, str) and not (G_is_op or A_is_op or P_is_op)
            and initvals is None and not (custom_x or custom_y)):
        Pz = Pa if Pa is not None else jnp.zeros((n, n), dtype)
        solve_fn = _cached_qp_solver_full(dims, kktsolver, o)
        pack = jax.device_get(solve_fn(Pz, q, Ga, h, Aa, b))
        it, status = (int(float(v)) for v in pack["meta"][:2])
        return _result_dict(status, pack["x"], pack["y"], pack["s"],
                            pack["z"], dims,
                            _qp_metrics_dict_from_pack(pack), it - 1)

    # non-fast paths: apply the s-block storage convention eagerly, then
    # build the factor from the symmetrized data
    h = cones.sym_from_lower(dims, h)
    if Ga is not None:
        Ga = cones.sym_from_lower_cols(dims, Ga)
    if isinstance(kktsolver, str):
        factor = kkt.make_kkt_solver(kktsolver, dims, Ga, Aa, Pa,
                                     reg=o.kktreg, ozaki=o.ozaki,
                                     facref=o.facref)
    else:
        factor = kktsolver

    gmv = G if G_is_op else (lambda x, trans=False:
                             (Ga.T @ x if trans else Ga @ x))
    amv = A if A_is_op else (lambda x, trans=False:
                             (Aa.T @ x if trans else Aa @ x))
    pmv = P if P_is_op else (lambda x: Pa @ x)

    init = None
    if initvals is not None:
        # partial initvals get the reference's defaults (coneprog.py:1441
        # initvals): x/y zero, s/z the cone identity
        e0 = cones.cone_e(dims, dtype)
        if custom_x or custom_y:
            if any(initvals.get(k) is None for k in ("x", "y")):
                raise ValueError("custom vector spaces require complete "
                                 "initvals")
            init = (initvals["x"], initvals["y"],
                    _asarray(initvals.get("s"), dtype) if initvals.get("s")
                    is not None else e0,
                    _asarray(initvals.get("z"), dtype) if initvals.get("z")
                    is not None else e0)
        else:
            defaults = {"x": jnp.zeros((n,), dtype),
                        "y": jnp.zeros((b.shape[0],), dtype),
                        "s": e0, "z": e0}
            init = tuple(
                _asarray(initvals[k], dtype) if initvals.get(k) is not None
                else defaults[k]
                for k in ("x", "y", "s", "z"))

    if custom_y and b is None:
        raise ValueError("custom y vector space requires b")
    state = _coneqp_core(Pa, q, Ga, h, Aa, b, init, dims, o, factor,
                         gmv, amv, pmv, dtype, xops=xops, yops=yops,
                         has_y=(has_y if (custom_x or custom_y) else None))
    (x, y, s, z, it, status, m) = state
    metrics = _qp_metrics_dict(dims, m, s, z)
    return _result_dict(int(status), x, y, s, z, dims, metrics,
                        int(it) - 1)


@functools.lru_cache(maxsize=64)
def _cached_qp_solver_full(dims, kktsolver, o: Options):
    """coneqp solve + slack computation in ONE jitted program."""
    from ..parallel.batch import make_qp_solver
    solve = make_qp_solver(dims, kktsolver, o)

    def full(P, q, G, h, A, b):
        h = cones.sym_from_lower(dims, h)
        G = cones.sym_from_lower_cols(dims, G)
        x, y, s, z, it, status, m = solve(P, q, G, h, A, b)
        ts, tz = cones.max_step2(dims, s, z)
        # scalars ride ONE vector (see _conelp._finalize_pack)
        meta = jnp.stack([
            it.astype(x.dtype), status.astype(x.dtype), -ts, -tz,
            m.pcost, m.dcost, m.gap, m.relgap, m.pres, m.dres])
        return dict(x=x, y=y, s=s, z=z, meta=meta)

    return jax.jit(full)


@functools.lru_cache(maxsize=64)
def _cached_lp_solver_full(dims, kktsolver, o: Options):
    """Solve + result finalization fused into ONE jitted program (see
    _conelp._finalize_pack)."""
    from ..parallel.batch import make_lp_solver
    from ._conelp import _finalize_pack
    solve = make_lp_solver(dims, kktsolver, o)

    def full(c, G, h, A, b):
        h = cones.sym_from_lower(dims, h)
        G = cones.sym_from_lower_cols(dims, G)
        state = solve(c, G, h, A, b)
        return _finalize_pack(state, c, h, b, dims)

    return jax.jit(full)


def _qp_metrics_dict_from_pack(pack):
    """Metrics dict from a fetched fast-path pack whose scalars ride the
    single 'meta' vector: [it, status, slack_s, slack_z, pcost, dcost,
    gap, relgap, pres, dres]."""
    (_, _, slack_s, slack_z, pcost, dcost, gap, relgap, pres,
     dres) = (float(v) for v in pack["meta"])
    return {
        "primal objective": pcost,
        "dual objective": dcost,
        "gap": gap,
        "relative gap": None if not math.isfinite(relgap) else relgap,
        "primal infeasibility": pres,
        "dual infeasibility": dres,
        "primal slack": slack_s,
        "dual slack": slack_z,
    }


def _qp_metrics_dict(dims, m: Metrics, s, z):
    relgap = float(m.relgap)
    return {
        "primal objective": float(m.pcost),
        "dual objective": float(m.dcost),
        "gap": float(m.gap),
        "relative gap": None if not math.isfinite(relgap) else relgap,
        "primal infeasibility": float(m.pres),
        "dual infeasibility": float(m.dres),
        "primal slack": -float(cones.max_step(dims, s)),
        "dual slack": -float(cones.max_step(dims, z)),
    }


def _coneqp_core(Pa, q, Ga, h, Aa, b, init, dims, o: Options, factor,
                 gmv, amv, pmv, dtype, xops: VecOps = DEFAULT_VECOPS,
                 yops: VecOps = DEFAULT_VECOPS, has_y=None):
    """Pure, jit-traceable coneqp driver: the entire IPM is one
    lax.while_loop; returns the final state as arrays (no host syncs).

    x and y live in abstract vector spaces given by `xops`/`yops`
    (reference coneprog.py:378-402 custom vector spaces); the defaults
    handle arrays and arbitrary pytrees."""
    p = has_y if has_y is not None else (
        jax.tree_util.tree_leaves(b)[0].shape[0]
        if jax.tree_util.tree_leaves(b) else 0)
    deg = dims.degree
    e = cones.cone_e(dims, dtype)

    resx0 = jnp.maximum(1.0, xops.norm(q))
    resy0 = jnp.maximum(1.0, yops.norm(b)) if p else jnp.asarray(
        1.0, dtype)
    resz0 = jnp.maximum(1.0, cones.snrm2(dims, h))

    def newton(solve, lmbda, W, rx, ry, rz, d_target):
        """Solve the Newton system for a given complementarity target."""
        tmp = cones.sinv(dims, lmbda, d_target)          # lambda \ d
        bz = -rz - cones.scale(dims, W, tmp, trans=True)  # -rz - W'(la\d)

        def kkt_solve(bx, by, bzv):
            d0 = solve(bx, by, bzv)
            if not o.refinement:
                return d0

            def refine(i, d):
                dx, dy, dz = d
                # r1 = bx - (P dx + A'dy + G'dz)   (x-space)
                t = pmv(dx)
                if p:
                    t = xops.axpy(amv(dy, trans=True), t)
                t = xops.axpy(gmv(dz, trans=True), t)
                r1 = xops.axpy(t, bx, -1.0)
                # r2 = by - A dx                    (y-space)
                r2 = yops.axpy(amv(dx), by, -1.0) if p else by
                wtwdz = cones.scale(dims, W, cones.scale(dims, W, dz),
                                    trans=True)
                r3 = bzv - (gmv(dx) - wtwdz)
                ex, ey, ez = solve(r1, r2, r3)
                dx = xops.axpy(ex, dx)
                dy = yops.axpy(ey, dy) if p else dy
                return dx, dy, dz + ez

            # fori_loop so the KKT-solve subgraph is instanced once for
            # all refinement passes (compile-time control)
            return jax.lax.fori_loop(0, o.refinement, refine, d0)

        dx, dy, dz = kkt_solve(xops.scal(-1.0, rx),
                               yops.scal(-1.0, ry), bz)
        ds = cones.scale(dims, W,
                         tmp - cones.scale(dims, W, dz), trans=True)
        return dx, dy, dz, ds

    def initial_point():
        if init is not None:
            x0, y0, s0, z0 = init
            return x0, y0, s0, z0
        W0 = cones.identity_scaling(dims, dtype)
        solve0 = factor(W0)
        x0, y0, z0 = solve0(xops.scal(-1.0, q), b, h)
        s0 = -z0
        ts, tz = cones.max_step2(dims, s0, z0)
        s0 = jnp.where(ts >= -1e-8 * jnp.maximum(1.0, jnp.abs(ts)),
                       s0 + (1.0 + ts) * e, s0)
        z0 = jnp.where(tz >= -1e-8 * jnp.maximum(1.0, jnp.abs(tz)),
                       z0 + (1.0 + tz) * e, z0)
        return x0, y0, s0, z0

    def metrics_of(x, y, s, z):
        # rx = P x + q + G'z (+ A'y)   (x-space)
        rx = xops.axpy(pmv(x), xops.axpy(gmv(z, trans=True), q))
        if p:
            rx = xops.axpy(amv(y, trans=True), rx)
        ry = yops.axpy(b, amv(x), -1.0) if p else b
        rz = gmv(x) + s - h
        gap = cones.sdot(dims, s, z)
        pcost = 0.5 * xops.dot(x, pmv(x)) + xops.dot(q, x)
        dcost = pcost + (yops.dot(y, ry) if p else 0.0) + \
            cones.sdot(dims, z, rz) - gap
        pres = jnp.maximum(
            yops.norm(ry) / resy0 if p else 0.0,
            cones.snrm2(dims, rz) / resz0)
        dres = xops.norm(rx) / resx0
        return rx, ry, rz, Metrics(pcost, dcost, gap,
                                   _relgap(gap, pcost, dcost), pres, dres)

    def body(carry):
        x, y, s, z, it, status, _ = carry
        rx, ry, rz, m = metrics_of(x, y, s, z)
        if o.show_progress:
            jax.debug.print(
                "{it:2d}: {pc: .4e} {dc: .4e} {gap: .0e} {pr: .0e} {dr: .0e}",
                it=it, pc=m.pcost, dc=m.dcost, gap=m.gap, pr=m.pres,
                dr=m.dres)
        converged = (m.pres <= o.feastol) & (m.dres <= o.feastol) & (
            (m.gap <= o.abstol) | (jnp.isfinite(m.relgap) &
                                   (m.relgap <= o.reltol)))
        new_status = jnp.where(
            converged, OPTIMAL, jnp.where(it >= o.maxiters, UNKNOWN, RUNNING))

        def do_step(args):
            x, y, s, z = args
            W, lmbda = cones.compute_scaling(dims, s, z)
            solve = factor(W)
            lmbdasq = cones.ssqr(dims, lmbda)
            mu = m.gap / deg

            # Mehrotra predictor (i=0) then corrector (i=1) as one
            # lax.scan so the Newton-solve subgraph is instanced once
            # (compile-time control); the step-limit quantities ride the
            # carry between the two phases.
            def phase(carry, i):
                dxp, dyp, dzp, dsp, dsw_p, dzw_p, tinv_p = carry

                # Both phase targets are cheap elementwise work, so an
                # arithmetic select beats lax.cond here: cond nested in
                # scan nested in while_loop compiles slowly.  At i=0 the
                # carry is all-zero, making the combined-target
                # expression finite and discarded.
                stp = jnp.where(tinv_p <= 0.0, 1.0,
                                jnp.minimum(1.0, 1.0 / tinv_p))
                mu_aff = cones.sdot(dims, s + stp * dsp,
                                    z + stp * dzp) / deg
                sigma = jnp.clip(mu_aff / mu, 0.0, 1.0) ** EXPON
                combined = (-lmbdasq - cones.sprod(dims, dsw_p, dzw_p) +
                            sigma * mu * e)
                d_t = jnp.where(i == 0, -lmbdasq, combined)
                dx, dy, dz, ds = newton(solve, lmbda, W, rx, ry, rz, d_t)
                ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
                dz_w = cones.scale(dims, W, dz)
                ts, tz = cones.max_step2(
                    dims, cones.scale2(dims, lmbda, ds_w),
                    cones.scale2(dims, lmbda, dz_w))
                tinv = jnp.maximum(jnp.maximum(ts, tz), 0.0)
                return (dx, dy, dz, ds, ds_w, dz_w, tinv), None

            zero_carry = (xops.zero(x), yops.zero(y), jnp.zeros_like(z),
                          jnp.zeros_like(s), jnp.zeros_like(s),
                          jnp.zeros_like(z), jnp.asarray(0.0, dtype))
            (dx, dy, dz, ds, ds_w, dz_w, tinv), _ = jax.lax.scan(
                phase, zero_carry, jnp.arange(2))
            step = jnp.minimum(
                STEP * jnp.where(tinv <= 0.0, 1.0 / STEP,
                                 jnp.minimum(1.0 / STEP, 1.0 / tinv)),
                1.0)

            xn = xops.axpy(dx, x, step)
            yn = yops.axpy(dy, y, step) if p else y
            sn = s + step * ds
            zn = z + step * dz
            bad = ~jnp.isfinite(xops.dot(xn, xn) + jnp.dot(sn, sn) +
                                jnp.dot(zn, zn))
            st = jnp.where(bad, jnp.int32(SINGULAR), jnp.int32(RUNNING))
            xn = _tree_select(bad, x, xn)
            yn = _tree_select(bad, y, yn)
            sn = jnp.where(bad, s, sn)
            zn = jnp.where(bad, z, zn)
            return xn, yn, sn, zn, st

        def no_step(args):
            x, y, s, z = args
            return x, y, s, z, new_status.astype(jnp.int32)

        xn, yn, sn, zn, st = jax.lax.cond(
            new_status == RUNNING, do_step, no_step, (x, y, s, z))
        return xn, yn, sn, zn, it + 1, st, m

    def cond(carry):
        return carry[5] == RUNNING

    if o.show_progress:
        print("     pcost       dcost       gap    pres   dres")
    x0, y0, s0, z0 = initial_point()
    _, _, _, m0 = metrics_of(x0, y0, s0, z0)
    carry0 = (x0, y0, s0, z0, jnp.int32(0), jnp.int32(RUNNING), m0)
    return jax.lax.while_loop(cond, body, carry0)


def qp(P, q, G=None, h=None, A=None, b=None, solver=None, initvals=None,
       kktsolver=None, options=None):
    """Natural-form QP (reference coneprog.py:4187): minimize
    (1/2)x'Px + q'x s.t. Gx <= h, Ax = b.  solver in (None, 'osqp',
    'mosek', 'gurobi') per the reference's dispatch
    (coneprog.py:4374-4426)."""
    if solver == "osqp":
        from .. import osqp as _osqp
        return _osqp.qp_bridge(P, q, G, h, A, b, options=options)
    if solver == "gurobi":
        from .. import gurobi as _gurobi
        from ._conelp import _bridge_cone_result
        opts = (options or {}).get("gurobi")
        status, x, z, y = _gurobi.qp(q, G, h, A, b, P, options=opts)
        ml = 0 if h is None else np.asarray(h).size
        return _bridge_cone_result(status, x, z, y, q, G, h, A, b,
                                   ml, [], P=P)
    if solver == "mosek":
        from .. import msk
        from ._conelp import _mosek_cone_result
        opts = (options or {}).get("mosek")
        if opts:
            solsta, x, z, y = msk.qp(P, q, G, h, A, b, options=opts)
        else:
            solsta, x, z, y = msk.qp(P, q, G, h, A, b)
        ml = 0 if h is None else np.asarray(h).size
        return _mosek_cone_result(solsta, x, z, y, q, G, h, A, b,
                                  ml, [], P=P)
    if G is None and h is None:
        raise ValueError("qp requires inequality constraints G, h")
    h = np.asarray(h, dtype=float).reshape(-1)
    return coneqp(P, q, G, h, {"l": h.shape[0]}, A, b, initvals=initvals,
                  kktsolver=kktsolver, options=options)


# ---------------------------------------------------------------------------
# conelp (filled in below, same machinery plus the self-dual embedding)
# ---------------------------------------------------------------------------

from ._conelp import conelp, lp, socp, sdp  # noqa: E402,F401
