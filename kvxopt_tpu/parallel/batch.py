"""Scenario batching: solve many cone QPs at once.

The batched analogue of the reference's 'run many CPU solves' workload
(the 'ACTIVSg2000 scenario batch' config of BASELINE.md).  A batch of
problem instances with identical shapes is solved by one jitted program:
vmap over the pure coneqp core, optionally sharded over a 'batch' mesh
axis so scenarios spread across devices with zero communication.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import kkt
from ..cones import ConeDims
from ..solvers.coneprog import Options, _coneqp_core


def make_mesh(n_devices=None, axis_names=("batch",), shape=None):
    """A 1D (or reshaped) mesh over the available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    arr = np.array(devs)
    if shape is not None:
        arr = arr.reshape(shape)
    return Mesh(arr, axis_names)


def make_qp_solver(dims, kktsolver=None, options=None, with_eq=False):
    """Returns a pure function solve(P, q, G, h[, A, b]) -> state tuple
    (x, y, s, z, iterations, status, metrics) suitable for jit / vmap.

    dims and options are static; the KKT factorization strategy defaults to
    'chol' with q/s cones, 'chol2' otherwise (the reference coneqp default,
    coneprog.py:1805-1809).
    """
    dims = ConeDims.from_dict(dims)
    o = options if isinstance(options, Options) else Options(
        **(options or {}))
    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)

    def solve(P, q, G, h, A=None, b=None):
        dtype = q.dtype
        # cast everything to q's dtype: a single float64 operand (easy
        # to produce via numpy promotion, e.g. f32_array / np.sqrt(n))
        # would otherwise leak f64 into the jitted iteration and fail
        # deep inside a lax.cond with mismatched branch dtypes
        P, G, h = (jnp.asarray(a, dtype) for a in (P, G, h))
        if A is None:
            A = jnp.zeros((0, q.shape[0]), dtype)
            b = jnp.zeros((0,), dtype)
        else:
            A = jnp.asarray(A, dtype)
            b = jnp.asarray(b, dtype)
        factor = kkt.make_kkt_solver(kktsolver, dims, G, A, P,
                                     reg=o.kktreg, ozaki=o.ozaki,
                                     facref=o.facref)
        gmv = lambda v, trans=False: (G.T @ v if trans else G @ v)
        amv = lambda v, trans=False: (A.T @ v if trans else A @ v)
        pmv = lambda v: P @ v
        return _coneqp_core(P, q, G, h, A, b, None, dims, o, factor,
                            gmv, amv, pmv, dtype)

    return solve


def make_lp_solver(dims, kktsolver=None, options=None):
    """Pure function solve(c, G, h[, A, b]) -> conelp state tuple
    (x, y, s, z, tau, kappa, iterations, status, metrics) for jit/vmap —
    the conelp analogue of make_qp_solver."""
    from ..solvers._conelp import _conelp_core
    dims = ConeDims.from_dict(dims)
    o = options if isinstance(options, Options) else Options(
        **(options or {}))
    if kktsolver is None:
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)

    def solve(c, G, h, A=None, b=None):
        dtype = c.dtype
        if A is None:
            A = jnp.zeros((0, c.shape[0]), dtype)
            b = jnp.zeros((0,), dtype)
        factor = kkt.make_kkt_solver(kktsolver, dims, G, A, None,
                                     reg=o.kktreg, ozaki=o.ozaki,
                                     facref=o.facref)
        gmv = lambda v, trans=False: (G.T @ v if trans else G @ v)
        amv = lambda v, trans=False: (A.T @ v if trans else A @ v)
        return _conelp_core(c, G, h, A, b, dims, o, factor, gmv, amv,
                            dtype, None, None)

    return solve


def _vmap_facref(options):
    """Factor refinement for VMAPPED drivers: off unless asked for.  Its
    setup runs two n-RHS triangular solves per lane, which XLA expands
    lane by lane under vmap.  Explicit True/False still wins."""
    o = options if isinstance(options, Options) else Options(
        **(options or {}))
    return o._replace(facref=False) if o.facref is None else o


def batched_lp_solver(dims, kktsolver=None, options=None, mesh=None):
    """vmap (optionally pjit over mesh axis 'batch') of make_lp_solver."""
    solve_one = make_lp_solver(dims, kktsolver, _vmap_facref(options))
    vsolve = jax.vmap(solve_one)
    if mesh is None:
        return jax.jit(vsolve)
    shard = NamedSharding(mesh, P("batch"))
    return jax.jit(vsolve, in_shardings=(shard,) * 3)


def batched_qp_solver_mixed(dims, options=None, mesh=None, with_eq=False):
    """Two-pass batched mixed-precision QP driver (host-orchestrated).

    Pass 1 solves every lane in one vmapped program with the
    'chol2_mixed_nofb' KKT strategy: float32 factorizations plus
    float64 operator-form iterative refinement, with NO per-lane f64
    fallback — under vmap `lax.cond` lowers to a select, so the fallback
    branch of plain 'chol2_mixed' would execute (and pay the f64
    factorization) for every lane.

    Lanes whose pass-1 status is not 'optimal' (rare: the refinement
    stalls only when cond(K) approaches 1/eps_f32) are re-solved on the
    host side with the all-f64 batched path, padded to power-of-two
    sub-batch sizes so repeat calls reuse at most log2(B) compiled
    programs.

    Returns solve(P, q, G, h) -> (x, y, s, z, iterations, status,
    metrics) with numpy-backed leaves (host orchestration fetches them
    anyway)."""
    from ..solvers.coneprog import OPTIMAL
    # force the exact-split refinement matvec for the vmapped fast pass:
    # the batch lanes amortize the slice matmuls; explicit options still
    # win
    o = options if isinstance(options, Options) else Options(
        **(options or {}))
    if o.ozaki is None:
        o = o._replace(ozaki=True)
    fast = batched_qp_solver(dims, "chol2_mixed_nofb", o, mesh,
                             with_eq)
    slow_cache = {}

    def _slow(k):
        if k not in slow_cache:
            slow_cache[k] = batched_qp_solver(dims, "chol2", options,
                                              None, with_eq)
        return slow_cache[k]

    def solve(P, q, G, h, *ab):
        out_t = fast(P, q, G, h, *ab)
        flat, treedef = jax.tree_util.tree_flatten(out_t)
        out = jax.tree_util.tree_unflatten(
            treedef, [np.asarray(o) for o in flat])
        status = np.asarray(out[5])
        bad = np.nonzero(status != OPTIMAL)[0]
        if bad.size == 0:
            return out
        k = 1 << (int(bad.size) - 1).bit_length()   # next power of two
        idx = np.concatenate([bad, np.repeat(bad[:1], k - bad.size)])
        sub = [np.asarray(a)[idx] for a in (P, q, G, h, *ab)]
        sout = _slow(k)(*[jnp.asarray(a) for a in sub])
        sflat, streedef = jax.tree_util.tree_flatten(sout)
        sflat = [np.asarray(o) for o in sflat]
        oflat, otreedef = jax.tree_util.tree_flatten(out)
        for i, (o, s) in enumerate(zip(oflat, sflat)):
            o = np.array(o)
            o[bad] = s[: bad.size]
            oflat[i] = o
        return jax.tree_util.tree_unflatten(otreedef, oflat)

    return solve


def batched_qp_solver_seq(dims, kktsolver="chol2_mixed", options=None,
                          with_eq=False, group=1):
    """Sequentially-mapped batch driver: `lax.map` of the
    single-instance solve instead of `vmap`.

    Under vmap every lane pays the batch's WORST-CASE iteration and
    refinement counts (while_loops run until all lanes' conds are
    false, and `lax.cond` lowers to a select so both branches
    execute).  `lax.map` keeps each instance's own trip counts AND a
    real cond, so the per-instance f64-factor fallback of plain
    'chol2_mixed' works — no two-pass host orchestration needed.  Use
    this for batches of LARGE instances; use
    `batched_qp_solver`/`_mixed` for small-instance batches.

    `group` > 1 pipelines that many instances per map step (vmap inside
    lax.map); the f64-factor fallback stays a REAL cond at group
    granularity (`kkt.cond_any` guards it on any(lane bad)); the
    exact-split ozaki matvec is defaulted on for groups.  g>=4 inherits
    the vmapped-mixed lockstep fragility on hard late-stage iterates
    (lanes can hit the non-finite-step exit).  Keep the default group=1
    for production; the knob exists for experiments."""
    if group > 1:
        # grouped lanes amortize the ozaki slice matmuls
        o = options if isinstance(options, Options) else Options(
            **(options or {}))
        if o.ozaki is None:
            options = o._replace(ozaki=True)
    solve_one = make_qp_solver(dims, kktsolver, options, with_eq)

    if group == 1:
        @jax.jit
        def solve(P, q, G, h, *ab):
            args = (P, q, G, h) + ab
            return jax.lax.map(lambda a: solve_one(*a), args)

        return solve

    gsolve = jax.vmap(solve_one)

    @jax.jit
    def solve(P, q, G, h, *ab):
        args = (P, q, G, h) + ab
        B = q.shape[0]
        if B % group:
            raise ValueError(f"batch {B} not divisible by group {group}")
        gargs = tuple(a.reshape((B // group, group) + a.shape[1:])
                      for a in args)
        out = jax.lax.map(lambda a: gsolve(*a), gargs)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((B,) + a.shape[2:]), out)

    return solve


def batched_qp_solver(dims, kktsolver=None, options=None, mesh=None,
                      with_eq=False):
    """vmap (and optionally pjit over mesh axis 'batch') of
    make_qp_solver: solve(P[B], q[B], G[B], h[B]) -> batched state."""
    solve_one = make_qp_solver(dims, kktsolver, _vmap_facref(options),
                               with_eq)
    vsolve = jax.vmap(solve_one)
    if mesh is None:
        return jax.jit(vsolve)
    spec = P("batch")
    shard = NamedSharding(mesh, spec)
    return jax.jit(vsolve, in_shardings=(shard,) * 4,
                   out_shardings=None)
