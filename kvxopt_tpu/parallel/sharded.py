"""Tensor-parallel KKT: row-sharded constraint matrices over a mesh axis.

The condensed KKT system K = P + G' W^{-1} W^{-T} G is a sum over
constraint rows, so with G row-sharded over a 'kkt' mesh axis each device
forms its local normal-equations contribution and a single psum
reduces K; the (small, replicated) Cholesky factorization follows locally.
This mirrors how the reference's structure-exploiting custom kktsolvers
(reference tests/test_custom_kkt.py:11-31) reduce the KKT solve, but
distributed — it is the multi-device analogue of the reference's
"three levels of customization" kktsolver contract
(reference src/python/coneprog.py:286-402).

Two entry points:

- `sharded_kkt_solver(mesh, axis, dims, G, A=None, P=None)`: a first-class
  kktsolver factory for the full product cone (l, q, and s blocks).  The
  returned `factor(W)` closure plugs directly into
  `solvers.conelp(..., kktsolver=...)` / `solvers.coneqp(...)`, so the IPM
  runs end-to-end through the tensor-parallel factorization.  Cone blocks
  are grouped by size and stacked so each device owns whole blocks
  (vmapped block kernels, no straddling), the l part is row-sharded, and
  K is reduced with one psum per factorization.

- `sharded_kkt_factor(mesh, axis, G, d, Pmat=None)`: the round-1
  l-cone-only standalone factor (kept for compatibility; the solver
  factory above supersedes it).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import cones
from ..cones import ConeDims, NTScaling


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m if x else 0


class _ConeShards:
    """Static row-decomposition of a cone-structured matrix G for sharding:
    the l part padded to a multiple of the device count, q and s blocks
    grouped by size and stacked (count padded likewise) so every device
    owns an equal number of whole blocks."""

    def __init__(self, mesh: Mesh, axis: str, dims: ConeDims, G):
        self.mesh = mesh
        self.axis = axis
        self.dims = dims
        # axis may be one mesh axis name or a tuple of names (psum over
        # the tuple reduces over every device the axes span)
        self.ndev = (int(np.prod([mesh.shape[a] for a in axis]))
                     if isinstance(axis, tuple) else mesh.shape[axis])
        self.n = G.shape[1]
        self.dtype = G.dtype
        nd = self.ndev

        # --- l part ---
        self.lpad = max(_ceil_to(dims.l, nd), nd)  # always present: keeps
        # the shard_map body uniform; zero rows contribute nothing
        Gl = jnp.zeros((self.lpad, self.n), self.dtype)
        if dims.l:
            Gl = Gl.at[: dims.l].set(G[: dims.l])
        self.Gl = jax.device_put(Gl, NamedSharding(mesh, P(axis, None)))

        # --- q groups (size -> (stacked G blocks, block offsets)) ---
        self.qgroups = []  # (m, cpad, idxs, Gq sharded)
        bysize = {}
        for k, m in enumerate(dims.q):
            bysize.setdefault(m, []).append(k)
        for m, idxs in sorted(bysize.items()):
            cpad = _ceil_to(len(idxs), nd)
            Gq = jnp.zeros((cpad, m, self.n), self.dtype)
            for j, k in enumerate(idxs):
                ofs = dims.qofs[k]
                Gq = Gq.at[j].set(G[ofs:ofs + m])
            Gq = jax.device_put(Gq, NamedSharding(mesh, P(axis, None, None)))
            self.qgroups.append((m, cpad, idxs, Gq))

        # --- s groups ---
        self.sgroups = []  # (m, cpad, idxs, Gs sharded (cpad, m*m, n))
        bysize = {}
        for k, m in enumerate(dims.s):
            bysize.setdefault(m, []).append(k)
        for m, idxs in sorted(bysize.items()):
            cpad = _ceil_to(len(idxs), nd)
            Gs = jnp.zeros((cpad, m * m, self.n), self.dtype)
            for j, k in enumerate(idxs):
                ofs = dims.sofs[k]
                Gs = Gs.at[j].set(G[ofs:ofs + m * m])
            Gs = jax.device_put(Gs, NamedSharding(mesh, P(axis, None, None)))
            self.sgroups.append((m, cpad, idxs, Gs))

    # ---- stacking of per-iteration data (scalings, cone vectors) ----

    def stack_scaling(self, W: NTScaling):
        """Stack the NT scaling into per-group arrays matching the G
        shards (padded entries get identity scalings; their G rows are
        zero so they contribute nothing)."""
        d = jnp.ones((self.lpad,), self.dtype)
        if self.dims.l:
            d = d.at[: self.dims.l].set(W.d)
        qparts = []
        for m, cpad, idxs, _ in self.qgroups:
            beta = jnp.ones((cpad,), self.dtype)
            v = jnp.zeros((cpad, m), self.dtype).at[:, 0].set(1.0)
            for j, k in enumerate(idxs):
                beta = beta.at[j].set(W.beta[k])
                v = v.at[j].set(W.v[k])
            qparts.append((beta, v))
        sparts = []
        for m, cpad, idxs, _ in self.sgroups:
            rti = jnp.tile(jnp.eye(m, dtype=self.dtype)[None], (cpad, 1, 1))
            for j, k in enumerate(idxs):
                rti = rti.at[j].set(W.rti[k])
            sparts.append(rti)
        return d, qparts, sparts

    def stack_vec(self, u):
        """Cone vector -> (l part padded, per-q-group (cpad, m), per-s-group
        (cpad, m*m)) stacks matching the G shards."""
        ul = jnp.zeros((self.lpad,), u.dtype)
        if self.dims.l:
            ul = ul.at[: self.dims.l].set(u[: self.dims.l])
        uq = []
        for m, cpad, idxs, _ in self.qgroups:
            blk = jnp.zeros((cpad, m), u.dtype)
            for j, k in enumerate(idxs):
                ofs = self.dims.qofs[k]
                blk = blk.at[j].set(u[ofs:ofs + m])
            uq.append(blk)
        us = []
        for m, cpad, idxs, _ in self.sgroups:
            blk = jnp.zeros((cpad, m * m), u.dtype)
            for j, k in enumerate(idxs):
                ofs = self.dims.sofs[k]
                blk = blk.at[j].set(u[ofs:ofs + m * m])
            us.append(blk)
        return ul, uq, us

    def unstack_vec(self, ul, uq, us):
        """Inverse of stack_vec: reassemble a flat cone vector."""
        out = jnp.zeros((self.dims.size,), ul.dtype)
        if self.dims.l:
            out = out.at[: self.dims.l].set(ul[: self.dims.l])
        for (m, cpad, idxs, _), blk in zip(self.qgroups, uq):
            for j, k in enumerate(idxs):
                ofs = self.dims.qofs[k]
                out = out.at[ofs:ofs + m].set(blk[j])
        for (m, cpad, idxs, _), blk in zip(self.sgroups, us):
            for j, k in enumerate(idxs):
                ofs = self.dims.sofs[k]
                out = out.at[ofs:ofs + m * m].set(blk[j])
        return out


def _scale_shards(shards: _ConeShards):
    """shard_map body pieces: scaled shards Gs = W^{-T} G per group."""

    def scaled_local(Gl, dl, qargs, sargs):
        Gsl = Gl / dl[:, None]
        Sq = []
        for (m, _, _, _), (Bq, beta, v) in zip(shards.qgroups, qargs):
            sgn = jnp.ones((m,), Bq.dtype).at[1:].set(-1.0)
            Jv = v * sgn[None, :]
            JB = Bq * sgn[None, :, None]
            JvB = jnp.einsum("bm,bmn->bn", Jv, Bq)
            Sq.append((2.0 * Jv[:, :, None] * JvB[:, None, :] - JB)
                      / beta[:, None, None])
        Ss = []
        for (m, _, _, _), (Bs, rti) in zip(shards.sgroups, sargs):
            B = Bs.reshape(Bs.shape[0], m, m, shards.n)
            V = jnp.einsum("bji,bjkc,bkl->bilc", rti, B, rti)
            Ss.append(V.reshape(Bs.shape[0], m * m, shards.n))
        return Gsl, Sq, Ss

    return scaled_local


_DIST_FACTORIES: dict = {}


def _dist_factory(mesh, axis, npad, nb):
    key = (id(mesh), tuple(axis) if isinstance(axis, tuple) else axis,
           npad, nb)
    if key not in _DIST_FACTORIES:
        from .dist_chol import dist_chol_factory
        _DIST_FACTORIES[key] = dist_chol_factory(mesh, axis, npad, nb)
    return _DIST_FACTORIES[key]


def sharded_kkt_solver(mesh: Mesh, axis: str, dims, G, A=None, Pmat=None,
                       reg: float = 0.0, dist_nb: int = 0):
    """First-class tensor-parallel kktsolver for conelp/coneqp.

    Returns factor(W) -> solve(bx, by, bz) -> (ux, uy, uz) solving

        [ P    A'   G'  ] [ux]   [bx]
        [ A    0    0   ] [uy] = [by]
        [ G    0  -W'W  ] [uz]   [bz]

    with G row-sharded over `axis` of `mesh` (full l/q/s cone support).
    The scaled normal-equations matrix K = P + Gs'Gs (Gs = W^{-T}G) is
    formed locally per device and reduced with one psum; by default the
    (n x n) Cholesky and the A Schur complement are replicated.  With
    `dist_nb` > 0 the Cholesky of K runs as the block-cyclic DISTRIBUTED
    factorization of parallel/dist_chol.py with block size dist_nb (K
    padded to a multiple of dist_nb * ndev) — the path for a single KKT
    matrix larger than one chip's HBM.  Per-solve communication: one
    psum of an n-vector plus one all-gather of the cone vector (plus, in
    the distributed mode, one panel-column psum per block step).
    """
    dims = ConeDims.from_dict(dims)
    G = jnp.asarray(G)
    n = G.shape[1]
    dtype = G.dtype
    Aa = jnp.asarray(A) if A is not None else jnp.zeros((0, n), dtype)
    p = Aa.shape[0]
    Pa = jnp.asarray(Pmat) if Pmat is not None else None

    shards = _ConeShards(mesh, axis, dims, G)
    nq, ns = len(shards.qgroups), len(shards.sgroups)

    gspec = P(axis, None)
    dspec = P(axis)
    g3 = P(axis, None, None)
    rep2 = P(None, None)

    # flat in_specs for the shard_map: Gl, d, then per q group (G, beta, v),
    # then per s group (G, rti)
    form_in = [gspec, dspec]
    for _ in shards.qgroups:
        form_in += [g3, dspec, gspec]
    for _ in shards.sgroups:
        form_in += [g3, g3]
    form_out = ([rep2, gspec] + [g3] * nq + [g3] * ns)

    @partial(shard_map, mesh=mesh, in_specs=tuple(form_in),
             out_specs=tuple(form_out))
    def form_K(Gl, dl, *rest):
        qargs = [(rest[3 * i], rest[3 * i + 1], rest[3 * i + 2])
                 for i in range(nq)]
        sargs = [(rest[3 * nq + 2 * i], rest[3 * nq + 2 * i + 1])
                 for i in range(ns)]
        Gsl, Sq, Ss = _scale_shards(shards)(Gl, dl, qargs, sargs)
        K = Gsl.T @ Gsl
        for S in Sq:
            K = K + jnp.einsum("bmn,bmp->np", S, S)
        for S in Ss:
            K = K + jnp.einsum("bmn,bmp->np", S, S)
        K = jax.lax.psum(K, axis)
        return (K, Gsl, *Sq, *Ss)

    # Gs' u with u stacked like the shards (psum-reduced n-vector)
    matT_in = ([gspec, dspec] + [g3, dspec] * nq + [g3, dspec] * ns)

    @partial(shard_map, mesh=mesh, in_specs=tuple(matT_in),
             out_specs=P(None))
    def matT(Gsl, ul, *rest):
        out = Gsl.T @ ul
        for i in range(nq):
            S, u = rest[2 * i], rest[2 * i + 1]
            out = out + jnp.einsum("bmn,bm->n", S, u)
        for i in range(ns):
            S, u = rest[2 * nq + 2 * i], rest[2 * nq + 2 * i + 1]
            out = out + jnp.einsum("bmn,bm->n", S, u)
        return jax.lax.psum(out, axis)

    # Gs x -> stacked shards
    mat_in = ([gspec] + [g3] * (nq + ns) + [P(None)])
    mat_out = ([dspec] + [dspec] * nq + [dspec] * ns)

    @partial(shard_map, mesh=mesh, in_specs=tuple(mat_in),
             out_specs=tuple(mat_out))
    def mat(Gsl, *rest):
        x = rest[-1]
        outs = [Gsl @ x]
        for S in rest[:-1]:
            outs.append(jnp.einsum("bmn,n->bm", S, x))
        return tuple(outs)

    eyen = jnp.eye(n, dtype=dtype)

    def factor(W, H=None, Df=None):
        """factor(W[, H, Df]): with a nonlinear block Df (mnl rows, the
        cpl contract — reference misc.py 'dnl' scaling), the Df rows are
        treated replicated (they change every iteration and are small),
        while the static cone rows of G stay sharded."""
        mnl = Df.shape[0] if Df is not None else 0
        if mnl:
            # W is for dims.with_extra_l(mnl): the leading mnl entries of
            # W.d scale the nonlinear rows
            Wcone = W._replace(d=W.d[mnl:])
            dnl = W.d[:mnl]
            Dfs = Df / dnl[:, None]
        else:
            Wcone = W
        d, qparts, sparts = shards.stack_scaling(Wcone)
        args = [shards.Gl, d]
        for (m, cpad, idxs, Gq), (beta, v) in zip(shards.qgroups, qparts):
            args += [Gq, beta, v]
        for (m, cpad, idxs, Gs), rti in zip(shards.sgroups, sparts):
            args += [Gs, rti]
        out = form_K(*args)
        K, Gsl = out[0], out[1]
        Sq = list(out[2:2 + nq])
        Ss = list(out[2 + nq:])
        if Pa is not None:
            K = K + Pa
        if H is not None:
            K = K + H
        if mnl:
            K = K + Dfs.T @ Dfs
        if reg:
            K = K + reg * eyen
        if dist_nb:
            # block-cyclic distributed factorization over this axis
            from .dist_chol import (dist_chol_factory, cyclic_pack,
                                    _ndev)
            ndev = _ndev(mesh, axis)
            npad = -(-n // (dist_nb * ndev)) * (dist_nb * ndev)
            Kp = jnp.zeros((npad, npad), K.dtype)
            Kp = Kp.at[:n, :n].set(K)
            Kp = Kp.at[jnp.arange(n, npad),
                       jnp.arange(n, npad)].set(1.0)
            dfac, dsolve = _dist_factory(mesh, axis, npad, dist_nb)
            Kst, _ = cyclic_pack(Kp, dist_nb, ndev)
            Lst = dfac(Kst)

            def chosolve(b):
                if b.ndim == 1:
                    bp = jnp.zeros((npad,), b.dtype).at[:n].set(b)
                    return dsolve(Lst, bp)[:n]
                cols = [dsolve(Lst, jnp.zeros((npad,), b.dtype)
                               .at[:n].set(b[:, j]))[:n]
                        for j in range(b.shape[1])]
                return jnp.stack(cols, axis=1)
        else:
            L = jnp.linalg.cholesky(K)

            def chosolve(b):
                y = solve_triangular(L, b, lower=True)
                return solve_triangular(L.T, y, lower=False)

        if p:
            KiAt = chosolve(Aa.T)
            S = Aa @ KiAt
            if reg:
                S = S + reg * jnp.eye(p, dtype=dtype)
            Ls = jnp.linalg.cholesky(S)

            def schursolve(b):
                y = solve_triangular(Ls, b, lower=True)
                return solve_triangular(Ls.T, y, lower=False)

        def solve(bx, by, bz):
            # bz covers [nonlinear rows | cone rows]; the cone rows use
            # the sharded scaled shards, the nl rows stay replicated
            bznl = bz[:mnl]
            bzc = bz[mnl:]
            bzs = cones.scale(dims, Wcone, bzc, trans=True, inverse=True)
            ul, uq, us = shards.stack_vec(bzs)
            f = bx + matT(Gsl, ul, *[x for pair in zip(Sq, uq)
                                     for x in pair],
                          *[x for pair in zip(Ss, us) for x in pair])
            if mnl:
                bznl_s = bznl / dnl
                f = f + Dfs.T @ bznl_s
            if p:
                Kif = chosolve(f)
                uy = schursolve(Aa @ Kif - by)
                ux = Kif - KiAt @ uy
            else:
                ux = chosolve(f)
                uy = jnp.zeros((0,), dtype=bx.dtype)
            w = mat(Gsl, *Sq, *Ss, ux)
            gx = shards.unstack_vec(w[0], list(w[1:1 + nq]),
                                    list(w[1 + nq:]))
            uz = cones.scale(dims, Wcone, gx - bzs, inverse=True)
            if mnl:
                uznl = (Dfs @ ux - bznl_s) / dnl
                uz = jnp.concatenate([uznl, uz])
            return ux, uy, uz

        return solve

    return factor


def sharded_kkt_factor(mesh: Mesh, axis: str, G, d, Pmat=None):
    """Factor K = Pmat + G' diag(d)^{-2} G with G and d row-sharded over
    `axis` (l-cone scaling W = diag(d)).  Returns solve(bx, bz) -> (ux, uz)
    for the 2x2 system [P+G'D^{-2}G] ux = bx + G'D^{-2}bz; uz =
    D^{-2}(G ux - bz), computed with one psum per product.

    (Round-1 standalone path; `sharded_kkt_solver` is the full-cone,
    IPM-pluggable generalization.)
    """
    n = G.shape[1]

    gspec = P(axis, None)
    dspec = P(axis)
    rep = P(None, None)

    @partial(shard_map, mesh=mesh,
             in_specs=(gspec, dspec, rep if Pmat is not None else P()),
             out_specs=rep)
    def form_K(Gl, dl, Pl):
        Gs = Gl / dl[:, None]
        Kl = Gs.T @ Gs
        K = jax.lax.psum(Kl, axis)
        if Pmat is not None:
            K = K + Pl
        return K

    Pm = Pmat if Pmat is not None else jnp.zeros((1, 1), G.dtype)
    K = form_K(G, d, Pm)
    L = jnp.linalg.cholesky(K)

    def solve(bx, bz):
        # rhs = bx + G' D^{-2} bz  (bz sharded like d)
        @partial(shard_map, mesh=mesh, in_specs=(gspec, dspec, dspec),
                 out_specs=P(None))
        def rhs_fn(Gl, dl, bzl):
            return jax.lax.psum(Gl.T @ (bzl / dl ** 2), axis)

        rhs = bx + rhs_fn(G, d, bz)
        y = solve_triangular(L, rhs, lower=True)
        ux = solve_triangular(L.T, y, lower=False)

        @partial(shard_map, mesh=mesh, in_specs=(gspec, dspec, dspec,
                                                 P(None)),
                 out_specs=dspec)
        def uz_fn(Gl, dl, bzl, uxr):
            return (Gl @ uxr - bzl) / dl ** 2

        uz = uz_fn(G, d, bz, ux)
        return ux, uz

    return solve, K
