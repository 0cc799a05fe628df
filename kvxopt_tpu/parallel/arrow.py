"""Arrow (bordered block-diagonal) KKT factorization.

The structured equivalent of the reference's sparse KKT factorizations
for scenario-coupled problems (the BASELINE.md 'ACTIVSg2000 scenario
batch' shape): B independent diagonal blocks coupled through a small set
of shared variables,

    K = [ D_1            C_1 ]
        [      ...       ... ]
        [           D_B  C_B ]
        [ C_1' ...  C_B'  E  ]

Factorization: batched Cholesky of the D_i (one vmap'd program — or
sharded over a 'kkt' mesh axis), Schur complement
S = E - sum_i C_i' D_i^{-1} C_i reduced with a psum, Cholesky of
S replicated.  Solves are batched triangular solves plus a border solve.
This is the device replacement for KLU/CHOLMOD on arrow-structured
power-grid matrices: symbolic structure is the (B, nb, nc) blocking
itself, numeric refactorization is just calling factor again.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def arrow_kkt_factor(D, C, E, mesh: Mesh = None, axis: str = "kkt"):
    """Factor the arrow matrix given blocks D (B, nb, nb), borders
    C (B, nb, nc), corner E (nc, nc).  Returns solve(bblk, bbrd) ->
    (xblk, xbrd) with bblk (B, nb), bbrd (nc,).

    With `mesh`, D/C (and bblk) are expected sharded over `axis`; the
    Schur reduction uses psum over that axis."""
    B, nb, nc = C.shape

    def local_factor(Dl, Cl):
        ch = jax.vmap(lambda Di: cho_factor(Di, lower=True)[0])(Dl)
        DiC = jax.vmap(lambda L, Ci: cho_solve((L, True), Ci))(ch, Cl)
        Sl = jnp.einsum("bij,bik->jk", Cl, DiC)
        return ch, DiC, Sl

    if mesh is None:
        chol_D, DinvC, Ssum = local_factor(D, C)
        S = E - Ssum
    else:
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(axis, None, None), P(axis, None, None)),
                 out_specs=(P(axis, None, None), P(axis, None, None),
                            P(None, None)))
        def sharded_factor(Dl, Cl):
            ch, DiC, Sl = local_factor(Dl, Cl)
            return ch, DiC, jax.lax.psum(Sl, axis)

        chol_D, DinvC, Ssum = sharded_factor(D, C)
        S = E - Ssum
    chol_S = cho_factor(S, lower=True)

    def solve(bblk, bbrd):
        # forward: w_i = D_i^{-1} b_i ; Schur rhs = bbrd - sum C_i' w_i
        if mesh is None:
            w = jax.vmap(lambda L, bi: cho_solve((L, True), bi))(
                chol_D, bblk)
            rhs = bbrd - jnp.einsum("bij,bi->j", C, w)
        else:
            @partial(shard_map, mesh=mesh,
                     in_specs=(P(axis, None, None), P(axis, None),
                               P(axis, None, None)),
                     out_specs=(P(axis, None), P(None)))
            def fwd(chl, bl, Cl):
                wl = jax.vmap(lambda L, bi: cho_solve((L, True), bi))(
                    chl, bl)
                return wl, jax.lax.psum(
                    jnp.einsum("bij,bi->j", Cl, wl), axis)

            w, csum = fwd(chol_D, bblk, C)
            rhs = bbrd - csum
        xbrd = cho_solve(chol_S, rhs)
        # back-substitute: x_i = w_i - D_i^{-1} C_i xbrd
        if mesh is None:
            xblk = w - jnp.einsum("bij,j->bi", DinvC, xbrd)
        else:
            @partial(shard_map, mesh=mesh,
                     in_specs=(P(axis, None), P(axis, None, None),
                               P(None)),
                     out_specs=P(axis, None))
            def back(wl, DiCl, xb):
                return wl - jnp.einsum("bij,j->bi", DiCl, xb)

            xblk = back(w, DinvC, xbrd)
        return xblk, xbrd

    return solve, S
