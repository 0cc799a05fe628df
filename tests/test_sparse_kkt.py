"""Sparse-KKT LP through a custom kktsolver with host-side native
refactorization (BASELINE.md config 'Sparse-KKT LP with bcsstk
structure').

The architecture mirrors the reference's symbolic/numeric split
(klu.c:234-302): symbolic analysis of the fixed K = G' D^-2 G pattern
happens once on the host; each IPM iteration refactors numerically in
the native C++ LDL' and solves — invoked from inside the jitted
lax.while_loop via jax.pure_callback."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from kvxopt_tpu import cholmod
from kvxopt_tpu.base import spmatrix
from kvxopt_tpu.cones import ConeDims
from kvxopt_tpu.solvers import conelp


def banded_G(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(k)) * (1.0 / (1 + abs(k)))
             for k in range(-bw, bw + 1)]
    G0 = sp.diags(diags, range(-bw, bw + 1), format="csc")
    G0 = G0 + sp.eye(n) * (bw + 1.0)
    return G0


def test_sparse_kkt_lp_host_refactor():
    n = 120
    G0 = banded_G(n, 3)
    # LP: bounds via sparse G rows + box rows to make it solvable
    G = sp.vstack([G0, sp.eye(n), -sp.eye(n)]).tocsc()
    N = G.shape[0]
    rng = np.random.default_rng(1)
    x_feas = rng.standard_normal(n) * 0.1
    h = np.concatenate([G0 @ x_feas + rng.uniform(0.5, 1.5, n),
                        np.full(n, 3.0), np.full(n, 3.0)])
    c = rng.standard_normal(n)

    # host-side machinery: symbolic once on the K = G'D^-2 G pattern
    Gh = G.copy()
    pattern_K = (Gh.T @ Gh).tocsc()
    sym = cholmod.symbolic(spmatrix._from_csc(pattern_K))
    refactor_count = [0]

    def host_solve(d, f):
        d = np.asarray(d, dtype=np.float64)
        f = np.asarray(f, dtype=np.float64)
        Dinv2 = sp.diags(1.0 / d ** 2)
        K = (Gh.T @ Dinv2 @ Gh).tocsc()
        cholmod.numeric(spmatrix._from_csc(K), sym)  # native refactor
        refactor_count[0] += 1
        from kvxopt_tpu.base import matrix as dmat
        B = dmat(f.reshape(-1, 1))
        cholmod.solve(sym, B)
        return np.asarray(B).reshape(-1)

    Gd = jnp.asarray(G.toarray())

    def kktsolver(W, H=None, Df=None):
        d = W.d

        def solve(bx, by, bz):
            f = bx + Gd.T @ (bz / d ** 2)
            ux = jax.pure_callback(
                host_solve, jax.ShapeDtypeStruct((n,), bx.dtype), d, f)
            uz = (Gd @ ux - bz) / d ** 2
            return ux, jnp.zeros((0,), bx.dtype), uz

        return solve

    sol = conelp(c, Gd, h, ConeDims(l=N), kktsolver=kktsolver,
                 options={"refinement": 1})
    assert sol["status"] == "optimal"
    assert refactor_count[0] > 0  # the host numeric path really ran
    # cross-check against the dense default path
    ref = conelp(c, Gd, h, ConeDims(l=N))
    np.testing.assert_allclose(np.asarray(sol["x"]),
                               np.asarray(ref["x"]), atol=1e-5)
