"""Batched and sharded solves on the virtual 8-device CPU mesh."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from kvxopt_tpu.cones import ConeDims
from kvxopt_tpu.parallel import (make_qp_solver, batched_qp_solver,
                                 make_mesh, sharded_kkt_factor)
from kvxopt_tpu.solvers import qp
from kvxopt_tpu.solvers.coneprog import OPTIMAL


def _random_qp_batch(B, n, m, seed=0):
    rng = np.random.default_rng(seed)
    Ps = np.zeros((B, n, n)); qs = np.zeros((B, n))
    Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    for i in range(B):
        M = rng.standard_normal((n, n))
        Ps[i] = M @ M.T + n * np.eye(n)
        qs[i] = rng.standard_normal(n)
        Gs[i] = rng.standard_normal((m, n))
        hs[i] = Gs[i] @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return (jnp.asarray(Ps), jnp.asarray(qs), jnp.asarray(Gs),
            jnp.asarray(hs))


def test_make_qp_solver_jit():
    Ps, qs, Gs, hs = _random_qp_batch(1, 6, 9)
    solve = jax.jit(make_qp_solver(ConeDims(l=9)))
    x, y, s, z, it, status, m = solve(Ps[0], qs[0], Gs[0], hs[0])
    assert int(status) == OPTIMAL
    # matches the high-level API
    sol = qp(np.asarray(Ps[0]), np.asarray(qs[0]), np.asarray(Gs[0]),
             np.asarray(hs[0]))
    np.testing.assert_allclose(np.asarray(x), np.asarray(sol["x"]),
                               atol=1e-7)


def test_batched_qp_vmap():
    B, n, m = 4, 6, 9
    Ps, qs, Gs, hs = _random_qp_batch(B, n, m, seed=1)
    vsolve = batched_qp_solver(ConeDims(l=m))
    x, y, s, z, it, status, metrics = vsolve(Ps, qs, Gs, hs)
    assert (np.asarray(status) == OPTIMAL).all()
    for i in range(B):
        sol = qp(np.asarray(Ps[i]), np.asarray(qs[i]), np.asarray(Gs[i]),
                 np.asarray(hs[i]))
        np.testing.assert_allclose(np.asarray(x[i]), np.asarray(sol["x"]),
                                   atol=1e-6)


def test_batched_qp_sharded_over_mesh():
    B, n, m = 8, 6, 9
    Ps, qs, Gs, hs = _random_qp_batch(B, n, m, seed=2)
    mesh = make_mesh(8, ("batch",))
    vsolve = batched_qp_solver(ConeDims(l=m), mesh=mesh)
    shard = NamedSharding(mesh, P("batch"))
    args = [jax.device_put(a, shard) for a in (Ps, qs, Gs, hs)]
    x, y, s, z, it, status, metrics = vsolve(*args)
    assert (np.asarray(status) == OPTIMAL).all()


def test_sharded_kkt_factor():
    rng = np.random.default_rng(3)
    n, m = 16, 64  # m rows sharded over 8 devices
    G = jnp.asarray(rng.standard_normal((m, n)))
    d = jnp.asarray(rng.uniform(0.5, 2.0, m))
    Pm = jnp.asarray(np.eye(n))
    mesh = make_mesh(8, ("kkt",))
    gshard = NamedSharding(mesh, P("kkt", None))
    dshard = NamedSharding(mesh, P("kkt"))
    Gd = jax.device_put(G, gshard)
    dd = jax.device_put(d, dshard)
    solve, K = sharded_kkt_factor(mesh, "kkt", Gd, dd, Pmat=Pm)
    Kref = np.eye(n) + np.asarray(G).T @ np.diag(
        1.0 / np.asarray(d) ** 2) @ np.asarray(G)
    np.testing.assert_allclose(np.asarray(K), Kref, rtol=1e-9, atol=1e-9)
    bx = jnp.asarray(rng.standard_normal(n))
    bz = jax.device_put(jnp.asarray(rng.standard_normal(m)), dshard)
    ux, uz = solve(bx, bz)
    # verify: K ux = bx + G'D^{-2}bz ; uz = D^{-2}(G ux - bz)
    np.testing.assert_allclose(
        Kref @ np.asarray(ux),
        np.asarray(bx) + np.asarray(G).T @ (np.asarray(bz) /
                                            np.asarray(d) ** 2),
        rtol=1e-8, atol=1e-8)


def test_batched_lp_vmap():
    import jax.numpy as jnp
    from kvxopt_tpu.parallel import batched_lp_solver
    from kvxopt_tpu.solvers import lp
    rng = np.random.default_rng(4)
    B, n, m = 3, 5, 12
    cs = np.zeros((B, n)); Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    for i in range(B):
        cs[i] = rng.standard_normal(n)
        Gs[i] = np.vstack([rng.standard_normal((m - 2 * n, n)),
                           np.eye(n), -np.eye(n)])
        hs[i] = np.concatenate([rng.uniform(1, 2, m - 2 * n),
                                np.full(2 * n, 5.0)])
    vsolve = batched_lp_solver(ConeDims(l=m))
    x, y, s, z, tau, kappa, it, status, metrics = vsolve(
        jnp.asarray(cs), jnp.asarray(Gs), jnp.asarray(hs))
    assert (np.asarray(status) == OPTIMAL).all()
    for i in range(B):
        sol = lp(cs[i], Gs[i], hs[i])
        np.testing.assert_allclose(np.asarray(x[i]) / np.asarray(tau[i]),
                                   np.asarray(sol["x"]), atol=1e-5)


def _arrow_data(B, nb, nc, seed=5):
    rng = np.random.default_rng(seed)
    D = np.zeros((B, nb, nb)); C = rng.standard_normal((B, nb, nc))
    for i in range(B):
        M = rng.standard_normal((nb, nb))
        D[i] = M @ M.T + nb * np.eye(nb)
    E = np.eye(nc) * (nc + 10.0)
    # assemble dense for the oracle
    n = B * nb + nc
    K = np.zeros((n, n))
    for i in range(B):
        K[i*nb:(i+1)*nb, i*nb:(i+1)*nb] = D[i]
        K[i*nb:(i+1)*nb, B*nb:] = C[i]
        K[B*nb:, i*nb:(i+1)*nb] = C[i].T
    K[B*nb:, B*nb:] = E
    return D, C, E, K


def test_arrow_kkt_factor():
    import jax.numpy as jnp
    from kvxopt_tpu.parallel import arrow_kkt_factor
    B, nb, nc = 5, 8, 4
    D, C, E, K = _arrow_data(B, nb, nc)
    solve, S = arrow_kkt_factor(jnp.asarray(D), jnp.asarray(C),
                                jnp.asarray(E))
    rng = np.random.default_rng(6)
    bblk = rng.standard_normal((B, nb))
    bbrd = rng.standard_normal(nc)
    xblk, xbrd = solve(jnp.asarray(bblk), jnp.asarray(bbrd))
    xfull = np.concatenate([np.asarray(xblk).reshape(-1),
                            np.asarray(xbrd)])
    bfull = np.concatenate([bblk.reshape(-1), bbrd])
    np.testing.assert_allclose(K @ xfull, bfull, atol=1e-8)


def test_arrow_kkt_sharded():
    import jax.numpy as jnp
    from kvxopt_tpu.parallel import arrow_kkt_factor, make_mesh
    B, nb, nc = 8, 8, 4
    D, C, E, K = _arrow_data(B, nb, nc, seed=7)
    mesh = make_mesh(8, ("kkt",))
    shard3 = NamedSharding(mesh, P("kkt", None, None))
    shard2 = NamedSharding(mesh, P("kkt", None))
    Dd = jax.device_put(jnp.asarray(D), shard3)
    Cd = jax.device_put(jnp.asarray(C), shard3)
    solve, S = arrow_kkt_factor(Dd, Cd, jnp.asarray(E), mesh=mesh)
    rng = np.random.default_rng(8)
    bblk = jax.device_put(jnp.asarray(rng.standard_normal((B, nb))),
                          shard2)
    bbrd = jnp.asarray(rng.standard_normal(nc))
    xblk, xbrd = solve(bblk, bbrd)
    xfull = np.concatenate([np.asarray(xblk).reshape(-1),
                            np.asarray(xbrd)])
    bfull = np.concatenate([np.asarray(bblk).reshape(-1),
                            np.asarray(bbrd)])
    np.testing.assert_allclose(K @ xfull, bfull, atol=1e-8)


def test_batched_sdp_vmap():
    """Batched SDP scenarios through the conelp core (eigh under vmap)."""
    import jax.numpy as jnp
    from kvxopt_tpu.parallel import batched_lp_solver
    from kvxopt_tpu.solvers import conelp
    rng = np.random.default_rng(9)
    B, n, m = 3, 2, 2
    dims = ConeDims(l=0, s=(m,))
    cs = np.tile([1.0, 1.0], (B, 1))
    Gs = np.zeros((B, m * m, n))
    hs = np.zeros((B, m * m))
    for i in range(B):
        Gs[i] = np.column_stack([np.diag([-1.0, 0.0]).ravel(),
                                 np.diag([0.0, -1.0]).ravel()])
        off = 1.0 + 0.5 * i
        hs[i] = np.array([[0.0, -off], [-off, 0.0]]).ravel()
    vsolve = batched_lp_solver(dims)
    x, y, s, z, tau, kappa, it, status, metrics = vsolve(
        jnp.asarray(cs), jnp.asarray(Gs), jnp.asarray(hs))
    assert (np.asarray(status) == OPTIMAL).all()
    for i in range(B):
        # x1 x2 >= off^2 with min x1+x2 -> x = (off, off)
        off = 1.0 + 0.5 * i
        np.testing.assert_allclose(
            np.asarray(x[i]) / np.asarray(tau[i]), [off, off], atol=1e-5)


def test_solver_float32_dtype():
    """options['dtype']='float32': the all-f32 fast path at relaxed
    tolerances."""
    from kvxopt_tpu.solvers import qp
    rng = np.random.default_rng(10)
    n, m = 6, 10
    M = rng.standard_normal((n, n)).astype(np.float32)
    P = M @ M.T + n * np.eye(n, dtype=np.float32)
    q = rng.standard_normal(n).astype(np.float32)
    G = rng.standard_normal((m, n)).astype(np.float32)
    h = G @ rng.standard_normal(n).astype(np.float32) + 1.0
    sol = qp(P, q, G, h, options={"dtype": "float32", "abstol": 1e-4,
                                  "reltol": 1e-4, "feastol": 1e-4})
    assert sol["status"] == "optimal"
    assert sol["x"].dtype == np.float32
    ref = qp(np.asarray(P, np.float64), np.asarray(q, np.float64),
             np.asarray(G, np.float64), np.asarray(h, np.float64))
    np.testing.assert_allclose(np.asarray(sol["x"]),
                               np.asarray(ref["x"]), atol=1e-2)


def test_activsg2000_scenario_batch():
    """BASELINE config 5: power-grid scenario batch — LPs built on
    ACTIVSg2000 structure, solved as one batched program sharded over the
    8-device mesh."""
    import os
    path = "/root/reference/tests/ACTIVSg2000.mtx"
    if not os.path.exists(path):
        import pytest
        pytest.skip("ACTIVSg2000.mtx not available")
    import scipy.io
    import jax.numpy as jnp
    from kvxopt_tpu.parallel import batched_lp_solver, make_mesh
    M = scipy.io.mmread(path).tocsc()
    # a structure-bearing principal submatrix (full 4000^2 dense batch is
    # too heavy for the CPU test mesh)
    k = 160
    sub = M[:k, :k].toarray()
    rng = np.random.default_rng(0)
    B = 8
    n = k
    m = 2 * k
    G0 = np.vstack([sub + np.eye(k) * (1.0 + np.abs(sub).sum()),
                    -np.eye(k)])
    cs = np.zeros((B, n)); Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    for i in range(B):
        x0 = rng.standard_normal(n) * 0.1
        s0 = rng.uniform(0.5, 1.5, m)
        hs[i] = G0 @ x0 + s0
        z0 = rng.uniform(0.1, 1.0, m)
        cs[i] = -G0.T @ z0
        Gs[i] = G0
    mesh = make_mesh(8, ("batch",))
    shard = NamedSharding(mesh, P("batch"))
    vsolve = batched_lp_solver(ConeDims(l=m), mesh=mesh)
    args = [jax.device_put(jnp.asarray(a), shard) for a in (cs, Gs, hs)]
    x, y, s, z, tau, kappa, it, status, metrics = vsolve(*args)
    assert (np.asarray(status) == OPTIMAL).all()
    # KKT spot check on one scenario
    i = 3
    xi = np.asarray(x[i]) / float(tau[i])
    zi = np.asarray(z[i]) / float(tau[i])
    assert np.linalg.norm(G0.T @ zi + cs[i]) < 1e-5 * max(
        1, np.linalg.norm(cs[i]))
    assert (G0 @ xi <= hs[i] + 1e-6).all()


# ---------------------------------------------------------------------------
# Full-cone tensor-parallel kktsolver (sharded_kkt_solver)
# ---------------------------------------------------------------------------


def _cone_interior(dims, seed):
    """A strictly interior point of the product cone."""
    r = np.random.default_rng(seed)
    u = np.zeros(dims.size)
    u[:dims.l] = r.uniform(0.5, 2.0, dims.l)
    for ofs, m in zip(dims.qofs, dims.q):
        t = r.standard_normal(m) * 0.1
        t[0] = 1.0 + np.linalg.norm(t[1:])
        u[ofs:ofs + m] = t
    for ofs, m in zip(dims.sofs, dims.s):
        M = r.standard_normal((m, m)) * 0.2
        X = M @ M.T + np.eye(m)
        u[ofs:ofs + m * m] = X.ravel()
    return jnp.asarray(u)


def test_sharded_kkt_solver_matches_dense():
    """The full-cone (l, q, s) sharded factor agrees with kkt_chol2 to
    machine precision on an 8-device mesh."""
    from kvxopt_tpu import kkt
    from kvxopt_tpu.cones import compute_scaling
    from kvxopt_tpu.parallel import sharded_kkt_solver

    rng = np.random.default_rng(0)
    dims = ConeDims(l=7, q=(3, 4, 3), s=(3, 2))
    n, p = 6, 2
    G = jnp.asarray(rng.standard_normal((dims.size, n)))
    A = jnp.asarray(rng.standard_normal((p, n)))
    Pm = jnp.asarray(np.eye(n) * 2.0)
    W, _ = compute_scaling(dims, _cone_interior(dims, 1),
                           _cone_interior(dims, 2))

    mesh = make_mesh(8, ("kkt",))
    solve = sharded_kkt_solver(mesh, "kkt", dims, G, A=A, Pmat=Pm)(W)
    ref = kkt.make_kkt_solver("chol2", dims, G, A, Pm)(W)

    bx = jnp.asarray(rng.standard_normal(n))
    by = jnp.asarray(rng.standard_normal(p))
    bz = _cone_interior(dims, 3)
    ux, uy, uz = solve(bx, by, bz)
    rx, ry, rz = ref(bx, by, bz)
    np.testing.assert_allclose(np.asarray(ux), np.asarray(rx), atol=1e-10)
    np.testing.assert_allclose(np.asarray(uy), np.asarray(ry), atol=1e-10)
    np.testing.assert_allclose(np.asarray(uz), np.asarray(rz), atol=1e-10)


def _symmetrize_sblocks(dims, G):
    """Make the s-block rows of G valid vectorized symmetric matrices."""
    G = np.asarray(G).copy()
    for ofs, m in zip(dims.sofs, dims.s):
        for j in range(G.shape[1]):
            X = G[ofs:ofs + m * m, j].reshape(m, m)
            G[ofs:ofs + m * m, j] = (0.5 * (X + X.T)).ravel()
    return jnp.asarray(G)


def test_coneqp_through_sharded_kkt():
    """End-to-end IPM (coneqp, mixed l/q/s cones) through the
    tensor-parallel factor matches the dense path to 1e-6."""
    from kvxopt_tpu.parallel import sharded_kkt_solver
    from kvxopt_tpu.solvers import coneqp

    rng = np.random.default_rng(5)
    dims = ConeDims(l=6, q=(3, 3), s=(2,))
    n, p = 5, 2
    G = _symmetrize_sblocks(dims, rng.standard_normal((dims.size, n)))
    A = jnp.asarray(rng.standard_normal((p, n)))
    Pm = jnp.asarray(np.eye(n) * 2.0)
    x0 = rng.standard_normal(n)
    h = jnp.asarray(np.asarray(G) @ x0 + np.asarray(_cone_interior(dims, 6)))
    b = jnp.asarray(np.asarray(A) @ x0)
    q = jnp.asarray(rng.standard_normal(n))

    mesh = make_mesh(8, ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, G, A=A, Pmat=Pm)
    sol_sh = coneqp(Pm, q, G, h, dims, A, b, kktsolver=factor)
    sol_dn = coneqp(Pm, q, G, h, dims, A, b)
    assert sol_sh["status"] == "optimal"
    assert sol_dn["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol_sh["x"]),
                               np.asarray(sol_dn["x"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol_sh["z"]),
                               np.asarray(sol_dn["z"]), atol=1e-6)


def test_conelp_through_sharded_kkt():
    """conelp (self-dual embedding) LP through the sharded factor matches
    the dense path and the known optimum."""
    from kvxopt_tpu.parallel import sharded_kkt_solver
    from kvxopt_tpu.solvers import conelp

    rng = np.random.default_rng(7)
    n, m = 4, 16
    G = np.vstack([rng.standard_normal((m - 2 * n, n)), np.eye(n),
                   -np.eye(n)])
    h = np.concatenate([rng.uniform(1, 2, m - 2 * n), np.full(2 * n, 5.0)])
    c = rng.standard_normal(n)
    dims = ConeDims(l=m)
    mesh = make_mesh(8, ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, jnp.asarray(G))
    sol_sh = conelp(c, jnp.asarray(G), jnp.asarray(h), dims,
                    kktsolver=factor)
    sol_dn = conelp(c, jnp.asarray(G), jnp.asarray(h), dims)
    assert sol_sh["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol_sh["x"]),
                               np.asarray(sol_dn["x"]), atol=1e-6)


def test_cpl_through_sharded_kkt():
    """Nonlinear cone program (cpl) running end-to-end through the
    tensor-parallel kktsolver: Df rows replicated, cone rows sharded."""
    from kvxopt_tpu.parallel import sharded_kkt_solver
    from kvxopt_tpu.solvers import cpl
    from kvxopt_tpu.solvers.cvxprog import oracle_from_function

    rng = np.random.default_rng(21)
    n, m = 4, 8
    G = np.vstack([np.eye(n), -np.eye(n)])
    h = np.full(m, 2.0)
    c = rng.standard_normal(n)
    dims = ConeDims(l=m)
    # one smooth constraint: ||x||^2 <= 1
    F = oracle_from_function(
        lambda x: jnp.atleast_1d(jnp.sum(x ** 2) - 1.0), np.zeros(n))

    sol_ref = cpl(c, F, G, h, dims)
    assert sol_ref["status"] == "optimal"

    mesh = make_mesh(8, ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, jnp.asarray(G))
    sol_sh = cpl(c, F, G, h, dims, kktsolver=factor)
    assert sol_sh["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol_sh["x"]),
                               np.asarray(sol_ref["x"]), atol=1e-6)


def test_dist_cholesky_identity():
    from jax.sharding import Mesh
    """Block-cyclic distributed Cholesky over 8 devices: factor identity
    L L' = K and solve round trip, on both a flat 'kkt' axis and a
    two-axis ('row','col') 2x4 mesh."""
    from kvxopt_tpu.parallel import dist_cholesky, cyclic_unpack

    rng = np.random.default_rng(11)
    n, nb = 256, 16   # npad/(nb*ndev) = 2: spans TWO block-column cycles
    M = rng.standard_normal((n, n))
    K = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    meshes = [
        (Mesh(np.array(jax.devices()[:8]), ("kkt",)), "kkt"),
        (Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
              ("row", "col")), ("row", "col")),
    ]
    for mesh, ax in meshes:
        Lst, solve = dist_cholesky(mesh, ax, K, nb)
        L = np.asarray(cyclic_unpack(Lst, nb, 8))
        assert np.allclose(np.tril(L), L)
        np.testing.assert_allclose(L @ L.T, K, atol=1e-8 * n)
        x = np.asarray(solve(Lst, jnp.asarray(b)))
        np.testing.assert_allclose(K @ x, b, atol=1e-8 * n)


def test_sharded_kkt_hierarchical_axis():
    from jax.sharding import Mesh
    """sharded_kkt_solver over a hierarchical ('row','col') axis tuple:
    the psum reduction rides both axes."""
    from kvxopt_tpu.parallel import sharded_kkt_solver
    from kvxopt_tpu import cones, kkt

    rng = np.random.default_rng(12)
    n, m = 24, 64
    G = rng.standard_normal((m, n))
    dims = ConeDims(l=m)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("row", "col"))
    factor = sharded_kkt_solver(mesh, ("row", "col"), dims, G)
    s = np.abs(rng.standard_normal(m)) + 0.5
    z = np.abs(rng.standard_normal(m)) + 0.5
    W, _ = cones.compute_scaling(dims, jnp.asarray(s), jnp.asarray(z))
    solve = factor(W)
    bx = jnp.asarray(rng.standard_normal(n))
    bz = jnp.asarray(rng.standard_normal(m))
    ux, uy, uz = solve(bx, jnp.zeros((0,)), bz)
    # residuals of the 2x2 system [0 G'; G -W'W]
    d2 = np.asarray(W.d) ** 2
    r1 = np.asarray(G.T @ np.asarray(uz) - bx)
    r2 = np.asarray(G @ np.asarray(ux) - d2 * np.asarray(uz) - bz)
    assert np.linalg.norm(r1) < 1e-8
    assert np.linalg.norm(r2) < 1e-8


def test_sharded_kkt_distributed_factor_end_to_end():
    """sharded_kkt_solver(dist_nb=...): the KKT Cholesky runs as the
    block-cyclic distributed factorization while the IPM runs end to end
    (the single-KKT-beyond-one-chip program structure, ROADMAP r3 #8)."""
    from jax.sharding import Mesh
    from kvxopt_tpu.parallel import sharded_kkt_solver
    from kvxopt_tpu.solvers import coneqp

    rng = np.random.default_rng(13)
    n, m = 24, 64
    G = rng.standard_normal((m, n))
    Pm = np.eye(n) * 2.0
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.5, 1.5, m)
    q = rng.standard_normal(n)
    dims = ConeDims(l=m)
    mesh = Mesh(np.array(jax.devices()[:8]), ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, jnp.asarray(G),
                                Pmat=jnp.asarray(Pm), dist_nb=2)
    sol = coneqp(Pm, q, G, h, dims, kktsolver=factor)
    assert sol["status"] == "optimal"
    ref = coneqp(Pm, q, G, h, dims)
    np.testing.assert_allclose(np.asarray(sol["x"]),
                               np.asarray(ref["x"]), atol=1e-6)


def test_batched_qp_solver_seq_matches_vmap():
    """lax.map batch driver (per-instance trip counts, real cond
    fallback) agrees with the vmapped f64 path."""
    from kvxopt_tpu.parallel import batched_qp_solver_seq, batched_qp_solver
    B, n, m = 3, 12, 20
    rng = np.random.default_rng(11)
    Ps = np.zeros((B, n, n)); qs = np.zeros((B, n))
    Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    for i in range(B):
        M = rng.standard_normal((n, n))
        Ps[i] = M @ M.T + n * np.eye(n)
        qs[i] = rng.standard_normal(n)
        Gs[i] = rng.standard_normal((m, n))
        hs[i] = Gs[i] @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    seq = batched_qp_solver_seq(ConeDims(l=m), "chol2")
    ref = batched_qp_solver(ConeDims(l=m), "chol2")
    a = tuple(jnp.asarray(x) for x in (Ps, qs, Gs, hs))
    o1 = seq(*a)
    o2 = ref(*a)
    assert (np.asarray(o1[5]) == 1).all()
    np.testing.assert_allclose(np.asarray(o1[0]), np.asarray(o2[0]),
                               atol=1e-7)

    # the mixed strategy with its per-instance f64 fallback traces under
    # lax.map (cond stays a real cond there)
    seqm = batched_qp_solver_seq(ConeDims(l=m), "chol2_mixed")
    om = seqm(*a)
    assert (np.asarray(om[5]) == 1).all()
    np.testing.assert_allclose(np.asarray(om[0]), np.asarray(o2[0]),
                               atol=1e-6)


@pytest.mark.skipif(os.environ.get("KVX_DRYRUN_SCALE", "0") != "1",
                    reason="full-scale distributed-factor IPM: minutes on "
                           "8 virtual CPU devices; set KVX_DRYRUN_SCALE=1")
def test_distributed_factor_ipm_at_scale():
    """The round-4 dryrun step-5 scale test (n=2048 block-cyclic
    distributed Cholesky + a full n=2048/m=3072 coneqp through the
    distributed factor), moved out of the driver gate per VERDICT r4 #1.
    The gate keeps the same program structure at n=256."""
    from jax.sharding import Mesh
    from kvxopt_tpu.parallel import (dist_cholesky, cyclic_unpack,
                                     sharded_kkt_solver)
    from kvxopt_tpu.solvers import coneqp

    ndev = 8
    hdevs = np.array(jax.devices()[:ndev]).reshape(2, ndev // 2)
    hmesh = Mesh(hdevs, ("row", "col"))
    nkkt = 2048
    nb = nkkt // (2 * ndev)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((nkkt, nkkt)) * (1.0 / np.sqrt(nkkt))
    K = A @ A.T + np.eye(nkkt)
    Lst, _ = dist_cholesky(hmesh, ("row", "col"), jnp.asarray(K), nb)
    L = np.asarray(cyclic_unpack(Lst, nb, ndev))
    assert np.allclose(L @ L.T, K, atol=1e-8 * nkkt)
    m = nkkt + nkkt // 2
    G = rng.standard_normal((m, nkkt)) * (1.0 / np.sqrt(nkkt))
    h = G @ rng.standard_normal(nkkt) + rng.uniform(0.5, 1.5, m)
    q = rng.standard_normal(nkkt)
    Pm = np.eye(nkkt) * 2.0
    dims = ConeDims(l=m)
    fac = sharded_kkt_solver(hmesh, ("row", "col"), dims,
                             jnp.asarray(G), Pmat=jnp.asarray(Pm),
                             dist_nb=nb)
    sol = coneqp(Pm, q, G, h, dims, kktsolver=fac)
    assert sol["status"] == "optimal"


def test_batched_qp_solver_seq_grouped():
    """group>1 pipelines instances per lax.map step; results match the
    ungrouped driver (real f64 fallback stays correct via cond_any)."""
    from kvxopt_tpu.parallel import batched_qp_solver_seq
    B, n, m = 4, 12, 20
    rng = np.random.default_rng(21)
    Ps = np.zeros((B, n, n)); qs = np.zeros((B, n))
    Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    for i in range(B):
        M = rng.standard_normal((n, n))
        Ps[i] = M @ M.T + n * np.eye(n)
        qs[i] = rng.standard_normal(n)
        Gs[i] = rng.standard_normal((m, n))
        hs[i] = Gs[i] @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    a = tuple(jnp.asarray(x) for x in (Ps, qs, Gs, hs))
    ref = batched_qp_solver_seq(ConeDims(l=m), "chol2_mixed")(*a)
    for g in (2, 4):
        out = batched_qp_solver_seq(ConeDims(l=m), "chol2_mixed",
                                    group=g)(*a)
        assert (np.asarray(out[5]) == 1).all()
        np.testing.assert_allclose(np.asarray(out[0]),
                                   np.asarray(ref[0]), atol=1e-6)
