"""conelp / lp / socp / sdp: scipy.linprog oracles, known userguide-style
examples, and infeasibility-certificate checks."""

import numpy as np
from scipy.optimize import linprog

from kvxopt_tpu import cones
from kvxopt_tpu.cones import ConeDims
from kvxopt_tpu.solvers import conelp, lp, socp, sdp


def test_lp_userguide():
    # minimize -4x1 - 5x2 s.t. 2x1+x2<=3, x1+2x2<=3, x>=0 -> x = (1, 1)
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([3.0, 3.0, 0.0, 0.0])
    sol = lp(c, G, h)
    assert sol["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol["x"]), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(sol["primal objective"], -9.0, atol=1e-6)
    np.testing.assert_allclose(sol["dual objective"], -9.0, atol=1e-6)


def test_lp_random_vs_scipy():
    rng = np.random.default_rng(0)
    for trial in range(3):
        n, m, p = 10, 18, 3
        c = rng.standard_normal(n)
        G = rng.standard_normal((m, n))
        x0 = rng.standard_normal(n)
        h = G @ x0 + rng.uniform(0.2, 2.0, m)
        A = rng.standard_normal((p, n))
        b = A @ x0
        # bound the feasible set so the LP has a finite solution
        G = np.vstack([G, np.eye(n), -np.eye(n)])
        h = np.concatenate([h, np.abs(x0) + 10.0, np.abs(x0) + 10.0])
        sol = lp(c, G, h, A, b)
        ref = linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b,
                      bounds=(None, None), method="highs")
        assert sol["status"] == "optimal"
        assert ref.status == 0
        np.testing.assert_allclose(sol["primal objective"], ref.fun,
                                   rtol=1e-5, atol=1e-6)


def test_lp_primal_infeasible():
    # x <= -1 and x >= 1: infeasible
    c = np.array([1.0])
    G = np.array([[1.0], [-1.0]])
    h = np.array([-1.0, -1.0])
    sol = lp(c, G, h)
    assert sol["status"] == "primal infeasible"
    z = np.asarray(sol["z"])
    # certificate: z >= 0, G'z = 0, h'z = -1
    assert (z >= -1e-8).all()
    np.testing.assert_allclose(G.T @ z, [0.0], atol=1e-6)
    np.testing.assert_allclose(h @ z, -1.0, atol=1e-6)


def test_lp_dual_infeasible():
    # minimize -x s.t. -x <= 0  (x >= 0 unbounded below in objective)
    c = np.array([-1.0])
    G = np.array([[-1.0]])
    h = np.array([0.0])
    sol = lp(c, G, h)
    assert sol["status"] == "dual infeasible"
    x = np.asarray(sol["x"])
    s = np.asarray(sol["s"])
    # certificate: c'x = -1, Gx + s = 0, s >= 0
    np.testing.assert_allclose(c @ x, -1.0, atol=1e-6)
    np.testing.assert_allclose(G @ x + s, [0.0], atol=1e-6)
    assert (s >= -1e-8).all()


def test_socp_userguide():
    # The userguide SOCP (doc/source/coneprog.rst):
    #   minimize -2x1 + x2 + 5x3
    #   s.t. ||(-13x1+3x2+5x3-3, -12x1+12x2-6x3-2)|| <= -12x1-6x2+5x3-12
    #        ||(-3x1+6x2+2x3, x1+9x2+2x3+3, -x1-19x2+3x3-42)||
    #                                            <= -3x1+6x2-10x3+27
    # Encoded as s = h - Gx in Q: G row 0 = -c_k', rows 1: = -A_k.
    c = np.array([-2.0, 1.0, 5.0])
    c1, d1 = np.array([-12.0, -6.0, 5.0]), -12.0
    A1 = np.array([[-13.0, 3.0, 5.0], [-12.0, 12.0, -6.0]])
    b1 = np.array([-3.0, -2.0])
    G1 = -np.vstack([c1, A1]); h1 = np.concatenate([[d1], b1])
    c2, d2 = np.array([-3.0, 6.0, -10.0]), 27.0
    A2 = np.array([[-3.0, 6.0, 2.0], [1.0, 9.0, 2.0], [-1.0, -19.0, 3.0]])
    b2 = np.array([0.0, 3.0, -42.0])
    G2 = -np.vstack([c2, A2]); h2 = np.concatenate([[d2], b2])
    sol = socp(c, Gq=[G1, G2], hq=[h1, h2])
    assert sol["status"] == "optimal"
    x = np.asarray(sol["x"])
    # userguide reports x ~ [-5.0147, -5.7669, -8.5217]
    np.testing.assert_allclose(x, [-5.0147, -5.7669, -8.5217], atol=2e-3)
    assert len(sol["zq"]) == 2 and len(sol["sq"]) == 2


def test_sdp_small():
    # minimize x1 + x2 s.t. x1*F1 + x2*F2 <= F0 (PSD order)
    # with F1 = diag(1,0), F2 = diag(0,1), F0 = [[1, .5], [.5, 1]] flipped:
    # -x1 F1 - x2 F2 + S = -F0 ... choose: s = h - Gx must be PSD.
    c = np.array([1.0, 1.0])
    # G columns: vec of coefficient matrices for each x_i
    F1 = np.array([[-1.0, 0.0], [0.0, 0.0]])
    F2 = np.array([[0.0, 0.0], [0.0, -1.0]])
    G = np.column_stack([F1.ravel(), F2.ravel()])
    F0 = np.array([[0.0, 1.0], [1.0, 0.0]])
    h = (-F0).ravel()
    # constraint: diag(x1, x2) - F0 >= 0, i.e. x1 x2 >= 1, x1,x2 >= 0;
    # minimize x1 + x2 -> x1 = x2 = 1.
    sol = conelp(c, G, h, ConeDims(l=0, s=(2,)))
    assert sol["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol["x"]), [1.0, 1.0], atol=1e-5)


def test_sdp_wrapper():
    # same problem through the sdp() natural form
    c = np.array([1.0, 1.0])
    Gs = [np.column_stack([np.diag([-1.0, 0.0]).ravel(),
                           np.diag([0.0, -1.0]).ravel()])]
    hs = [np.array([[0.0, -1.0], [-1.0, 0.0]])]
    sol = sdp(c, Gs=Gs, hs=hs)
    assert sol["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol["x"]), [1.0, 1.0], atol=1e-5)
    assert len(sol["zs"]) == 1 and sol["zs"][0].shape == (2, 2)


def test_conelp_mixed_cones():
    # LP + SOC + SDP blocks together, verified by KKT conditions
    rng = np.random.default_rng(7)
    n = 6
    dims = ConeDims(l=4, q=(3,), s=(3,))
    N = dims.size
    Gm = rng.standard_normal((N, n))
    for ofs, m in zip(dims.sofs, dims.s):
        for col in range(n):
            X = Gm[ofs:ofs + m * m, col].reshape(m, m)
            Gm[ofs:ofs + m * m, col] = (0.5 * (X + X.T)).ravel()
    x0 = rng.standard_normal(n)
    s0 = np.zeros(N)
    s0[:4] = rng.uniform(0.5, 1.5, 4)
    s0[4] = 2.0; s0[5:7] = rng.standard_normal(2) * 0.3
    S = rng.standard_normal((3, 3)); S = S @ S.T + 3 * np.eye(3)
    s0[7:] = S.ravel()
    h = Gm @ x0 + s0
    c = -Gm.T @ np.concatenate([
        rng.uniform(0.5, 1.5, 4),
        [2.0, 0.1, 0.1],
        (np.eye(3) + 0.1 * np.ones((3, 3))).ravel()])
    sol = conelp(c, Gm, h, dims)
    assert sol["status"] == "optimal"
    x = np.asarray(sol["x"]); z = np.asarray(sol["z"])
    s = np.asarray(sol["s"])
    assert np.linalg.norm(Gm.T @ z + c) < 1e-5 * max(1, np.linalg.norm(c))
    assert np.linalg.norm(Gm @ x + s - h) < 1e-5 * max(1, np.linalg.norm(h))
    assert abs(cones.sdot(dims, np.asarray(s, float), np.asarray(z, float))
               ) < 1e-5
    assert float(cones.max_step(dims, np.asarray(s, float))) < 1e-7
    assert float(cones.max_step(dims, np.asarray(z, float))) < 1e-7


def test_global_options_dict():
    # the shared mutable solvers.options dict (reference solvers.py:38-40)
    from kvxopt_tpu import solvers
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([3.0, 3.0, 0.0, 0.0])
    solvers.options["maxiters"] = 2
    try:
        sol = lp(c, G, h)
        assert sol["iterations"] <= 2
        assert sol["status"] == "unknown"
        # per-call override wins
        sol2 = lp(c, G, h, options={"maxiters": 100})
        assert sol2["status"] == "optimal"
    finally:
        solvers.options.clear()


def test_conelp_warm_start():
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([3.0, 3.0, 0.0, 0.0])
    cold = conelp(c, G, h, ConeDims(l=4))
    x0 = np.asarray(cold["x"])
    s0 = np.maximum(h - G @ x0, 1e-3)
    z0 = np.maximum(np.asarray(cold["z"]), 1e-3)
    warm = conelp(c, G, h, ConeDims(l=4),
                  primalstart={"x": x0, "s": s0},
                  dualstart={"y": np.zeros(0), "z": z0})
    assert warm["status"] == "optimal"
    assert warm["iterations"] <= cold["iterations"]


def test_show_progress_prints(capsys):
    c = np.array([-1.0])
    G = np.array([[1.0], [-1.0]])
    h = np.array([1.0, 1.0])
    sol = lp(c, G, h, options={"show_progress": True})
    assert sol["status"] == "optimal"
    out = capsys.readouterr().out
    assert "pcost" in out and "dcost" in out


def test_lp_equilibrate_badly_scaled():
    # rows/columns spanning 10 orders of magnitude
    rng = np.random.default_rng(13)
    n, m = 6, 12
    G0 = rng.standard_normal((m, n))
    rscale = 10.0 ** rng.uniform(-5, 5, m)
    cscale = 10.0 ** rng.uniform(-4, 4, n)
    G = G0 * rscale[:, None] * cscale[None, :]
    x0 = rng.standard_normal(n) / cscale
    h = G @ x0 + rscale * rng.uniform(0.5, 1.5, m)
    z0 = rng.uniform(0.1, 1.0, m) / rscale
    c = -G.T @ z0
    sol = lp(c, G, h, options={"equilibrate": True})
    assert sol["status"] == "optimal"
    x = np.asarray(sol["x"]).reshape(-1)
    z = np.asarray(sol["z"]).reshape(-1)
    # unscaled KKT conditions hold
    assert (G @ x <= h + 1e-6 * np.abs(h).max()).all()
    assert np.linalg.norm(G.T @ z + c) < 1e-5 * np.linalg.norm(c)
    from scipy.optimize import linprog
    ref = linprog(c, A_ub=G, b_ub=h, bounds=(None, None), method="highs")
    if ref.status == 0:
        np.testing.assert_allclose(float(c @ x), ref.fun, rtol=1e-5)
