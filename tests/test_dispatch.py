"""Where a solve runs: on JAX's default device, and under a
`jax.default_device` context on the device it names.
"""

import numpy as np

import jax

from kvxopt_tpu import solvers


def test_solves_unaffected_by_dispatch_context():
    """A solve through the front end under an explicit default_device
    context matches the plain solve."""
    c = np.array([-4., -5.])
    G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    h = np.array([3., 3., 0., 0.])
    plain = solvers.lp(c, G, h)
    with jax.default_device(jax.devices("cpu")[0]):
        ctxed = solvers.lp(c, G, h)
    assert plain["status"] == ctxed["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(plain["x"]),
                               np.asarray(ctxed["x"]), atol=1e-9)


def test_profile_option_writes_trace(tmp_path):
    """options['profile'] captures a jax.profiler trace of the solve
    (SURVEY §5 dev hook)."""
    import os
    import numpy as np
    from kvxopt_tpu.solvers import qp
    rng = np.random.default_rng(0)
    n, m = 6, 9
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    d = str(tmp_path / "trace")
    sol = qp(P, q, G, h, options={"profile": d})
    assert sol["status"] == "optimal"
    found = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert found, "no trace files written"
