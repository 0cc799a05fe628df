"""Markowitz portfolio optimization (reference
examples/doc/chap8/portfolio.py): a risk/return tradeoff sweep solved
with coneqp — and, batched, the whole sweep solved in ONE
call via vmap (kvxopt_tpu.parallel)."""

import numpy as np
import jax.numpy as jnp

from kvxopt_tpu.cones import ConeDims
from kvxopt_tpu.parallel import batched_qp_solver
from kvxopt_tpu.solvers import qp


def main(n=8, nmu=16):
    rng = np.random.default_rng(7)
    F = rng.standard_normal((n, n))
    S = F @ F.T + 0.1 * np.eye(n)      # covariance
    pbar = rng.uniform(0.0, 0.3, n)    # mean returns

    # single solves across the risk-aversion sweep
    mus = [10 ** (5.0 * t / (nmu - 1) - 1.0) for t in range(nmu)]
    returns, risks = [], []
    G = np.vstack([-np.eye(n), np.ones((1, n)), -np.ones((1, n))])
    h = np.concatenate([np.zeros(n), [1.0], [-1.0]])
    for mu in mus:
        sol = qp(mu * S, -pbar, G, h)
        x = np.asarray(sol["x"])
        returns.append(float(pbar @ x))
        risks.append(float(np.sqrt(x @ S @ x)))

    # the same sweep as one batched device program
    B = nmu
    Ps = jnp.asarray(np.stack([mu * S for mu in mus]))
    qs = jnp.asarray(np.tile(-pbar, (B, 1)))
    Gs = jnp.asarray(np.tile(G, (B, 1, 1)))
    hs = jnp.asarray(np.tile(h, (B, 1)))
    vsolve = batched_qp_solver(ConeDims(l=G.shape[0]))
    xb, yb, sb, zb, it, status, metrics = vsolve(Ps, qs, Gs, hs)
    return dict(returns=returns, risks=risks,
                batch_status=np.asarray(status),
                batch_x=np.asarray(xb))


if __name__ == "__main__":
    out = main()
    print("sweep ok; batch statuses:", out["batch_status"])
