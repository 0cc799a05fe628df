"""Weak-scaling measurement for the tensor-parallel KKT factor.

Runs the full-cone sharded kktsolver (parallel/sharded.py
sharded_kkt_solver) on 1/2/4/8 of JAX's devices (as many as there are)
with FIXED WORK PER DEVICE (rows grow with the device count), timing one
factor(W)+solve round trip — the per-IPM-iteration unit of work.  Ideal
weak scaling is constant time per step as devices are added.

On GPUs it measures the real interconnect.  To rehearse on the CPU, give
the host several virtual devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/weak_scaling_sharded.py

where all "devices" share one host's cores, so it validates the
collective structure and measures overhead, not bandwidth.

Usage: python examples/weak_scaling_sharded.py [rows_per_dev] [n]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

import kvxopt_tpu  # noqa: F401  (enables x64)


def measure(ndev, rows_per_dev, n, reps=5):
    import jax
    import jax.numpy as jnp
    from kvxopt_tpu.cones import ConeDims, compute_scaling
    from kvxopt_tpu.parallel import make_mesh, sharded_kkt_solver

    rows = rows_per_dev * ndev
    dims = ConeDims(l=rows)
    rng = np.random.default_rng(0)
    G = jnp.asarray(rng.standard_normal((rows, n)))
    Pm = jnp.asarray(np.eye(n))
    s = jnp.asarray(rng.uniform(0.5, 2.0, rows))
    z = jnp.asarray(rng.uniform(0.5, 2.0, rows))
    W, _ = compute_scaling(dims, s, z)
    mesh = make_mesh(ndev, ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, G, Pmat=Pm)
    bx = jnp.asarray(rng.standard_normal(n))
    by = jnp.zeros((0,))
    bz = jnp.asarray(rng.standard_normal(rows))

    def step(d_l):
        Wk = W._replace(d=d_l)
        solve = factor(Wk)
        return solve(bx, by, bz)[0]

    jstep = jax.jit(step)
    jstep(W.d)[0].block_until_ready()  # compile
    ts = []
    for i in range(reps):
        d_i = W.d + 1e-6 * i  # fresh data each rep
        t0 = time.perf_counter()
        jstep(d_i).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main():
    rows_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    t1 = None
    print(f"rows/device={rows_per_dev} n={n}")
    print("ndev  rows    factor+solve ms   weak-scaling eff")
    for ndev in (d for d in (1, 2, 4, 8) if d <= len(jax.devices())):
        t = measure(ndev, rows_per_dev, n)
        if t1 is None:
            t1 = t
        print(f"{ndev:4d}  {rows_per_dev*ndev:6d}  {t*1e3:12.2f}      "
              f"{t1/t:.2f}")


if __name__ == "__main__":
    main()
