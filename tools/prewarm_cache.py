"""Prewarm the persistent compilation cache for the standard solver
programs.

The first solve of a given (shape, dims, kktsolver, options) key pays an
XLA compile — seconds to minutes.  The persistent cache (config.py:
JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache/<host
fingerprint>) makes that a one-time cost per machine; this tool pays it
ahead of time for a list of standard shapes so that first user solves
are warm.

Usage:
    python tools/prewarm_cache.py                 # default shape set
    python tools/prewarm_cache.py 64x128 256x512  # LP shapes n x m

Each shape compiles the conelp (lp) and coneqp (qp) fused programs for
the default kktsolvers at default tolerances, on JAX's default device —
i.e., exactly the programs real solves will hit.
"""

import sys
import time

import numpy as np


DEFAULT_SHAPES = ["16x32", "64x128", "128x256", "256x512", "512x1024"]


def prewarm(shapes):
    from kvxopt_tpu import solvers

    for spec in shapes:
        n, m = (int(v) for v in spec.split("x"))
        rng = np.random.default_rng(0)
        G = rng.standard_normal((m, n))
        h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
        c = rng.standard_normal(n)
        t0 = time.time()
        sol = solvers.lp(c, G, h)
        print(f"lp  {spec}: {time.time() - t0:6.1f}s  {sol['status']}")
        M = rng.standard_normal((n, n))
        P = M @ M.T + n * np.eye(n)
        t0 = time.time()
        sol = solvers.qp(P, c, G, h)
        print(f"qp  {spec}: {time.time() - t0:6.1f}s  {sol['status']}")


if __name__ == "__main__":
    prewarm(sys.argv[1:] or DEFAULT_SHAPES)
