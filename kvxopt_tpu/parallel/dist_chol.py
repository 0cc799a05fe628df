"""Block-cyclic distributed Cholesky over a mesh axis.

For a single KKT system too large for one device's memory, the n x n SPD
matrix is partitioned into nb-wide block columns distributed cyclically
over the devices of a mesh axis (block column j lives on device
j mod ndev — the classic ScaLAPACK layout, which keeps every device busy
as the factorization front moves right).  The axis may be a tuple of
mesh axis names: the per-step panel broadcast is then a psum over every
device the axes span.

Per factorization step k (static loop, one per block column):
  1. the owner's current column k is broadcast (one masked psum),
  2. every device redundantly factors the nb x nb diagonal block and
     forms the panel L[k:, k] (O(n nb^2) flops — negligible),
  3. every device applies the rank-nb trailing update to the block
     columns it owns (the O(n^2 nb) matmul work, fully parallel).

Communication: nblk psums of an (n, nb) panel per factorization and
nblk psums of an (n,) vector per triangular solve — the same volume a
2D-cyclic ScaLAPACK factorization moves, organized for XLA collectives.

There is no reference counterpart: the reference's largest
factorizations are single-host CHOLMOD calls (SURVEY.md section 2.3);
this is the scale-out path for KKT matrices beyond one device.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def _axis_tuple(axis):
    return axis if isinstance(axis, tuple) else (axis,)


def _ndev(mesh, axis):
    return int(np.prod([mesh.shape[a] for a in _axis_tuple(axis)]))


def _device_index(mesh, axis):
    """Linear index of this device along `axis` (tuple-aware)."""
    names = _axis_tuple(axis)
    idx = jax.lax.axis_index(names[0])
    for a in names[1:]:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def cyclic_pack(K, nb, ndev):
    """(n, n) SPD -> (nblk, n, nb) block-column stack in cyclic order:
    global block j = (l * ndev + dev) is stored at stack position
    dev * nloc + l, so sharding the leading axis over ndev devices gives
    device d exactly the columns {d, d + ndev, ...}."""
    n = K.shape[0]
    assert n % nb == 0, "n must be a multiple of nb"
    nblk = n // nb
    assert nblk % ndev == 0, "block count must be a multiple of ndev"
    nloc = nblk // ndev
    cols = K.reshape(n, nblk, nb).transpose(1, 0, 2)   # (nblk, n, nb)
    order = np.arange(nblk).reshape(nloc, ndev).T.reshape(-1)
    return cols[jnp.asarray(order)], nloc


def cyclic_unpack(Lst, nb, ndev):
    """Inverse of cyclic_pack: (nblk, n, nb) stack -> (n, n)."""
    nblk, n, _ = Lst.shape
    nloc = nblk // ndev
    order = np.arange(nblk).reshape(nloc, ndev).T.reshape(-1)
    inv = np.empty(nblk, dtype=np.int64)
    inv[order] = np.arange(nblk)
    return Lst[jnp.asarray(inv)].transpose(1, 0, 2).reshape(n, n)


def dist_chol_factory(mesh: Mesh, axis, n: int, nb: int = 256):
    """Returns (factor, solve) shard_mapped callables.

    factor(Kst) -> Lst: Kst/Lst are (nblk, n, nb) cyclic block-column
    stacks (see cyclic_pack), sharded over `axis` on the leading dim;
    L is lower-triangular with L L' = K (blocks above the diagonal are
    zeroed).

    solve(Lst, b) -> x with K x = b for a replicated (n,) b.
    """
    ndev = _ndev(mesh, axis)
    nblk = n // nb
    nloc = nblk // ndev
    assert nblk * nb == n and nloc * ndev == nblk
    spec_k = P(axis, None, None)
    spec_b = P()

    row = np.arange(n)[:, None]
    colr = np.arange(nb)[None, :]
    jl = np.arange(nloc)

    def _owner_col(Ll, dev, k):
        """Broadcast block-column k from its owner: one masked psum.
        k is a traced loop index (the factorization loop is a
        lax.fori_loop so compile time is O(1) in nblk, not O(nblk) —
        an n=16384 factor has 64+ block steps)."""
        owner = jax.lax.rem(k, ndev)
        lk = jax.lax.div(k, ndev)
        colk = jax.lax.dynamic_index_in_dim(Ll, lk, keepdims=False)
        colk = jnp.where(dev == owner, colk, jnp.zeros_like(colk))
        return jax.lax.psum(colk, axis)

    @partial(shard_map, mesh=mesh, in_specs=(spec_k,),
             out_specs=spec_k)
    def factor(Kl):
        dev = _device_index(mesh, axis)

        def step(k, Ll):
            colk = _owner_col(Ll, dev, k)
            dk = jax.lax.dynamic_slice(colk, (k * nb, 0), (nb, nb))
            Lkk = jnp.linalg.cholesky(dk)
            # panel P = [Lkk; L[k+1:, k]] (redundant on every device)
            pan = solve_triangular(Lkk, colk.T, lower=True).T
            tri = (row - k * nb) >= colr          # lower-tri incl. diag
            pan = jnp.where((row >= k * nb) & tri, pan, 0.0)
            # owner stores the finished column
            owner = jax.lax.rem(k, ndev)
            lk = jax.lax.div(k, ndev)
            old = jax.lax.dynamic_index_in_dim(Ll, lk, keepdims=False)
            Ll = jax.lax.dynamic_update_index_in_dim(
                Ll, jnp.where(dev == owner, pan, old), lk, 0)
            # trailing update on owned columns j > k, all local columns
            # at once: K[:, j] -= pan_below @ pan[j-block]'
            below = jnp.where(row >= (k + 1) * nb, pan, 0.0)
            jglob = jl * ndev + dev               # (nloc,) traced
            pjs = jnp.take(pan.reshape(nblk, nb, nb), jglob, axis=0)
            upd = jnp.einsum("ik,ljk->lij", below, pjs)
            return Ll - jnp.where((jglob > k)[:, None, None], upd, 0.0)

        return jax.lax.fori_loop(0, nblk, step, Kl)

    @partial(shard_map, mesh=mesh, in_specs=(spec_k, spec_b),
             out_specs=spec_b)
    def solve(Ll, b):
        dev = _device_index(mesh, axis)

        # forward: L y = b
        def fstep(k, y):
            colk = _owner_col(Ll, dev, k)
            Lkk = jax.lax.dynamic_slice(colk, (k * nb, 0), (nb, nb))
            yk = solve_triangular(
                Lkk, jax.lax.dynamic_slice(y, (k * nb,), (nb,)),
                lower=True)
            y = jax.lax.dynamic_update_slice(y, yk, (k * nb,))
            below = jnp.where(row >= (k + 1) * nb, colk, 0.0)
            return y - below @ yk

        y = jax.lax.fori_loop(0, nblk, fstep, b)

        # backward: L' x = y (one more broadcast per block column)
        def bstep(i, x):
            k = nblk - 1 - i
            colk = _owner_col(Ll, dev, k)
            Lkk = jax.lax.dynamic_slice(colk, (k * nb, 0), (nb, nb))
            below = jnp.where(row >= (k + 1) * nb, colk, 0.0)
            rhs = (jax.lax.dynamic_slice(x, (k * nb,), (nb,))
                   - below.T @ x)
            xk = solve_triangular(Lkk.T, rhs, lower=False)
            return jax.lax.dynamic_update_slice(x, xk, (k * nb,))

        return jax.lax.fori_loop(0, nblk, bstep, y)

    return factor, solve


def dist_cholesky(mesh: Mesh, axis, K, nb: int = 256):
    """Convenience wrapper: pack, factor, return (Lst, solve, unpack)."""
    K = jnp.asarray(K)
    ndev = _ndev(mesh, axis)
    Kst, _ = cyclic_pack(K, nb, ndev)
    Kst = jax.device_put(
        Kst, NamedSharding(mesh, P(axis, None, None)))
    factor, solve = dist_chol_factory(mesh, axis, K.shape[0], nb)
    Lst = factor(Kst)
    return Lst, solve
