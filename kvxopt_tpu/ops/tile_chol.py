"""Tile-sparse (supernodal-style) Cholesky with device-side numeric
factorization.

The device replacement for CHOLMOD's supernodal numeric phase
(reference cholmod.c symbolic/numeric split): symbolic analysis happens
once on the host over a fixed tile pattern; the numeric factorization is
a single jitted XLA program of dense-tile operations whose schedule
(gather/scatter index tables per block column) is baked in at trace time.
Re-running `factor` with new values is device-side numeric refactorization
— the KLU/CHOLMOD fast-refactor contract on device.

Storage: the lower-triangular nonzero TILES of L (after fill analysis)
live in one (NT, ts, ts) array.  Per block column j the program does

  1. scatter-add updates  X[ij] -= X[ik] @ X[jk]'  for all k < j pairs
     (one batched dot_general + segment scatter-add),
  2. one dense Cholesky of the diagonal tile,
  3. a batched triangular solve of the column's subdiagonal tiles.

Intended for block-banded / power-grid-like patterns where the tile
pattern stays sparse; for small n (<= a few thousand) the dense batched
path (jnp.linalg.cholesky) is usually faster.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.lax.linalg import triangular_solve


class TileCholesky:
    """Host symbolic analysis over a fixed tile pattern."""

    def __init__(self, pattern, n, ts=128):
        """pattern: iterable of (i, j) tile coordinates (i >= j) with a
        nonzero tile in the LOWER triangle of A (diagonal tiles required);
        n: matrix order; ts: tile size."""
        self.n = n
        self.ts = ts
        self.T = -(-n // ts)
        T = self.T
        S = set()
        for i, j in pattern:
            if i < j:
                i, j = j, i
            S.add((int(i), int(j)))
        for d in range(T):
            S.add((d, d))
        # block fill: L[i,j] exists if A[i,j] or exists k<j with L[i,k]
        # and L[j,k] (block right-looking fill rule)
        changed = True
        while changed:
            changed = False
            by_col = {}
            for (i, j) in S:
                by_col.setdefault(j, []).append(i)
            for k in sorted(by_col):
                rows = sorted(r for r in by_col[k] if r > k)
                for a in range(len(rows)):
                    for b in range(a, len(rows)):
                        ii, jj = rows[b], rows[a]
                        if (ii, jj) not in S:
                            S.add((ii, jj))
                            changed = True
        self.tiles = sorted(S, key=lambda t: (t[1], t[0]))  # col-major
        self.slot = {t: k for k, t in enumerate(self.tiles)}
        self.NT = len(self.tiles)

        # per-column schedules
        self.col_rows = []       # subdiagonal row tiles of column j
        self.col_slots = []      # their slots
        self.upd = []            # per column: (dst, a, b) update triples
        for j in range(T):
            rows = sorted(i for (i, jj) in S if jj == j and i > j)
            self.col_rows.append(rows)
            self.col_slots.append([self.slot[(i, j)] for i in rows])
            triples = []
            for k in range(j):
                if (j, k) not in S:
                    continue
                rows_k = [i for (i, kk) in S if kk == k and i >= j]
                for i in rows_k:
                    if (i, j) in S:
                        triples.append((self.slot[(i, j)],
                                        self.slot[(i, k)],
                                        self.slot[(j, k)]))
            self.upd.append(triples)

        # padded op tables for the lax.scan numeric kernel: one extra
        # scratch slot (index NT) absorbs padding reads/writes, one extra
        # scratch row-tile (index T) absorbs padded solve updates
        U = max((len(t) for t in self.upd), default=0)
        R = max((len(r) for r in self.col_rows), default=0)
        self.maxU, self.maxR = U, R
        dummy = self.NT
        T_ = T

        def pad(lst, size, fill):
            return list(lst) + [fill] * (size - len(lst))

        self.tab_dst = np.array(
            [pad([t[0] for t in self.upd[j]], U, dummy)
             for j in range(T_)], dtype=np.int32).reshape(T_, U)
        self.tab_a = np.array(
            [pad([t[1] for t in self.upd[j]], U, dummy)
             for j in range(T_)], dtype=np.int32).reshape(T_, U)
        self.tab_b = np.array(
            [pad([t[2] for t in self.upd[j]], U, dummy)
             for j in range(T_)], dtype=np.int32).reshape(T_, U)
        self.tab_diag = np.array(
            [self.slot[(j, j)] for j in range(T_)], dtype=np.int32)
        self.tab_cols = np.array(
            [pad(self.col_slots[j], R, dummy) for j in range(T_)],
            dtype=np.int32).reshape(T_, R)
        self.tab_rows = np.array(
            [pad(self.col_rows[j], R, T_) for j in range(T_)],
            dtype=np.int32).reshape(T_, R)

    # -- host <-> tile conversion ---------------------------------------

    def tiles_from_dense(self, A):
        ts, T, n = self.ts, self.T, self.n
        npad = T * ts
        Ap = jnp.zeros((npad, npad), A.dtype)
        Ap = Ap.at[:n, :n].set(jnp.asarray(A))
        idx = jnp.arange(n, npad)
        Ap = Ap.at[idx, idx].set(1.0)
        out = jnp.stack([
            Ap[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts]
            for (i, j) in self.tiles])
        return out

    def tiles_from_csc(self, low):
        """Host conversion of a (lower-triangular) scipy CSC matrix into
        the tile array (padding edge tiles; unit diagonal on pad rows so
        the factorization of the padded matrix is well-posed)."""
        import scipy.sparse as sp
        ts, T, n = self.ts, self.T, self.n
        dtype = (np.complex128 if np.iscomplexobj(low.data)
                 else np.float64)
        X = np.zeros((self.NT, ts, ts), dtype=dtype)
        low = sp.csr_matrix(low)
        for k, (i, j) in enumerate(self.tiles):
            r0, r1 = i * ts, min((i + 1) * ts, n)
            c0, c1 = j * ts, min((j + 1) * ts, n)
            if r0 < n and c0 < n:
                X[k, : r1 - r0, : c1 - c0] = \
                    low[r0:r1, c0:c1].toarray()
            if i == j:
                # jnp.linalg.cholesky reads the full matrix: mirror the
                # stored lower triangle of diagonal tiles (Hermitian
                # for complex dtypes)
                blk = X[k]
                X[k] = np.tril(blk) + np.tril(blk, -1).conj().T
                if r1 - r0 < ts:
                    for d in range(max(r1 - r0, 0), ts):
                        X[k, d, d] = 1.0
        return X

    def dense_from_tiles(self, X):
        ts, T, n = self.ts, self.T, self.n
        npad = T * ts
        out = jnp.zeros((npad, npad), X.dtype)
        for k, (i, j) in enumerate(self.tiles):
            out = out.at[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts].set(
                X[k])
        return out[:n, :n]

    # -- device numeric factorization ------------------------------------

    def factor(self, X):
        """Numeric tile Cholesky: X (NT, ts, ts) tiles of the lower
        triangle of A -> tiles of L (diagonal tiles lower-triangular).
        Pure jax; jit/refactor freely.

        One lax.scan over the per-column op table (padded to the maximum
        column update/row counts, with a scratch slot absorbing the
        padding) — the scan body is instanced once, so compile time is
        flat in the tile count (ROADMAP round-1 item 5)."""
        ts = self.ts
        NT = self.NT
        Xe = jnp.concatenate(
            [X, jnp.zeros((1, ts, ts), X.dtype)], axis=0)
        tabs = (jnp.asarray(self.tab_dst), jnp.asarray(self.tab_a),
                jnp.asarray(self.tab_b), jnp.asarray(self.tab_diag),
                jnp.asarray(self.tab_cols))

        def body(Xc, tab):
            dst, a, b, dj, slots = tab
            if self.maxU:
                # X[ij] -= L[ia] L[jb]^H (conj is a no-op for real dtypes)
                upd = jax.lax.dot_general(
                    Xc[a], Xc[b].conj(),
                    dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=Xc.dtype)
                Xc = Xc.at[dst].add(-upd)
                Xc = Xc.at[NT].set(0.0)  # re-zero the scratch slot
            Ljj = jnp.linalg.cholesky(Xc[dj])
            Xc = Xc.at[dj].set(Ljj)
            if self.maxR:
                col = Xc[slots]
                # X[ij] := X[ij] L_jj^{-H}: solve X L^H = B
                sol = triangular_solve(
                    jnp.broadcast_to(Ljj, col.shape), col,
                    left_side=False, lower=True, transpose_a=True,
                    conjugate_a=True)
                Xc = Xc.at[slots].set(sol)
                Xc = Xc.at[NT].set(0.0)
            return Xc, None

        Xe, _ = jax.lax.scan(body, Xe, tabs)
        return Xe[:NT]

    def _pad_vec(self, bvec):
        ts, T, n = self.ts, self.T, self.n
        b = jnp.zeros((T * ts,), bvec.dtype).at[:n].set(bvec)
        # one scratch row-tile (index T) absorbs padded updates
        return jnp.concatenate([b.reshape(T, ts),
                                jnp.zeros((1, ts), bvec.dtype)], axis=0)

    def _tabs(self):
        jidx = jnp.arange(self.T, dtype=jnp.int32)
        return (jidx, jnp.asarray(self.tab_diag),
                jnp.asarray(self.tab_cols), jnp.asarray(self.tab_rows))

    def solve_l(self, X, bvec):
        """Forward block substitution: L y = b."""
        ts, T, n = self.ts, self.T, self.n
        Xe = jnp.concatenate(
            [X, jnp.zeros((1, ts, ts), X.dtype)], axis=0)
        y = self._pad_vec(bvec)

        def fwd(yc, tab):
            j, dj, slots, rows = tab
            yj = triangular_solve(Xe[dj], yc[j][:, None],
                                  left_side=True, lower=True)[:, 0]
            yc = yc.at[j].set(yj)
            if self.maxR:
                upd = jnp.einsum("rij,j->ri", Xe[slots], yj)
                yc = yc.at[rows].add(-upd)
                yc = yc.at[T].set(0.0)
            return yc, None

        y, _ = jax.lax.scan(fwd, y, self._tabs())
        return y[:T].reshape(-1)[:n]

    def solve_lt(self, X, bvec):
        """Backward block substitution: L^H x = b (L' for real)."""
        ts, T, n = self.ts, self.T, self.n
        Xe = jnp.concatenate(
            [X, jnp.zeros((1, ts, ts), X.dtype)], axis=0)
        y = self._pad_vec(bvec)

        def bwd(yc, tab):
            j, dj, slots, rows = tab
            if self.maxR:
                acc = yc[j] - jnp.einsum("rji,rj->i",
                                         Xe[slots].conj(), yc[rows])
            else:
                acc = yc[j]
            xj = triangular_solve(Xe[dj], acc[:, None], left_side=True,
                                  lower=True, transpose_a=True,
                                  conjugate_a=True)[:, 0]
            return yc.at[j].set(xj), None

        y, _ = jax.lax.scan(bwd, y, self._tabs(), reverse=True)
        return y[:T].reshape(-1)[:n]

    def solve(self, X, bvec):
        """Solve A x = b given factored tiles X (block forward + backward
        substitution, each one lax.scan over the padded op table)."""
        return self.solve_lt(X, self.solve_l(X, bvec))


def tile_pattern_from_sparse(A, ts=128):
    """Tile coordinates of the lower triangle of a scipy sparse matrix."""
    import scipy.sparse as sp
    coo = sp.tril(A.tocsc()).tocoo()
    tiles = set(zip((coo.row // ts).tolist(), (coo.col // ts).tolist()))
    return tiles
