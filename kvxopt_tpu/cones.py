"""Cone algebra for symmetric cones K = R^l_+ x Q^q1 x ... x S^s1_+ x ...

Accelerator re-implementation of the capability of the reference's cone
kernels (reference: src/C/misc_solvers.c — scale/scale2/pack/unpack/sdot/
snrm2/sprod/sinv/max_step — and their Python fallbacks in
src/python/misc.py:250-1053).  The design is functional rather than
in-place: every operation is a pure, jit-traceable function over a flat cone
vector, with the cone structure carried by a static, hashable `ConeDims`.

Vector layout (matches the reference's convention,
doc/source/coneprog.rst): a cone vector u of dims (l, q, s) is a flat array

    [ u_l (l entries) |
      u_q0 (q[0] entries) ... |
      u_s0 (s[0]**2 entries, full symmetric storage) ... ]

Semidefinite blocks are stored as *full* symmetric matrices so that plain
elementwise dot products equal the trace inner product — this avoids the
reference's packed-storage gymnastics (misc_solvers.c:404-544) and keeps
every operation dense and batched.

The Nesterov-Todd scaling W (reference misc.py:250 compute_scaling) is
represented as a pytree `NTScaling`:

  - l-cone: diagonal d  (W_l = diag(d)),
  - each second-order cone: (beta, v) with W_q = beta * (2 v v' - J),
    where J = diag(1, -1, ..., -1) and v'Jv = 1,
  - each SDP block: matrices (r, rti) with W_s: m -> r' m r and
    W_s^{-T}: m -> rti' m rti  (rti = r^{-T}).

Identities (verified by tests/test_cones.py):
  W^{-T} s = W z = lambda,   sdot(lambda, lambda) = sdot(s, z).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import config


# ---------------------------------------------------------------------------
# Cone dimensions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConeDims:
    """Static description of a product cone.

    l: dimension of the nonnegative orthant
    q: sizes of the second-order cone blocks
    s: orders of the semidefinite blocks
    """

    l: int = 0
    q: Tuple[int, ...] = ()
    s: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(int(x) for x in self.q))
        object.__setattr__(self, "s", tuple(int(x) for x in self.s))
        if self.l < 0 or any(x < 1 for x in self.q) or any(x < 1 for x in self.s):
            raise ValueError("invalid cone dimensions")

    @classmethod
    def from_dict(cls, dims) -> "ConeDims":
        if isinstance(dims, ConeDims):
            return dims
        return cls(
            l=int(dims.get("l", 0)),
            q=tuple(dims.get("q", ())),
            s=tuple(dims.get("s", ())),
        )

    @property
    def size(self) -> int:
        """Length of the flat cone vector (full storage for s blocks)."""
        return self.l + sum(self.q) + sum(m * m for m in self.s)

    @property
    def degree(self) -> int:
        """Degree of the cone: l + len(q) + sum(s)."""
        return self.l + len(self.q) + sum(self.s)

    @property
    def qofs(self) -> Tuple[int, ...]:
        ofs, out = self.l, []
        for m in self.q:
            out.append(ofs)
            ofs += m
        return tuple(out)

    @property
    def sofs(self) -> Tuple[int, ...]:
        ofs, out = self.l + sum(self.q), []
        for m in self.s:
            out.append(ofs)
            ofs += m * m
        return tuple(out)

    def qblock(self, u, k):
        return jax.lax.dynamic_slice_in_dim(u, self.qofs[k], self.q[k]) \
            if False else u[self.qofs[k]:self.qofs[k] + self.q[k]]

    def sblock(self, u, k):
        m = self.s[k]
        return u[self.sofs[k]:self.sofs[k] + m * m].reshape(m, m)

    def with_extra_l(self, extra: int) -> "ConeDims":
        """Dims with `extra` leading orthant entries (nonlinear residuals in
        cpl are scaled exactly like 'l' entries — reference misc.py 'dnl')."""
        return ConeDims(l=self.l + extra, q=self.q, s=self.s)


def _set(u, sl, val):
    return u.at[sl].set(val.reshape(-1) if val.ndim > 1 else val)


# ---------------------------------------------------------------------------
# Same-size block grouping: q and s blocks of equal size are processed as
# one batched (vmapped) operation instead of a trace-time Python loop, so
# compile time and code size stay flat in the block count (the reference
# iterates per block in C where that costs nothing; under XLA it would
# bloat the graph).
# ---------------------------------------------------------------------------

import numpy as _np

_GROUP_CACHE: dict = {}


def block_groups(dims: "ConeDims"):
    """Group equal-size cone blocks: returns (qgroups, sgroups), each a
    list of (m, block_indices, flat_index_array) with flat_index_array of
    shape (count, m) for q and (count, m*m) for s — static numpy indices
    for one gather/scatter per group."""
    cached = _GROUP_CACHE.get(dims)
    if cached is not None:
        return cached
    qg: dict = {}
    for k, m in enumerate(dims.q):
        qg.setdefault(m, []).append(k)
    qgroups = []
    for m, idxs in sorted(qg.items()):
        flat = _np.stack([_np.arange(dims.qofs[k], dims.qofs[k] + m)
                          for k in idxs])
        qgroups.append((m, tuple(idxs), flat))
    sg: dict = {}
    for k, m in enumerate(dims.s):
        sg.setdefault(m, []).append(k)
    sgroups = []
    for m, idxs in sorted(sg.items()):
        flat = _np.stack([_np.arange(dims.sofs[k], dims.sofs[k] + m * m)
                          for k in idxs])
        sgroups.append((m, tuple(idxs), flat))
    _GROUP_CACHE[dims] = (qgroups, sgroups)
    return qgroups, sgroups


def _jdot_b(xb):
    """Batched hyperbolic inner product over (c, m) SOC blocks."""
    return xb[:, 0] ** 2 - jnp.sum(xb[:, 1:] ** 2, axis=1)


def _jnrm2_b(xb):
    """Batched hyperbolic norm over (c, m) SOC blocks."""
    a = jnp.linalg.norm(xb[:, 1:], axis=1)
    return jnp.sqrt(jnp.maximum((xb[:, 0] - a) * (xb[:, 0] + a), 0.0))


# ---------------------------------------------------------------------------
# Identity element, inner products
# ---------------------------------------------------------------------------


def cone_e(dims: ConeDims, dtype=None):
    """Identity element of the cone: ones / (1,0,..) / I."""
    dtype = dtype or config.default_dtype
    e = jnp.zeros((dims.size,), dtype=dtype)
    e = e.at[: dims.l].set(1.0)
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        e = e.at[flat[:, 0]].set(1.0)
    for m, idxs, flat in sgroups:
        eye = jnp.tile(jnp.eye(m, dtype=dtype).reshape(1, -1),
                       (len(idxs), 1))
        e = e.at[flat].set(eye)
    return e


def sdot(dims: ConeDims, u, v):
    """Cone inner product.  With full symmetric storage this is the plain
    dot product (off-diagonals are stored twice, matching the trace inner
    product) — reference misc_solvers.c sdot uses packed tricks instead."""
    return jnp.dot(u, v)


def snrm2(dims: ConeDims, u):
    """Euclidean norm of a cone vector under the s-block inner
    product (off-diagonal s entries counted once, reference
    misc_solvers.c snrm2)."""
    return jnp.sqrt(jnp.maximum(sdot(dims, u, u), 0.0))


def jdot(x):
    """Hyperbolic inner product x0^2 - ||x1||^2 of one SOC block."""
    return x[0] * x[0] - jnp.dot(x[1:], x[1:])


def jnrm2(x):
    """Hyperbolic norm sqrt(x0^2 - ||x1||^2), valid for interior points."""
    # Stable form: sqrt((x0 - ||x1||) * (x0 + ||x1||)).
    a = jnp.linalg.norm(x[1:])
    return jnp.sqrt(jnp.maximum((x[0] - a) * (x[0] + a), 0.0))


# ---------------------------------------------------------------------------
# Jordan algebra: sprod, ssqr, sinv
# ---------------------------------------------------------------------------


def sprod(dims: ConeDims, x, y, diag: bool = False):
    """Jordan product x o y.

    l: elementwise product; q: (x'y, x0 y1 + y0 x1);
    s: (XY + YX)/2.  With diag=True the s blocks of x are assumed diagonal
    (the lambda vector), allowing a cheaper product — mirrors the reference's
    `diag` flag (misc.py sprod).  Equal-size blocks are processed batched.
    """
    out = x * y  # correct for the l part; q/s parts overwritten below
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        xb, yb = x[flat], y[flat]
        head = jnp.sum(xb * yb, axis=1)
        tail = xb[:, :1] * yb[:, 1:] + yb[:, :1] * xb[:, 1:]
        out = out.at[flat].set(
            jnp.concatenate([head[:, None], tail], axis=1))
    for m, idxs, flat in sgroups:
        X = x[flat].reshape(-1, m, m)
        Y = y[flat].reshape(-1, m, m)
        if diag:
            lam = jnp.diagonal(X, axis1=1, axis2=2)
            Z = Y * 0.5 * (lam[:, :, None] + lam[:, None, :])
        else:
            Z = 0.5 * (X @ Y + Y @ X)
        out = out.at[flat].set(Z.reshape(-1, m * m))
    return out


def ssqr(dims: ConeDims, x):
    """x o x (squared in the Jordan algebra)."""
    out = x * x
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        xb = x[flat]
        head = jnp.sum(xb * xb, axis=1)
        tail = 2.0 * xb[:, :1] * xb[:, 1:]
        out = out.at[flat].set(
            jnp.concatenate([head[:, None], tail], axis=1))
    for m, idxs, flat in sgroups:
        X = x[flat].reshape(-1, m, m)
        out = out.at[flat].set((X @ X).reshape(-1, m * m))
    return out


def sinv(dims: ConeDims, x, y):
    """Inverse Jordan product: solve x o out = y ... i.e. out = x \\o y,
    where the s blocks of x are diagonal (reference misc.py sinv: 'the
    inverse product x := (y o\\ x), when the s components of y are
    diagonal')."""
    out = y / x  # l part
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        xb, yb = x[flat], y[flat]
        # Inverse of the arrow matrix Arw(x) = [[x0, x1'], [x1, x0 I]]
        a = _jdot_b(xb)
        c0 = (xb[:, 0] * yb[:, 0] -
              jnp.sum(xb[:, 1:] * yb[:, 1:], axis=1)) / a
        c1 = (yb[:, 1:] - c0[:, None] * xb[:, 1:]) / xb[:, :1]
        out = out.at[flat].set(
            jnp.concatenate([c0[:, None], c1], axis=1))
    for m, idxs, flat in sgroups:
        X = x[flat].reshape(-1, m, m)
        Y = y[flat].reshape(-1, m, m)
        lam = jnp.diagonal(X, axis1=1, axis2=2)
        Z = Y * (2.0 / (lam[:, :, None] + lam[:, None, :]))
        out = out.at[flat].set(Z.reshape(-1, m * m))
    return out


# ---------------------------------------------------------------------------
# max_step
# ---------------------------------------------------------------------------


def max_step(dims: ConeDims, x):
    """min{t | x + t*e >= 0}: the negative of the distance of x to the cone
    boundary along e (reference misc_solvers.c:1042 max_step).  Negative iff
    x is strictly inside the cone.  s-block eigenvalues are computed with
    one batched eigvalsh per equal-size group."""
    vals = []
    if dims.l:
        vals.append(-jnp.min(x[: dims.l]))
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        xb = x[flat]
        vals.append(jnp.max(jnp.linalg.norm(xb[:, 1:], axis=1) -
                            xb[:, 0]))
    for m, idxs, flat in sgroups:
        X = x[flat].reshape(-1, m, m)
        w = jnp.linalg.eigvalsh(0.5 * (X + jnp.swapaxes(X, 1, 2)))
        vals.append(-jnp.min(w))
    if not vals:
        return jnp.asarray(0.0, dtype=x.dtype)
    return jnp.max(jnp.stack(vals))


def max_step2(dims: ConeDims, u, v):
    """max_step of two cone vectors with the eigendecomposition batched
    across both (one eigvalsh instance in the graph instead of two —
    XLA expands each eigh into a large subprogram, so instance count
    drives compile time)."""
    both = jax.vmap(lambda w: max_step(dims, w))(jnp.stack([u, v]))
    return both[0], both[1]


def max_step_eig(dims: ConeDims, u):
    """max_step that also returns the s-block eigendecompositions.

    Returns (t, eig) where eig is a list aligned with the s groups of
    `block_groups(dims)`: one (sig, Q) pair per group with sig of shape
    (count, m) and Q of shape (count, m, m), Q diag(sig) Q' = u_block.
    The reference's max_step stores these in-place (misc_solvers.c:1042,
    sigs/Q outputs) for the scaled line-search state update in cpl."""
    vals = []
    if dims.l:
        vals.append(-jnp.min(u[: dims.l]))
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        xb = u[flat]
        vals.append(jnp.max(jnp.linalg.norm(xb[:, 1:], axis=1) -
                            xb[:, 0]))
    eig = []
    for m, idxs, flat in sgroups:
        X = u[flat].reshape(-1, m, m)
        sig, Q = jnp.linalg.eigh(0.5 * (X + jnp.swapaxes(X, 1, 2)))
        eig.append((sig, Q))
        vals.append(-jnp.min(sig))
    if not vals:
        return jnp.asarray(0.0, dtype=u.dtype), eig
    return jnp.max(jnp.stack(vals)), eig


# ---------------------------------------------------------------------------
# Nesterov-Todd scaling
# ---------------------------------------------------------------------------


class NTScaling(NamedTuple):
    """NT scaling point for the product cone (pytree).

    d:    (l,)         W_l = diag(d);  lambda_l = sqrt(s_l * z_l)
    beta: per-q scalar
    v:    per-q vector with v'Jv = 1;  W_q = beta (2 v v' - J)
    r, rti: per-s matrices; W_s(m) = r' m r, W_s^{-T}(m) = rti' m rti,
            rti = r^{-T}.
    """

    d: jnp.ndarray
    beta: Tuple[jnp.ndarray, ...]
    v: Tuple[jnp.ndarray, ...]
    r: Tuple[jnp.ndarray, ...]
    rti: Tuple[jnp.ndarray, ...]


def _svd_batched(B, method: str = "eigh"):
    """Batched SVD B = U diag(sig) V' of square (c, m, m) blocks.

    method='eigh' (default) computes it via the eigendecomposition of the
    Gram matrix B'B — XLA's svd can expand to a far larger subprogram
    than eigh, and the IPM's iterative refinement absorbs the
    normal-equations accuracy loss (~eps * cond) in the final
    iterations.  method='svd' uses
    jnp.linalg.svd for full accuracy (options['sscaling'] = 'svd')."""
    if method == "svd":
        U, sig, Vt = jnp.linalg.svd(B)
        return U, sig, jnp.swapaxes(Vt, 1, 2)
    sig2, Q = jnp.linalg.eigh(jnp.swapaxes(B, 1, 2) @ B)
    sig2 = jnp.maximum(sig2[:, ::-1], 1e-300)   # descending, like svd
    V = Q[:, :, ::-1]
    sig = jnp.sqrt(sig2)
    U = B @ (V / sig[:, None, :])
    return U, sig, V


def compute_scaling(dims: ConeDims, s, z, method: str = "eigh"):
    """Nesterov-Todd scaling W and scaled point lambda from a strictly
    feasible pair (s, z).  Functional equivalent of the reference's
    compute_scaling (misc.py:250); unlike the reference we recompute W from
    (s, z) every iteration instead of incrementally updating it
    (update_scaling, misc.py:422) — same mathematics, and the extra
    factorizations are cheap dense work.

    Returns (W, lmbda) with W z = W^{-T} s = lmbda.
    """
    lmbda = jnp.zeros((dims.size,), dtype=s.dtype)

    # l-cone: d = sqrt(s/z), lambda = sqrt(s*z)
    d = jnp.sqrt(s[: dims.l] / z[: dims.l]) if dims.l else jnp.zeros((0,), s.dtype)
    if dims.l:
        lmbda = lmbda.at[: dims.l].set(jnp.sqrt(s[: dims.l] * z[: dims.l]))

    qgroups, sgroups = block_groups(dims)
    betas = [None] * len(dims.q)
    vs = [None] * len(dims.q)
    for m, idxs, flat in qgroups:
        sb, zb = s[flat], z[flat]                       # (c, m)
        aa, bb = _jnrm2_b(sb), _jnrm2_b(zb)
        beta = jnp.sqrt(aa / bb)
        s_ = sb / aa[:, None]
        z_ = zb / bb[:, None]
        gamma = jnp.sqrt((1.0 + jnp.sum(s_ * z_, axis=1)) / 2.0)
        # Hyperbolic Householder construction: wbar = (s_ + J z_)/(2 gamma)
        # satisfies wbar'J wbar = 1 and (2 wbar wbar' - J) z_ = s_.  The NT
        # scaling needs the *square root* of that map, whose Householder
        # vector is v = (wbar + e)/sqrt(2 (wbar0 + 1)); then
        # W = beta (2 v v' - J) satisfies W^2 z = s.
        Jz = jnp.concatenate([z_[:, :1], -z_[:, 1:]], axis=1)
        wbar = (s_ + Jz) / (2.0 * gamma[:, None])
        vb = wbar.at[:, 0].add(1.0) / jnp.sqrt(
            2.0 * (wbar[:, 0] + 1.0))[:, None]
        # lambda = W z = beta (2 v (v'z) - J z)
        Ju = jnp.concatenate([zb[:, :1], -zb[:, 1:]], axis=1)
        lam_b = beta[:, None] * (
            2.0 * vb * jnp.sum(vb * zb, axis=1)[:, None] - Ju)
        lmbda = lmbda.at[flat].set(lam_b)
        for j, k in enumerate(idxs):
            betas[k] = beta[j]
            vs[k] = vb[j]

    rs = [None] * len(dims.s)
    rtis = [None] * len(dims.s)
    for m, idxs, flat in sgroups:
        S = s[flat].reshape(-1, m, m)
        Z = z[flat].reshape(-1, m, m)
        # one batched cholesky instance for both S and Z blocks
        LL = jnp.linalg.cholesky(0.5 * jnp.concatenate(
            [S + jnp.swapaxes(S, 1, 2), Z + jnp.swapaxes(Z, 1, 2)]))
        L1, L2 = LL[: S.shape[0]], LL[S.shape[0]:]
        # SVD of B = L2'L1 = U diag(lam) V' (see _svd_batched for the
        # eigh-vs-svd tradeoff; `method` is options['sscaling']).
        B = jnp.swapaxes(L2, 1, 2) @ L1
        U, lam, Q = _svd_batched(B, method)
        isqrt = 1.0 / jnp.sqrt(lam)
        r = L1 @ (Q * isqrt[:, None, :])
        rti = L2 @ (U * isqrt[:, None, :])
        Lam = jnp.zeros_like(S).at[
            :, jnp.arange(m), jnp.arange(m)].set(lam)
        lmbda = lmbda.at[flat].set(Lam.reshape(-1, m * m))
        for j, k in enumerate(idxs):
            rs[k] = r[j]
            rtis[k] = rti[j]

    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs),
                     r=tuple(rs), rti=tuple(rtis)), lmbda


def identity_scaling(dims: ConeDims, dtype=None) -> NTScaling:
    """The identity scaling W = I (used for IPM initialization)."""
    dtype = dtype or config.default_dtype
    d = jnp.ones((dims.l,), dtype=dtype)
    betas, vs = [], []
    for m in dims.q:
        betas.append(jnp.asarray(1.0, dtype=dtype))
        # v = e gives W_q = 2 e e' - J = I
        vs.append(jnp.zeros((m,), dtype=dtype).at[0].set(1.0))
    rs = tuple(jnp.eye(m, dtype=dtype) for m in dims.s)
    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs), r=rs, rti=rs)


def update_scaling(dims: ConeDims, W: NTScaling, s, z):
    """API-parity shim: recomputes the NT scaling from an unscaled
    strictly feasible pair (s, z).  For the reference's incremental
    update (misc.py:422) from *scaled* new iterates, use
    `update_scaling_inc`."""
    return compute_scaling(dims, s, z)


def update_scaling_inc(dims: ConeDims, W: NTScaling, lmbda, s, z,
                       method: str = "eigh"):
    """Incremental Nesterov-Todd scaling update (reference misc.py:422).

    On entry the l and q blocks of `s` and `z` contain the new iterates in
    the *current* scaling (W^{-T} s_new and W z_new); the s blocks contain
    factors Ls, Lz (full m x m storage) with Ls Ls' = W^{-T} s_new and
    Lz Lz' = W z_new.  Returns (W_new, lmbda_new) such that
    W_new z_new = W_new^{-T} s_new = lmbda_new, with lmbda_new's s blocks
    embedded as diagonal matrices (this package's lambda convention).

    Near the cone boundary this form is much better conditioned than
    recomputing W from the unscaled pair: the inputs stay O(lambda) while
    s_new, z_new individually degenerate — the reason the reference's cpl
    converges on SDP problems (e.g. examples/doc/chap9/acent2.py) where a
    recompute-from-(s,z) loop stalls.
    """
    lm_new = jnp.zeros((dims.size,), dtype=lmbda.dtype)

    # l blocks: d := d .* sqrt(s ./ z), lambda := sqrt(s .* z)
    if dims.l:
        sl, zl = s[: dims.l], z[: dims.l]
        d = W.d * jnp.sqrt(sl / zl)
        lm_new = lm_new.at[: dims.l].set(jnp.sqrt(sl * zl))
    else:
        d = W.d

    qgroups, sgroups = block_groups(dims)
    betas = list(W.beta)
    vs = list(W.v)
    for m, idxs, flat in qgroups:
        sb, zb = s[flat], z[flat]                        # (c, m)
        v = jnp.stack([W.v[k] for k in idxs])
        beta = jnp.stack([W.beta[k] for k in idxs])
        aa, bb = _jnrm2_b(sb), _jnrm2_b(zb)
        s_ = sb / aa[:, None]
        z_ = zb / bb[:, None]
        cc = jnp.sqrt((1.0 + jnp.sum(s_ * z_, axis=1)) / 2.0)
        vs_ = jnp.sum(v * s_, axis=1)
        # vz = v' J z_
        vz = v[:, 0] * z_[:, 0] - jnp.sum(v[:, 1:] * z_[:, 1:], axis=1)
        vq = (vs_ + vz) / (2.0 * cc)
        vu = vs_ - vz
        # scaled variable: lambda_k0 = c, lambda_k1 from the Householder
        # geometry (reference misc.py:422 'q' block comments)
        wk0 = 2.0 * v[:, 0] * vq - (s_[:, 0] + z_[:, 0]) / (2.0 * cc)
        dd = (v[:, 0] * vu - s_[:, 0] / 2.0 + z_[:, 0] / 2.0) / \
            (wk0 + 1.0)
        lam1 = (2.0 * (-dd * vq + 0.5 * vu))[:, None] * v[:, 1:] + \
            (0.5 * (1.0 - dd / cc))[:, None] * s_[:, 1:] + \
            (0.5 * (1.0 + dd / cc))[:, None] * z_[:, 1:]
        scal = jnp.sqrt(aa * bb)
        lam_b = scal[:, None] * jnp.concatenate(
            [cc[:, None], lam1], axis=1)
        lm_new = lm_new.at[flat].set(lam_b)
        # v := ((2 v v' - J) q)^{1/2} with q = (s_ + J z_) / (2c), so
        # (2 v v' - J) q = 2 vq v - (J s_ + z_) / (2c)   (J J = I)
        Js = jnp.concatenate([s_[:, :1], -s_[:, 1:]], axis=1)
        w = 2.0 * vq[:, None] * v - (Js + z_) / (2.0 * cc[:, None])
        w = w.at[:, 0].add(1.0)
        vb = w / jnp.sqrt(2.0 * w[:, 0])[:, None]
        beta_b = beta * jnp.sqrt(aa / bb)
        for j, k in enumerate(idxs):
            betas[k] = beta_b[j]
            vs[k] = vb[j]

    rs = list(W.r)
    rtis = list(W.rti)
    for m, idxs, flat in sgroups:
        Ls = s[flat].reshape(-1, m, m)
        Lz = z[flat].reshape(-1, m, m)
        R = jnp.stack([W.r[k] for k in idxs])
        Rti = jnp.stack([W.rti[k] for k in idxs])
        # SVD Lz' Ls = U diag(lam) V'; r := r Ls V lam^{-1/2},
        # rti := rti Lz U lam^{-1/2}
        U, lam, V = _svd_batched(jnp.swapaxes(Lz, 1, 2) @ Ls, method)
        isqrt = 1.0 / jnp.sqrt(lam)
        Rn = (R @ Ls) @ (V * isqrt[:, None, :])
        Rtin = (Rti @ Lz) @ (U * isqrt[:, None, :])
        Lam = jnp.zeros_like(Ls).at[
            :, jnp.arange(m), jnp.arange(m)].set(lam)
        lm_new = lm_new.at[flat].set(Lam.reshape(-1, m * m))
        for j, k in enumerate(idxs):
            rs[k] = Rn[j]
            rtis[k] = Rtin[j]

    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs),
                     r=tuple(rs), rti=tuple(rtis)), lm_new


def step_scaled_iterates(dims: ConeDims, lmbda, d_w, eig, step):
    """Input vector for `update_scaling_inc` after a line-search step.

    l/q blocks: the new scaled iterate lmbda + step * d_w (d_w is the
    scaled direction W^{-T} ds or W dz).  s blocks: the factor
    L = Lam^{1/2} Q diag(sqrt(1 + step*sig)) where (sig, Q) = eig is the
    eigendecomposition of scale2(lmbda, d_w) from `max_step_eig`, so that
    L L' = H(lmbda^{1/2})(I + step * scale2(lmbda, d_w)) = the new scaled
    iterate (reference cvxprog.py:1280-1330 / coneprog.py equivalent)."""
    out = lmbda + step * d_w
    _, sgroups = block_groups(dims)
    for gi, (m, idxs, flat) in enumerate(sgroups):
        sig, Q = eig[gi]
        Lam = lmbda[flat].reshape(-1, m, m)
        lam_d = jnp.diagonal(Lam, axis1=1, axis2=2)
        L = (jnp.sqrt(lam_d)[:, :, None] * Q) * jnp.sqrt(
            jnp.maximum(1.0 + step * sig, 0.0))[:, None, :]
        out = out.at[flat].set(L.reshape(-1, m * m))
    return out


def lmbda_to_cone(dims: ConeDims, W: NTScaling, lmbda):
    """Reconstruct the unscaled iterates (s, z) from the scaled state
    (W, lambda): s = W' Lam, z = W^{-1} Lam (the reference's end-of-
    iteration unscale, cvxprog.py:1310-1335 — unscaled variables are only
    needed for feasibility residuals)."""
    s = scale(dims, W, lmbda, trans=True)
    z = scale(dims, W, lmbda, inverse=True)
    return s, z


def _soc_apply(beta, v, u):
    """beta * (2 v v' - J) u for one SOC block."""
    Ju = jnp.concatenate([u[:1], -u[1:]])
    return beta * (2.0 * v * jnp.dot(v, u) - Ju)


def _soc_apply_inv(beta, v, u):
    """W^{-1} u = (1/beta) (2 (Jv)(Jv)' - J) u."""
    Jv = jnp.concatenate([v[:1], -v[1:]])
    Ju = jnp.concatenate([u[:1], -u[1:]])
    return (2.0 * Jv * jnp.dot(Jv, u) - Ju) / beta


def scale(dims: ConeDims, W: NTScaling, u, trans: bool = False,
          inverse: bool = False):
    """Apply the NT scaling to a cone vector: W u, W' u, W^{-1} u, W^{-T} u
    (reference misc_solvers.c:62 scale).  W is symmetric on the l and q
    parts, so trans only matters for the s blocks."""
    out = u
    if dims.l:
        dl = W.d if not inverse else 1.0 / W.d
        out = out.at[: dims.l].set(u[: dims.l] * dl)
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        ub = u[flat]                                     # (c, m)
        beta = jnp.stack([W.beta[k] for k in idxs])
        v = jnp.stack([W.v[k] for k in idxs])
        Ju = jnp.concatenate([ub[:, :1], -ub[:, 1:]], axis=1)
        if not inverse:
            vb = beta[:, None] * (
                2.0 * v * jnp.sum(v * ub, axis=1)[:, None] - Ju)
        else:
            Jv = jnp.concatenate([v[:, :1], -v[:, 1:]], axis=1)
            vb = (2.0 * Jv * jnp.sum(Jv * ub, axis=1)[:, None] -
                  Ju) / beta[:, None]
        out = out.at[flat].set(vb)
    for m, idxs, flat in sgroups:
        U = u[flat].reshape(-1, m, m)
        if not inverse:
            R = jnp.stack([W.r[k] for k in idxs])
        else:
            R = jnp.stack([W.rti[k] for k in idxs])
        Rt = jnp.swapaxes(R, 1, 2)
        if not inverse and not trans:        # W u     = r' U r
            V = Rt @ U @ R
        elif not inverse and trans:          # W' u    = r U r'
            V = R @ U @ Rt
        elif inverse and not trans:          # W^{-1} u = rti U rti'
            V = R @ U @ Rt
        else:                                # W^{-T} u = rti' U rti
            V = Rt @ U @ R
        out = out.at[flat].set(V.reshape(-1, m * m))
    return out


def _soc_sqrt(lam):
    """Jordan square root of an interior SOC vector."""
    a = jnrm2(lam)
    head = jnp.sqrt((lam[0] + a) / 2.0)
    return jnp.concatenate([head[None], lam[1:] / (2.0 * head)])


def scale2(dims: ConeDims, lmbda, u, inverse: bool = False):
    """Apply the cone automorphism H(lambda^{-1/2}) that maps lambda to the
    identity element e (inverse=True applies H(lambda^{1/2}), mapping e back
    to lambda).  Functional equivalent of the reference's scale2
    (misc_solvers.c:247, misc.py scale2), used for step-to-boundary
    computations: s + a*ds >= 0  <=>  e + a*scale2(lmbda, W^{-T}ds) >= 0.

      l: u / lambda           (inverse: u * lambda)
      q: H(w) u = 2 w (w'u) - jdot(w) J u  with w = lambda^{-1/2}
      s: Lam^{-1/2} U Lam^{-1/2}  elementwise u_ij / sqrt(lam_i lam_j)
         (lambda's s blocks are diagonal).
    """
    out = u
    if dims.l:
        lam_l = lmbda[: dims.l]
        out = out.at[: dims.l].set(
            u[: dims.l] * lam_l if inverse else u[: dims.l] / lam_l)
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        lam_b, ub = lmbda[flat], u[flat]                  # (c, m)
        # batched Jordan square root of lambda
        a = _jnrm2_b(lam_b)
        head = jnp.sqrt((lam_b[:, 0] + a) / 2.0)
        sq = jnp.concatenate(
            [head[:, None], lam_b[:, 1:] / (2.0 * head[:, None])], axis=1)
        if inverse:
            w = sq
        else:
            w = jnp.concatenate([sq[:, :1], -sq[:, 1:]],
                                axis=1) / _jdot_b(sq)[:, None]
        Ju = jnp.concatenate([ub[:, :1], -ub[:, 1:]], axis=1)
        vb = (2.0 * w * jnp.sum(w * ub, axis=1)[:, None] -
              _jdot_b(w)[:, None] * Ju)
        out = out.at[flat].set(vb)
    for m, idxs, flat in sgroups:
        Lam = lmbda[flat].reshape(-1, m, m)
        lam_d = jnp.diagonal(Lam, axis1=1, axis2=2)       # (c, m)
        U = u[flat].reshape(-1, m, m)
        rt = jnp.sqrt(lam_d)
        denom = rt[:, :, None] * rt[:, None, :]
        V = U * denom if inverse else U / denom
        out = out.at[flat].set(V.reshape(-1, m * m))
    return out


# ---------------------------------------------------------------------------
# pack / unpack (API parity with misc_solvers.c:404-544)
# ---------------------------------------------------------------------------


def pack_size(dims: ConeDims) -> int:
    """Length of the packed representation of a cone vector
    (l + sum(q) + sum(m*(m+1)/2) for the lower-triangle s blocks)."""
    return dims.l + sum(dims.q) + sum(m * (m + 1) // 2 for m in dims.s)


def pack(dims: ConeDims, u):
    """Full-storage cone vector -> packed storage: s blocks become their
    lower triangle, off-diagonals scaled by sqrt(2) so dot products are
    preserved."""
    parts = [u[: dims.l + sum(dims.q)]]
    sqrt2 = math.sqrt(2.0)
    for ofs, m in zip(dims.sofs, dims.s):
        X = u[ofs:ofs + m * m].reshape(m, m)
        rows, cols = jnp.tril_indices(m)
        w = jnp.where(rows == cols, 1.0, sqrt2).astype(u.dtype)
        parts.append(X[rows, cols] * w)
    return jnp.concatenate(parts) if parts else u


def unpack(dims: ConeDims, p):
    """Inverse of pack."""
    n0 = dims.l + sum(dims.q)
    out = jnp.zeros((dims.size,), dtype=p.dtype)
    out = out.at[:n0].set(p[:n0])
    pofs = n0
    isqrt2 = 1.0 / math.sqrt(2.0)
    for ofs, m in zip(dims.sofs, dims.s):
        npk = m * (m + 1) // 2
        blk = p[pofs:pofs + npk]
        rows, cols = jnp.tril_indices(m)
        w = jnp.where(rows == cols, 1.0, isqrt2).astype(p.dtype)
        X = jnp.zeros((m, m), dtype=p.dtype)
        X = X.at[rows, cols].set(blk * w)
        X = X + X.T - jnp.diag(jnp.diagonal(X))
        out = out.at[ofs:ofs + m * m].set(X.reshape(-1))
        pofs += npk
    return out


# ---------------------------------------------------------------------------
# Misc helpers used by the solvers
# ---------------------------------------------------------------------------


def sym_from_lower(dims: ConeDims, u):
    """Make the s blocks symmetric using only their authoritative
    triangle.  The cone-program API convention (reference
    doc/source/coneprog.rst, misc.py:862 symm) is that only the *lower
    triangle in column-major storage* of s-block data is referenced; our
    row-major reshape transposes the block, so the authoritative entries
    are the row-major *upper* triangle.  Idempotent on symmetric data."""
    out = u
    _, sgroups = block_groups(dims)
    for m, idxs, flat in sgroups:
        X = u[flat].reshape(-1, m, m)
        Up = jnp.triu(X)
        S = Up + jnp.swapaxes(jnp.triu(X, 1), 1, 2)
        out = out.at[flat].set(S.reshape(-1, m * m))
    return out


def sym_from_lower_cols(dims: ConeDims, G):
    """Apply sym_from_lower to every column of a dense (dims.size, n)
    coefficient matrix (the G of a cone program)."""
    if not dims.s:
        return G
    return jax.vmap(lambda col: sym_from_lower(dims, col),
                    in_axes=1, out_axes=1)(G)


def symm(dims: ConeDims, u):
    """Symmetrize the s blocks of a cone vector (reference misc_solvers.c
    symm)."""
    out = u
    _, sgroups = block_groups(dims)
    for m, idxs, flat in sgroups:
        X = u[flat].reshape(-1, m, m)
        out = out.at[flat].set(
            (0.5 * (X + jnp.swapaxes(X, 1, 2))).reshape(-1, m * m))
    return out


def wtw_scale_cols(dims: ConeDims, W: NTScaling, G):
    """Compute W^{-T} applied to every column of G — the central operation
    in all KKT strategies (reference misc.py:1090 loop of scale() over G's
    columns).  Vectorized: the l part is a row scaling, each q block a
    rank-one update, each s block two matmuls over all columns at once."""
    n = G.shape[1]
    out = G
    if dims.l:
        out = out.at[: dims.l, :].set(G[: dims.l, :] / W.d[:, None])
    qgroups, sgroups = block_groups(dims)
    for m, idxs, flat in qgroups:
        B = G[flat, :]                                   # (c, m, n)
        beta = jnp.stack([W.beta[k] for k in idxs])
        v = jnp.stack([W.v[k] for k in idxs])
        Jv = jnp.concatenate([v[:, :1], -v[:, 1:]], axis=1)
        JB = jnp.concatenate([B[:, :1, :], -B[:, 1:, :]], axis=1)
        JvB = jnp.einsum("cm,cmn->cn", Jv, B)
        V = (2.0 * Jv[:, :, None] * JvB[:, None, :] -
             JB) / beta[:, None, None]
        out = out.at[flat, :].set(V)
    for m, idxs, flat in sgroups:
        B = G[flat, :].reshape(-1, m, m, n)
        rti = jnp.stack([W.rti[k] for k in idxs])
        # rti' X rti for every column X, batched over the group
        V = jnp.einsum("cji,cjkn,ckl->ciln", rti, B, rti)
        out = out.at[flat, :].set(V.reshape(-1, m * m, n))
    return out
