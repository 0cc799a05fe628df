"""Ozaki-style exact-split matvec: f64-accurate products from f32
matmuls.

On hardware whose float64 matmuls are slow or emulated, the f64
refinement matvec can dominate the batched mixed-precision IPM.  This
module replaces it with the error-free splitting scheme of Ozaki et al.
(2012), "Error-free transformations of matrix multiplication":

  - each f64 operand is scaled row-wise (shared power-of-two exponent
    per contraction fiber) and split into `nslices` chunks of `nbits`
    mantissa bits at fixed bit positions (block-fixed-point),
  - chunk-by-chunk products then accumulate EXACTLY in f32: every chunk
    is bf16-representable (nbits <= 8 significant bits), so bf16, TF32
    or f32 multiplies are exact, and partial sums stay below 2^24 quanta
    because nbits = floor((24 - log2 n) / 2),
  - the f32 partial results are summed in (emulated, elementwise — that
    part is cheap) f64 and rescaled.

Accuracy: the split covers nbits*nslices mantissa bits per operand and
all nslices^2 chunk products are kept, so the result matches the true
f64 product to ~2^-(nbits*(nslices+1)) relative to the per-row scale —
with the defaults (nbits 8, nslices 6 at n=256) ~1e-14, far below the
1e-10 the mixed-precision refinement loop needs.

No reference counterpart: the reference runs on f64 CPU BLAS
(SURVEY.md L0); this is build-side machinery for hitting the
reference's 1e-7 tolerances (coneprog.py:440-454) at f32 matmul speed.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp


def default_nbits(n: int) -> int:
    """Largest chunk width (<= 8 so chunks are bf16-exact) such that a
    length-n sum of chunk products cannot round in f32."""
    return max(1, min(8, (24 - int(math.ceil(math.log2(max(n, 2))))) // 2))


def default_nslices(nbits: int, target_bits: int = 52) -> int:
    """Slices needed to cover `target_bits` of each operand's mantissa.
    52 bits ≈ full f64: the matvec error floor (~2^-52 of the per-row
    scale) then sits BELOW the mixed-precision PCG exit tolerance
    (rtol_factor*eps64*||b||), so the refinement loop terminates via its
    tolerance test instead of stalling through the 8-step window (at 44
    bits the floor sat above the tolerance and every solve burned up to
    8 extra matvecs)."""
    return int(math.ceil(target_bits / nbits))


def split_fp(A, nslices: int, nbits: int):
    """Error-free block-fixed-point split along the LAST axis.

    Returns (S, scale): S has a new leading slice axis, shape
    (nslices,) + A.shape, f32, with S[k] holding mantissa bits
    [nbits*k, nbits*(k+1)) of A / scale; scale is a power of two shared
    over the last axis (per contraction fiber), shape
    A.shape[:-1] + (1,).  sum_k S[k] * scale reproduces A to
    nbits*nslices bits.
    """
    A = jnp.asarray(A, jnp.float64)
    a = jnp.max(jnp.abs(A), axis=-1, keepdims=True)
    e = jnp.where(a > 0, jnp.ceil(jnp.log2(jnp.where(a > 0, a, 1.0))), 0.0)
    scale = jnp.exp2(e)
    r = A / scale                       # in [-1, 1]
    slices = []
    for k in range(nslices):
        sh = 2.0 ** (nbits * (k + 1))
        c = jnp.round(r * sh) / sh      # <= nbits+1 significant bits
        slices.append(c.astype(jnp.float32))
        r = r - c
    return jnp.stack(slices), scale


def split_vec(x, nslices: int, nbits: int):
    """Split a (batch of) contraction vectors; returns (Xs, scale) with
    Xs of shape x.shape[:-1] + (x.shape[-1], nslices) — the slices
    stacked as COLUMNS so one matmul against a matrix chunk computes
    all of them in a single pass over the chunk."""
    S, scale = split_fp(x, nslices, nbits)          # (t, ..., n)
    Xs = jnp.moveaxis(S, 0, -1)                     # (..., n, t)
    return Xs, scale


def matvec(Aslices, Ascale, x, nbits: int):
    """y = A @ x to ~f64 accuracy, A given pre-split by split_fp.

    Aslices: (s, ..., m, n) f32;  Ascale: (..., m, 1) f64;
    x: (..., n) f64.  Returns (..., m) f64.
    """
    ns = Aslices.shape[0]
    Xs, xscale = split_vec(x, ns, nbits)            # (..., n, t), (..., 1)
    acc = None
    for k in range(ns):
        # one f32 matmul per A-chunk against ALL x chunks: (..., m, t)
        Pk = jnp.matmul(Aslices[k], Xs,
                        preferred_element_type=jnp.float32)
        term = jnp.sum(Pk.astype(jnp.float64), axis=-1)
        acc = term if acc is None else acc + term
    return acc * Ascale[..., 0] * xscale


def ata(A, nbits: int | None = None, target_bits: int = 40):
    """Exact-split Gram matrix: A' A to ~`target_bits` of f64 accuracy
    from f32 matmuls (the GEMM counterpart of `matvec`).

    Used by the mixed-precision FACTOR refinement (kkt._mixed_core):
    the factor-residual E = K - L0 L0' only needs ~eps32^2 relative
    accuracy, so 40 bits (~1e-12) suffice and the triangular-truncated
    slice-product scheme (pairs with i+j < nslices) keeps the f32 GEMM
    count at nslices(nslices+1)/2.
    """
    A = jnp.asarray(A, jnp.float64)
    k = A.shape[-2]
    nbits = nbits or default_nbits(k)
    ns = default_nslices(nbits, target_bits)
    S, scale = split_fp(jnp.swapaxes(A, -1, -2), ns, nbits)
    # S: (ns, ..., n, k) slices of A^T, scale: (..., n, 1)
    out = None
    for i in range(ns):
        for j in range(ns - i):
            P = jnp.matmul(S[i], jnp.swapaxes(S[j], -1, -2),
                           preferred_element_type=jnp.float32)
            term = P.astype(jnp.float64)
            out = term if out is None else out + term
    return out * scale * jnp.swapaxes(scale, -1, -2)


class OzakiOperator:
    """Precomputed exact-split form of a dense f64 matrix for repeated
    y = A @ x and z = A' @ w products at f64 accuracy from f32 matmuls.

    Splitting costs one pass of elementwise f64 work per slice and is
    done once (e.g. per IPM KKT factorization); each product then costs
    `nslices` f32 matmuls per direction.  Leading batch dimensions are
    supported and the products are vmap/jit-safe.
    """

    def __init__(self, A, nslices: int | None = None,
                 nbits: int | None = None):
        A = jnp.asarray(A, jnp.float64)
        m, n = A.shape[-2], A.shape[-1]
        self.nbits = nbits or min(default_nbits(n), default_nbits(m))
        self.nslices = nslices or default_nslices(self.nbits)
        self.S, self.scale = split_fp(A, self.nslices, self.nbits)
        At = jnp.swapaxes(A, -1, -2)
        self.St, self.scalet = split_fp(At, self.nslices, self.nbits)

    def mv(self, x):
        return matvec(self.S, self.scale, x, self.nbits)

    def rmv(self, w):
        return matvec(self.St, self.scalet, w, self.nbits)

    def normal_mv(self, x):
        """x -> A' A x (the Gram/normal-equations product used by the
        mixed-precision KKT refinement loop)."""
        return self.rmv(self.mv(x))


def gram_matvec_fn(A, nslices=None, nbits=None):
    """Returns f(x) = A' A x at f64 accuracy via two exact-split
    matvecs (closure-captured slices; safe to call inside jit)."""
    op = OzakiOperator(A, nslices, nbits)
    return op.normal_mv
