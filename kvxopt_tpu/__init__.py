"""kvxopt_tpu — a convex optimization framework for accelerators.

A from-scratch JAX/XLA re-design with the capabilities of kvxopt
(a CVXOPT fork): dense/sparse matrix algebra, cone programming
(conelp/coneqp/lp/qp/socp/sdp), nonlinear convex solvers (cp/cpl/gp),
Nesterov-Todd scaling, Mehrotra predictor-corrector, pluggable KKT
strategies, sparse factorizations with fast refactorization, and a
piecewise-linear modeling DSL with MPS I/O.

Facade parity with the reference package (src/python/__init__.py):
matrix/spmatrix/sparse/spdiag, elementwise math, random generators with
seed control, and min/max/mul/div elementwise reductions.
"""

import numbers as _numbers

import numpy as _np

from . import config  # noqa: F401  (enables x64 side effect)
from .cones import ConeDims  # noqa: F401
from .base import (  # noqa: F401
    matrix, spmatrix, sparse, spdiag, fromfile,
    exp, log, sqrt, sin, cos, tan, asin, acos, atan, sinh, cosh, tanh,
    conj, emul, ediv, emin, emax, norm,
    gemv, gemm, syrk, symv, axpy)
from .gsl import normal, uniform, setseed, getseed  # noqa: F401
from . import printing  # noqa: F401

__version__ = "0.1.0"

_pymin, _pymax = min, max


def min(*args):
    """Elementwise min of matrices/scalars; with a single matrix argument,
    the minimum element (reference __init__.py:203-302)."""
    if len(args) == 1:
        a = args[0]
        if isinstance(a, (matrix, spmatrix)):
            return float(_np.asarray(a).min())
        return _pymin(a)
    out = args[0]
    for b in args[1:]:
        out = emin(out, b)
    return out


def max(*args):
    """Elementwise max (see min)."""
    if len(args) == 1:
        a = args[0]
        if isinstance(a, (matrix, spmatrix)):
            return float(_np.asarray(a).max())
        return _pymax(a)
    out = args[0]
    for b in args[1:]:
        out = emax(out, b)
    return out


def mul(*args):
    """Elementwise product of the arguments (reference __init__.py mul)."""
    out = args[0]
    for b in args[1:]:
        out = emul(out, b)
    return out


def div(*args):
    """Elementwise division (reference __init__.py div)."""
    out = args[0]
    for b in args[1:]:
        out = ediv(out, b)
    return out


__all__ = [
    "matrix", "spmatrix", "sparse", "spdiag", "normal", "uniform",
    "setseed", "getseed", "exp", "log", "sqrt", "sin", "cos", "tan",
    "mul", "div", "min", "max", "norm", "ConeDims", "printing",
    "solvers",
]

from . import solvers  # noqa: E402,F401
