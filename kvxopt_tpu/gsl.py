"""Random matrix generators (reference src/C/gsl.c: normal / uniform /
weibull / setseed / getseed).

The reference wraps GSL's Mersenne generator; here the generators are
jax.random (threefry) driven — deterministic, splittable, and identical on
CPU/GPU — returning dense `matrix` objects for facade parity and raw jax
arrays via the *_jax variants.
"""

import numpy as np
import jax

from . import config
from .base import matrix

_seed = 0
_key = None  # created lazily: PRNGKey at import time would initialize
             # the jax backend during `import kvxopt_tpu`, making the
             # whole package unimportable when no backend is available


def setseed(value=0):
    """Set the RNG seed (reference gsl.c setseed)."""
    global _seed, _key
    _seed = int(value)
    _key = jax.random.PRNGKey(_seed)


def getseed():
    """Return the current seed (reference gsl.c getseed)."""
    return _seed


def _next_key():
    global _key
    if _key is None:
        _key = jax.random.PRNGKey(_seed)
    _key, sub = jax.random.split(_key)
    return sub


def normal_jax(nrows, ncols=1, mean=0.0, std=1.0):
    """Like `normal` but returns a jax array drawn with
    jax.random (device-resident; advances the module PRNG key)."""
    return mean + std * jax.random.normal(
        _next_key(), (nrows, ncols), dtype=config.default_dtype)


def uniform_jax(nrows, ncols=1, a=0.0, b=1.0):
    """Like `uniform` but returns a jax array drawn with
    jax.random (device-resident; advances the module PRNG key)."""
    return jax.random.uniform(_next_key(), (nrows, ncols),
                              dtype=config.default_dtype, minval=a, maxval=b)


def weibull_jax(nrows, ncols=1, a=1.0, b=1.0):
    """Weibull(a, b) samples as a jax array (jax.random;
    advances the module PRNG key)."""
    # inverse-CDF sampling: X = b * (-log(1-U))^{1/a}
    u = jax.random.uniform(_next_key(), (nrows, ncols),
                           dtype=config.default_dtype)
    import jax.numpy as jnp
    return b * (-jnp.log1p(-u)) ** (1.0 / a)


def normal(nrows, ncols=1, mean=0.0, std=1.0):
    """nrows-by-ncols matrix of N(mean, std^2) samples."""
    return matrix(np.asarray(normal_jax(nrows, ncols, mean, std)))


def uniform(nrows, ncols=1, a=0.0, b=1.0):
    """nrows-by-ncols matrix of U[a, b) samples."""
    return matrix(np.asarray(uniform_jax(nrows, ncols, a, b)))


def weibull(nrows, ncols=1, a=1.0, b=1.0):
    """nrows-by-ncols matrix of Weibull(a, b) samples."""
    return matrix(np.asarray(weibull_jax(nrows, ncols, a, b)))
