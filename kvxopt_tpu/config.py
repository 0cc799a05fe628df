"""Global configuration for kvxopt_tpu.

The reference library (kvxopt, a CVXOPT fork) is a double-precision CPU
library; its solver tolerances (abstol 1e-7, reltol 1e-6, feastol 1e-7 —
reference src/python/coneprog.py:440-454) require float64 accumulation
somewhere in the pipeline:

- ``default_dtype`` — dtype used for solver state and factorizations.
  float64 by default (exact parity with the reference).
- ``compute_dtype`` — dtype of the float32 factorizations inside the
  mixed-precision KKT strategies; their results are corrected by
  iterative refinement carried out in ``default_dtype``.

x64 is enabled at import time (opt out with KVXOPT_TPU_NO_X64=1).  Every
solve runs on JAX's default device.
"""

import os

import jax

if not os.environ.get("KVXOPT_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# On the GPU an f32 matmul defaults to TF32 (about three decimal digits),
# far too coarse for interior-point iterations and for the exact-split
# products of ops/ozaki.py.  Force true-f32 matmul precision (the f64
# path is unaffected; opt out with KVXOPT_TPU_FAST_MATMUL=1).
if not os.environ.get("KVXOPT_TPU_FAST_MATMUL"):
    jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: IPM programs are large and the first
# compile per shape is expensive.  JAX_COMPILATION_CACHE_DIR, when set,
# is used as it is (JAX reads it itself).  Otherwise the cache lives in
# the checkout, under .jax_cache/<fingerprint>, a fixed path so repeat
# runs hit.  The fingerprint is host CPU features + jax version: XLA:CPU
# entries are AOT executables for the machine that compiled them, and
# loading one on a host with a different feature set can crash.
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def _cache_fingerprint():
    import hashlib
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":")[1].split()))
                    break
    except OSError:
        import platform
        feats = platform.processor() or platform.machine()
    return hashlib.sha256(
        (feats + "|" + jax.__version__).encode()).hexdigest()[:12]


def cache_dir():
    """The persistent compilation cache directory in effect."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CACHE_ROOT, _cache_fingerprint()))


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", cache_dir())
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp  # noqa: E402  (after x64 flag)

default_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
compute_dtype = jnp.float32

# Mixed-precision refinement matvec strategy: when True, the f64
# operator products inside the chol2_mixed refinement loop run as
# Ozaki-style exact-split f32 matmuls (ops/ozaki.py) instead of f64
# matmuls.  Off by default until validated per backend;
# set KVXOPT_TPU_OZAKI=1 (or config.ozaki_refine = True) to enable.
ozaki_refine = os.environ.get("KVXOPT_TPU_OZAKI", "0") == "1"

# Mixed-precision FACTOR refinement: a one-shot exact-split-Gram
# correction of the f32 Cholesky factor (kkt._mixed_core) that extends
# the fast-contraction regime by ~1.5 decades of conditioning and
# collapses the PCG refinement step count.  Read at trace time inside
# the mixed KKT strategies; like ozaki_refine it is snapshotted into
# solver Options so cached programs key on it.
factor_refine = os.environ.get("KVXOPT_TPU_FACREF", "1") == "1"


def set_default_dtype(dtype):
    global default_dtype
    default_dtype = jnp.dtype(dtype)


def set_compute_dtype(dtype):
    global compute_dtype
    compute_dtype = jnp.dtype(dtype)
