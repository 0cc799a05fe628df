"""The solvers' cached fast path and process-level configuration: one
jitted program per (dims, kktsolver, Options) key whose errors reach the
caller, the persistent compile cache directory, and an import that
leaves JAX's platform list alone."""

import os
import subprocess
import sys

import numpy as np
import pytest

from kvxopt_tpu import solvers
from kvxopt_tpu.solvers import coneprog as cp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lp():
    c = np.array([-4., -5.])
    G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    h = np.array([3., 3., 0., 0.])
    return lambda: solvers.lp(c, G, h)


def _qp():
    P, q = np.eye(2), np.array([1., -1.])
    G, h = -np.eye(2), np.zeros(2)
    return lambda: solvers.qp(P, q, G, h)


@pytest.mark.parametrize("name,factory,call", [
    ("lp", "_cached_lp_solver_full", _lp),
    ("qp", "_cached_qp_solver_full", _qp)])
def test_failing_program_raises_without_retry(monkeypatch, name, factory,
                                              call):
    """A failing cached program propagates its error; nothing retries it
    on another program, executor or the eager path."""
    calls = []

    def failing(dims, kktsolver, o):
        def run(*args):
            calls.append(args)
            raise RuntimeError(f"{name} program failed (simulated)")
        return run

    monkeypatch.setattr(cp, factory, failing)
    solve = call()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="simulated"):
            solve()
    assert len(calls) == 2, "one attempt per call, no retry"


@pytest.mark.parametrize("name,call,x", [
    ("lp", _lp, [1.0, 1.0]), ("qp", _qp, [0.0, 1.0])])
def test_fast_path_program_is_cached(name, call, x):
    """Repeated same-shape solves reuse one compiled program."""
    solve = call()
    sol = solve()
    assert sol["status"] == "optimal"
    np.testing.assert_allclose(np.asarray(sol["x"]).ravel(), x, atol=1e-6)
    fn = (cp._cached_lp_solver_full if name == "lp"
          else cp._cached_qp_solver_full)
    hits = fn.cache_info().hits
    solve()
    assert fn.cache_info().hits == hits + 1


def _child(code, env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


_CACHE_PROBE = (
    "import jax, kvxopt_tpu\n"
    "from kvxopt_tpu import config\n"
    "print(jax.config.jax_compilation_cache_dir, '|', config.cache_dir())\n")


def test_cache_dir_follows_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, exactly that directory is used
    and the solver writes its programs there."""
    d = str(tmp_path / "cache")
    code = _CACHE_PROBE + (
        "import numpy as np\n"
        "from kvxopt_tpu import solvers\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "solvers.lp(np.array([-4., -5.]), np.array([[2., 1.], [1., 2.], "
        "[-1., 0.], [0., -1.]]), np.array([3., 3., 0., 0.]))\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    line = _child(code, {"JAX_COMPILATION_CACHE_DIR": d})
    assert line == d
    assert os.listdir(d), "no cache entries written"


def test_cache_dir_default_in_checkout():
    """Unset, the cache is a fixed, gitignored directory of the checkout."""
    line = _child(_CACHE_PROBE, {})
    used, reported = (s.strip() for s in line.split("|"))
    assert used == reported
    root = os.path.join(REPO, ".jax_cache")
    assert os.path.dirname(used) == root
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_import_leaves_platforms_alone():
    """Importing the package does not widen a pinned platform list."""
    line = _child("import jax, kvxopt_tpu\n"
                  "print(jax.config.jax_platforms)\n", {})
    assert line == "cpu"
