"""chip_smoke.py at small sizes on the CPU: each phase runs, checks its
results against its reference and reports; the script itself refuses to
run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ctx():
    cpu = jax.devices("cpu")[0]
    return chip_smoke.Ctx(cpu, cpu, "cpu-test", seed=0)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def _phase_lines(capsys):
    return [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("phase ")]


def test_phase_device(ctx, capsys):
    chip_smoke.phase_device(ctx)
    (line,) = _phase_lines(capsys)
    assert "card=cpu-test" in line and "x64=True" in line
    assert "matmul_precision=highest" in line


def test_phase_qp(ctx, capsys):
    chip_smoke.phase_qp(ctx, n=12, m=24)
    (line,) = _phase_lines(capsys)
    assert "rel_dx_vs_cpu=" in line and "(tol 1e-06)" in line
    assert "compile_s=" in line and "warm_s=" in line


def test_phase_lp(ctx, capsys):
    chip_smoke.phase_lp(ctx, n=10, m=24, p=3)
    (line,) = _phase_lines(capsys)
    assert "rel_obj_vs_highs=" in line


def test_phase_cones(ctx, capsys):
    chip_smoke.phase_cones(ctx, n=8, nq=3, qm=4, nodes=6)
    lines = _phase_lines(capsys)
    assert [l.split(":")[0] for l in lines] == [
        "phase 4a socp n=8 q=[4]*3", "phase 4b sdp max-cut nodes=6"]


def test_phase_batched(ctx, capsys):
    chip_smoke.phase_batched(ctx, n=10, m=20, Bv=4, nv=6, mv=12, Bm=4,
                             Bs=4)
    lines = _phase_lines(capsys)
    assert len(lines) == 4
    assert all("optimal_fraction=1.0" in l for l in lines[1:])


def test_phase_cholesky(ctx, capsys):
    chip_smoke.phase_cholesky(ctx, shapes=((2, 16), (1, 32)), reps=1)
    lines = _phase_lines(capsys)
    assert len(lines) == 4
    assert all("factor_tflops=" in l and "solve_res=" in l for l in lines)


def test_phase_cholmod(ctx, capsys):
    chip_smoke.phase_cholmod(ctx, grid=8, device=True)
    (line,) = _phase_lines(capsys)
    assert "rel_residual=" in line


def test_phase_cholmod_requires_tile_path(ctx):
    with pytest.raises(AssertionError, match="tile path"):
        chip_smoke.phase_cholmod(ctx, grid=4, device=False)


def test_check_raises_over_tolerance():
    assert chip_smoke._check("e", 1e-9, 1e-8).endswith("(tol 1e-08)")
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke._check("e", 2e-8, 1e-8)
    with pytest.raises(AssertionError):
        chip_smoke._check("e", float("nan"), 1e-8)


def test_phase_four_on_virtual_devices(ctx, capsys):
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.fail("the test session provides 8 virtual CPU devices")
    chip_smoke.phase_four(ctx, devs[:4], B=8, n=6, m=12, nk=12, mk=64,
                          nd=64, nb=8, blocks=2, bsize=8, nc=4)
    lines = _phase_lines(capsys)
    assert [l.split(" ")[1] for l in lines] == ["4x-1", "4x-2", "4x-3",
                                               "4x-4"]


def test_main_prints_contract_line(monkeypatch, capsys):
    """main() on a faked GPU backend ends with the contract line."""
    cpu = jax.devices("cpu")[0]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(chip_smoke, "_card", lambda: "fake, 1 W")
    for name in ("phase_device", "phase_qp", "phase_lp", "phase_cones",
                 "phase_batched", "phase_cholesky", "phase_cholmod"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    chip_smoke.main([])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2] == "card: fake, 1 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": cpu.platform, "kind": cpu.device_kind, "count": 1}}
