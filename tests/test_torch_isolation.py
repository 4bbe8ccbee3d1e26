"""The port stands alone: it imports neither JAX nor the JAX package (its
adaptive-rho modules, the fleet solver and the roofline probes and tool
included), runs on cuda unless told otherwise, and rejects what this slice
does not cover."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.kernels import fused_supported, solve_fused

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "tinympc_tpu_torch"

_CHILD = r"""
import sys
import numpy as np
import torch
import tinympc_tpu_torch as tt
s = tt.systems.quadrotor_20hz()
p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=6,
             dtype=torch.float32, device="cpu")
p = tt.with_settings(tt.with_bounds(p, u_min=-0.5, u_max=0.5), max_iter=10)
x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (3, 12)),
                     dtype=torch.float32)
sol, res = tt.kernels.solve_fused(p, None, None, x0)
sol2, _, _ = tt.solve(p, tt.init_state(p, (3,)), x0=x0)
assert torch.isfinite(sol.x).all() and torch.isfinite(sol2.x).all()
sol5, _ = tt.kernels.solve_fused_streamed(p, None, None, x0)
assert torch.equal(sol5.x, sol.x)
assert "tinympc_tpu_torch.kernels.admm_stream" in sys.modules
sol6, _ = tt.make_fleet_solver([p, p])(np.array([0, 1, 1]), x0)
assert torch.equal(sol6.x[:, 1:], sol.x[:, 1:])
assert tt.kernels.dot_probe(2, 12, 4, True, 1, device="cpu").shape == (12, 4)
import tinympc_tpu_torch.roofline
p = tt.with_settings(p, adaptive_rho=True)     # computes the sensitivities
sol3, res3 = tt.kernels.solve_fused(p, None, None, x0)
sol4, _, cache = tt.solve(p, tt.init_state(p, (3,)), x0=x0)
assert torch.isfinite(res3).all() and torch.isfinite(cache.Kinf).all()
assert "tinympc_tpu_torch.rho_adapt" in sys.modules
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "tinympc_tpu"
       or m.startswith("tinympc_tpu.")]
print("IMPORTED", bad)
"""


def test_cpu_solve_imports_no_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout, out.stdout


def test_no_source_file_names_jax_or_the_jax_package():
    """Static check over every module of the port, including code that only
    runs on the GPU: no import of jax or tinympc_tpu, and no path to the
    JAX package's fixture data."""
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        assert "_data.py" not in src, path
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "tinympc_tpu"), \
                    f"{path}: imports {n}"


def test_setup_without_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = tt.systems.cartpole()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=5)


def _quad(**settings):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=5,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=5, **settings)


@pytest.mark.parametrize("settings", [
    dict(matmul_precision="high"), dict(matmul_precision="default"),
    dict(coarse_iters=50), dict(adaptive_rho=True, horizon_parallel=True),
], ids=["high", "default", "coarse_iters", "adaptive_rho"])
def test_solve_fused_rejects_settings_outside_the_slice(settings):
    p = _quad(**settings)
    assert not fused_supported(p)
    with pytest.raises(ValueError):
        solve_fused(p, None, None, torch.zeros((2, 12)))


def test_solve_fused_rejects_specs_outside_the_slice():
    p = _quad()
    assert fused_supported(p)
    consensus = p.replace(spec=dataclasses.replace(p.spec, en_consensus=True))
    s = tt.systems.synthetic(5, 2)
    odd = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                   N=5, device="cpu")      # (nx, nu) = (5, 2): not built
    for bad in (consensus, odd):
        assert not fused_supported(bad)
        with pytest.raises(ValueError):
            solve_fused(bad, None, None, torch.zeros((2, bad.spec.nx)))
