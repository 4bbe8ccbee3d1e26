"""The fused solve's plain PyTorch version (what ``solve_fused`` runs on CPU
tensors, and what the CUDA kernel is held against on the card) against the
JAX package's fused Pallas kernel in interpret mode, as
tests/test_fused_kernel.py runs it, on the same float32 problem.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against this
plain version on the GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import solve_fused as jax_solve_fused

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (fused_supported, solve_fused,
                                       solve_fused_reference)
from tinympc_tpu_torch.kernels.admm_fused import BLOCK

torch.set_num_threads(1)

N = 10
HOVER = [0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def _jax_problem(max_iter, ct):
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, check_termination=ct)


def _inputs(B, seed=0):
    x0 = np.random.default_rng(seed).uniform(-0.5, 0.5, (B, 12))
    Xref = np.tile(HOVER, (N, 1))
    return x0.astype(np.float32), Xref.astype(np.float32)


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("max_iter", [15, 30])
@pytest.mark.parametrize("ct", [1, 5])
def test_plain_version_matches_jax_fused_kernel(B, max_iter, ct):
    """The same f32 problem (the JAX problem carried across by convert.py)
    through both fused solves. Bar of tests/test_fused_kernel.py:29-44:
    atol 1e-4 on x, u and the residuals (float32 sums in another order on
    each side, over up to 30 iterations), iteration counts within 1,
    equal solved flags."""
    pj = _jax_problem(max_iter, ct)
    x0, Xref = _inputs(B)
    sol_r, res_r = jax_solve_fused(pj, jnp.asarray(Xref), None,
                                   jnp.asarray(x0), tile=B, interpret=True)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    sol_m, res_m = solve_fused_reference(pt, torch.as_tensor(Xref), None,
                                         torch.as_tensor(x0))
    np.testing.assert_allclose(sol_m.x.numpy(), np.asarray(sol_r.x),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(sol_m.u.numpy(), np.asarray(sol_r.u),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_m.numpy(), np.asarray(res_r), rtol=0,
                               atol=1e-4)
    assert np.all(np.abs(sol_m.iter.numpy() - np.asarray(sol_r.iter)) <= 1)
    np.testing.assert_array_equal(sol_m.solved.numpy(),
                                  np.asarray(sol_r.solved))


@pytest.mark.parametrize("ct", [1, 5])
def test_plain_version_matches_port_admm_solve(ct):
    """The kernel-layout plain version against the port's own admm.solve
    on the same f32 problem: the same float32 operations in the same order
    on the CPU, only the layout differs, so 1e-6 and exact counts."""
    pt = problem_from_numpy(problem_to_numpy(_jax_problem(40, ct)), "cpu",
                            torch.float32)
    x0, Xref = _inputs(24, seed=1)
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    sol_f, res_f = solve_fused_reference(pt, Xref, None, x0)
    sol_s, st, _ = tt.solve(pt, tt.init_state(pt, (24,)), Xref, None, x0)
    np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
    np.testing.assert_array_equal(sol_f.solved.numpy(), sol_s.solved.numpy())
    np.testing.assert_allclose(sol_f.x.numpy(), sol_s.x.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sol_f.u.numpy(), sol_s.u.numpy(), rtol=0,
                               atol=1e-6)
    res_s = torch.stack([st.pri_res_state, st.pri_res_input,
                         st.dua_res_state, st.dua_res_input])
    np.testing.assert_allclose(res_f.numpy(), res_s.numpy(), rtol=0,
                               atol=1e-6)


def test_ragged_batch_gives_per_lane_results_of_full_batch():
    """B not a multiple of the kernel's block: every lane returns what it
    returns inside a full batch (converged lanes freeze, so a lane's result
    never depends on its neighbours). Float32 on the CPU with products of
    different widths: 1e-6 and exact counts."""
    pt = problem_from_numpy(problem_to_numpy(_jax_problem(60, 5)), "cpu",
                            torch.float32)
    x0, Xref = _inputs(BLOCK, seed=2)      # one full block, then 13 lanes
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    full, res_full = solve_fused(pt, Xref, None, x0)
    part, res_part = solve_fused(pt, Xref, None, x0[:13])
    np.testing.assert_array_equal(part.iter.numpy(), full.iter[:13].numpy())
    np.testing.assert_array_equal(part.solved.numpy(),
                                  full.solved[:13].numpy())
    np.testing.assert_allclose(part.x.numpy(), full.x[:, :13].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(part.u.numpy(), full.u[:, :13].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_part.numpy(), res_full[:, :13].numpy(),
                               rtol=0, atol=1e-6)
    assert full.solved.any() and not full.solved.all()


def test_solve_fused_on_cpu_runs_the_plain_version_in_public_layout():
    pt = problem_from_numpy(problem_to_numpy(_jax_problem(20, 5)), "cpu",
                            torch.float32)
    x0, Xref = _inputs(5, seed=3)
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    sol, res = solve_fused(pt, Xref, None, x0)
    ref, ref_res = solve_fused_reference(pt, Xref, None, x0)
    assert sol.x.shape == (N, 5, 12) and sol.u.shape == (N - 1, 5, 4)
    assert sol.iter.shape == (5,) and sol.iter.dtype == torch.int32
    assert sol.solved.dtype == torch.bool and res.shape == (4, 5)
    assert sol.x.dtype == torch.float32
    for a, b in ((sol.x, ref.x), (sol.u, ref.u), (res, ref_res),
                 (sol.iter, ref.iter), (sol.solved, ref.solved)):
        assert torch.equal(a, b)


def test_solve_fused_checks_its_inputs():
    pt = problem_from_numpy(problem_to_numpy(_jax_problem(20, 5)), "cpu",
                            torch.float32)
    assert fused_supported(pt)
    x0, Xref = _inputs(4)
    with pytest.raises(ValueError):
        solve_fused(pt, torch.as_tensor(Xref[:-1]), None, torch.as_tensor(x0))
    with pytest.raises(ValueError):
        solve_fused(pt, None, None, torch.as_tensor(x0[:, :5]))
    with pytest.raises(ValueError):
        solve_fused(pt, None, None, None)
