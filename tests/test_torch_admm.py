"""The port's plain PyTorch ADMM solve against ``tinympc_tpu.solve`` in
float64 on the CPU, at the bar of tests/test_parity.py: exact iteration
counts and solved flags, 1e-6 on x, u and the four residuals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems

import tinympc_tpu_torch as tt

torch.set_num_threads(1)

RES = ("pri_res_state", "pri_res_input", "dua_res_state", "dua_res_input")
HOVER = [0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def _problems(name, N, max_iter, ct):
    s = getattr(systems, name)()
    ref = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                   N=N, dtype=jnp.float64)
    mine = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=torch.float64, device="cpu")
    bounds = dict(x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    kw = dict(max_iter=max_iter, check_termination=ct)
    return (tm.with_settings(tm.with_bounds(ref, **bounds), **kw),
            tt.with_settings(tt.with_bounds(mine, **bounds), **kw))


def _assert_same_solve(ref_out, mine_out):
    (sol_r, st_r, _), (sol_m, st_m, _) = ref_out, mine_out
    np.testing.assert_array_equal(sol_m.iter.numpy(), np.asarray(sol_r.iter))
    np.testing.assert_array_equal(sol_m.solved.numpy(),
                                  np.asarray(sol_r.solved))
    np.testing.assert_array_equal(st_m.status.numpy(),
                                  np.asarray(st_r.status))
    np.testing.assert_allclose(sol_m.x.numpy(), np.asarray(sol_r.x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(sol_m.u.numpy(), np.asarray(sol_r.u),
                               rtol=0, atol=1e-6)
    for k in RES:
        np.testing.assert_allclose(getattr(st_m, k).numpy(),
                                   np.asarray(getattr(st_r, k)), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ct", [1, 25])
def test_quadrotor_batch_matches_jax(ct):
    """N=20, B=16, x0 ~ U[-0.5, 0.5], hover reference, max_iter 100: a mix
    of lanes that converge and lanes that hit max_iter."""
    ref, mine = _problems("quadrotor_20hz", 20, 100, ct)
    B = 16
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 12))
    Xref = np.tile(HOVER, (20, 1))
    out_r = tm.solve(ref, tm.init_state(ref, (B,)), Xref=jnp.asarray(Xref),
                     x0=jnp.asarray(x0))
    out_m = tt.solve(mine, tt.init_state(mine, (B,)),
                     Xref=torch.as_tensor(Xref), x0=torch.as_tensor(x0))
    _assert_same_solve(out_r, out_m)
    iters = out_m[0].iter.numpy()
    assert (iters < 100).any() and (iters == 100).any()


@pytest.mark.parametrize("ct", [1, 25])
def test_cartpole_batch_matches_jax(ct):
    ref, mine = _problems("cartpole", 10, 100, ct)
    B = 16
    x0 = np.random.default_rng(1).uniform(-0.5, 0.5, (B, 4))
    Uref = np.random.default_rng(2).uniform(-0.1, 0.1, (9, 1))
    out_r = tm.solve(ref, tm.init_state(ref, (B,)), Uref=jnp.asarray(Uref),
                     x0=jnp.asarray(x0))
    out_m = tt.solve(mine, tt.init_state(mine, (B,)),
                     Uref=torch.as_tensor(Uref), x0=torch.as_tensor(x0))
    _assert_same_solve(out_r, out_m)


def test_unbatched_and_batched_reference_match_jax():
    """No batch axis at all, and a per-problem (N, *b, nx) reference."""
    ref, mine = _problems("quadrotor_20hz", 12, 60, 5)
    x0 = np.random.default_rng(3).uniform(-0.5, 0.5, 12)
    out_r = tm.solve(ref, tm.init_state(ref), x0=jnp.asarray(x0))
    out_m = tt.solve(mine, tt.init_state(mine), x0=torch.as_tensor(x0))
    _assert_same_solve(out_r, out_m)

    B = 4
    x0s = np.random.default_rng(4).uniform(-0.5, 0.5, (B, 12))
    Xref = np.random.default_rng(5).uniform(-0.2, 0.2, (12, B, 12))
    out_r = tm.solve(ref, tm.init_state(ref, (B,)), Xref=jnp.asarray(Xref),
                     x0=jnp.asarray(x0s))
    out_m = tt.solve(mine, tt.init_state(mine, (B,)),
                     Xref=torch.as_tensor(Xref), x0=torch.as_tensor(x0s))
    _assert_same_solve(out_r, out_m)


def test_two_batch_axes_equal_flat_batch():
    """Any batch shape *b: a (2, 4) batch solves each problem exactly as
    the flat batch of 8 does (per-problem freezing)."""
    _, mine = _problems("quadrotor_20hz", 10, 50, 5)
    x0 = torch.as_tensor(np.random.default_rng(6).uniform(-0.5, 0.5, (8, 12)))
    flat = tt.solve(mine, tt.init_state(mine, (8,)), x0=x0)[0]
    two = tt.solve(mine, tt.init_state(mine, (2, 4)),
                   x0=x0.reshape(2, 4, 12))[0]
    np.testing.assert_array_equal(two.iter.reshape(8).numpy(),
                                  flat.iter.numpy())
    np.testing.assert_allclose(two.x.reshape(10, 8, 12).numpy(),
                               flat.x.numpy(), rtol=0, atol=1e-12)


def test_solve_rejects_unported_settings():
    """Settings the port does not run; adaptive rho runs, but not with
    horizon-parallel sweeps, which the JAX package refuses with it too."""
    _, mine = _problems("quadrotor_20hz", 10, 50, 5)
    for kw in (dict(coarse_iters=10), dict(matmul_precision="high"),
               dict(adaptive_rho=True, horizon_parallel=True)):
        with pytest.raises(ValueError):
            tt.solve(tt.with_settings(mine, **kw), tt.init_state(mine, (2,)))
