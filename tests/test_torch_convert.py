"""convert.py carries a problem across packages: a JAX TinyProblem, read
into numpy and rebuilt as the port's problem, solves the same in both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (CACHE_KEYS, problem_from_numpy,
                                       problem_to_numpy)

torch.set_num_threads(1)


def _jax_problem():
    s = systems.rocket_landing_20hz()     # affine dynamics: f, APf, BPf != 0
    N = 12
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, f=s["f"], dtype=jnp.float64)
    prob = tm.with_bounds(
        prob, x_min=np.tile([-5.0, -5.0, -0.5, -10.0, -10.0, -20.0], (N, 1)),
        x_max=np.tile([5.0, 5.0, 100.0, 10.0, 10.0, 20.0], (N, 1)),
        u_min=-10.0, u_max=105.0)
    return tm.with_settings(prob, max_iter=80, check_termination=2,
                            abs_pri_tol=2e-3)


def test_jax_problem_carried_across_solves_the_same():
    """float64 both sides, the same arrays: parity bar of
    tests/test_parity.py (exact counts, 1e-6)."""
    pj = _jax_problem()
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float64)
    assert dataclasses.asdict(pt.spec) == dataclasses.asdict(pj.spec)
    assert dataclasses.asdict(pt.settings) == dataclasses.asdict(pj.settings)
    for k in CACHE_KEYS:
        np.testing.assert_array_equal(getattr(pt.cache, k).numpy(),
                                      np.asarray(getattr(pj.cache, k)))

    B, N = 6, pj.spec.N
    rng = np.random.default_rng(7)
    x0 = np.asarray([4, 2, 20, -3, 2, -4.5]) * (1 + 0.1 * rng.uniform(
        -1, 1, (B, 6)))
    Xref = np.asarray([4, 2, 20, -3, 2, -4.5]) * (
        1 - np.arange(N)[:, None] / 99.0)
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    sol_r, st_r, _ = tm.solve(pj, tm.init_state(pj, (B,)),
                              jnp.asarray(Xref), jnp.asarray(Uref),
                              jnp.asarray(x0))
    sol_m, st_m, _ = tt.solve(pt, tt.init_state(pt, (B,)),
                              torch.as_tensor(Xref), torch.as_tensor(Uref),
                              torch.as_tensor(x0))
    np.testing.assert_array_equal(sol_m.iter.numpy(), np.asarray(sol_r.iter))
    np.testing.assert_array_equal(sol_m.solved.numpy(),
                                  np.asarray(sol_r.solved))
    np.testing.assert_allclose(sol_m.x.numpy(), np.asarray(sol_r.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sol_m.u.numpy(), np.asarray(sol_r.u), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st_m.dua_res_state.numpy(),
                               np.asarray(st_r.dua_res_state), rtol=0,
                               atol=1e-6)


def test_port_problem_round_trips():
    """problem_to_numpy -> problem_from_numpy is the identity on the
    port's own problems, in the requested dtype."""
    s = tt.systems.cartpole()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=7,
                 dtype=torch.float64, device="cpu")
    p = tt.with_settings(tt.with_bounds(p, u_min=-0.5, u_max=0.5),
                         max_iter=9)
    d = problem_to_numpy(p)
    q = problem_from_numpy(d, "cpu", torch.float64)
    assert q.spec == p.spec and q.settings == p.settings
    for k in ("A", "B", "f", "Qdiag", "Rdiag"):
        assert torch.equal(getattr(q, k), getattr(p, k))
    for k in CACHE_KEYS:
        assert torch.equal(getattr(q.cache, k), getattr(p.cache, k))
    assert torch.equal(q.cons.u_max, p.cons.u_max)
    q32 = problem_from_numpy(d, "cpu")
    assert q32.dtype == torch.float32 and q32.cache.Kinf.dtype == torch.float32
