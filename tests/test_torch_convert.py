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


def _quad_f32(max_iter, ct):
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=10, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, check_termination=ct)


def test_jax_carry_carried_across_continues_the_warm_sequence():
    """Two warm solves in the JAX kernel (interpret mode), then its carry
    read into the port: the next two solves from it agree with the JAX
    package's next two. The f32 bar of tests/test_torch_warm.py (atol 1e-4,
    counts within 1, equal solved flags); the port's carry written back to
    numpy rebuilds the JAX carry exactly."""
    from tinympc_tpu.kernels import FusedCarry as JaxCarry
    from tinympc_tpu.kernels import init_carry, solve_fused_warm
    from tinympc_tpu_torch.convert import carry_from_numpy, carry_to_numpy
    pj = _quad_f32(25, 5)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    B = 8
    x0 = jnp.asarray(np.random.default_rng(2).uniform(-0.2, 0.2, (B, 12)),
                     jnp.float32)
    Xref = jnp.tile(jnp.asarray([0, 0, 0.5] + [0.0] * 9, jnp.float32),
                    (10, 1))
    cj = init_carry(pj, B)
    for _ in range(2):
        _, _, cj = solve_fused_warm(pj, Xref, None, x0, cj, tile=B,
                                    interpret=True)
    ct_ = carry_from_numpy(carry_to_numpy(cj), "cpu")
    back = JaxCarry(**{k: jnp.asarray(v)
                       for k, v in carry_to_numpy(ct_).items()})
    for k in ("vnew", "znew", "g", "y", "v", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(cj, k)))
    for _ in range(2):
        sol_j, _, cj = solve_fused_warm(pj, Xref, None, x0, cj, tile=B,
                                        interpret=True)
        sol_t, _, ct_ = tt.kernels.solve_fused_warm(
            pt, torch.as_tensor(np.array(Xref)), None,
            torch.as_tensor(np.array(x0)), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(ct_.g.numpy(), np.asarray(cj.g), rtol=0,
                                   atol=1e-4)
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 1)
        np.testing.assert_array_equal(sol_t.solved.numpy(),
                                      np.asarray(sol_j.solved))


def test_jax_state_carried_across_continues_the_closed_loop():
    """Three closed-loop steps in the JAX package (float64), then its final
    state read into the port: four more steps from it agree with the JAX
    package's own four more. float64 both sides: exact counts, 1e-6."""
    from tinympc_tpu.closed_loop import closed_loop
    from tinympc_tpu_torch.convert import state_from_numpy, state_to_numpy
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                  N=10, dtype=jnp.float64)
    pj = tm.with_settings(tm.with_bounds(pj, x_min=-5.0, x_max=5.0,
                                         u_min=-0.5, u_max=0.5),
                          max_iter=40)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float64)
    B = 4
    line = np.asarray(systems.trajectory("quadrotor_20hz_y_axis_line"))
    x0 = line[0] + np.random.default_rng(4).uniform(-0.1, 0.1, (B, 12))
    xs, us, _, _, st = closed_loop(pj, tm.init_state(pj, (B,)),
                                   jnp.asarray(x0), jnp.asarray(line), 3)
    x3 = np.asarray(pj.A) @ np.asarray(xs[-1]).T \
        + np.asarray(pj.B) @ np.asarray(us[-1]).T
    x3 = jnp.asarray(x3.T)
    xs_j, us_j, it_j, sv_j, _ = closed_loop(pj, st, x3, jnp.asarray(line[3:]),
                                            4)
    st_t = state_from_numpy(state_to_numpy(st), "cpu", torch.float64)
    assert st_t.iter.dtype == torch.int32 and st_t.solved.dtype == torch.bool
    xs_t, us_t, it_t, sv_t, _ = tt.closed_loop(
        pt, st_t, torch.as_tensor(np.array(x3)),
        torch.as_tensor(line[3:]), 4)
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-6)
