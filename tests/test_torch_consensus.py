"""Scenario-tree consensus on u[0] in the port's plain solve, float64,
against the JAX package's XLA path on the same numpy inputs: the port's
versions of tests/test_consensus.py:25-97, a warm sequence, SOC with
consensus on the rocket, the closed loop and convert. Bar of
tests/test_parity.py: exact iteration counts and solved flags, 1e-6 on x,
u, the consensus slack ``zc0new`` and dual ``yc0`` and the residuals.
Batches are (n_groups, G): the scenario group is the last batch axis."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy,
                                       state_from_numpy, state_to_numpy)

torch.set_num_threads(1)

N = 10
XREF = np.tile([0, 0, 1.0] + [0.0] * 9, (N, 1))


def _jax_problem(max_iter=500, **kw):
    """tests/test_consensus.py:_problem: the quadrotor at 20 Hz, N=10, box
    +-5 / +-0.5, float64."""
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                    dtype=jnp.float64)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, **kw)


def _port(pj):
    """The JAX problem's arrays as the port's float64 problem, the consensus
    gains baked by the port's own with_consensus where the JAX problem has
    consensus on."""
    d = problem_to_numpy(pj)
    for k in ("Kinf0", "Quu0_inv"):
        d.pop(k, None)
    spec, settings = dict(d["spec"]), dict(d["settings"])
    d["spec"] = dict(spec, en_consensus=False)
    d["settings"] = dict(settings, consensus_rho=None,
                         consensus_axis_name=None)
    pt = problem_from_numpy(d, "cpu", torch.float64)
    if spec["en_consensus"]:
        pt = tt.with_consensus(pt, rho_c=settings["consensus_rho"],
                               axis_name=settings["consensus_axis_name"])
    return pt


def _solve_both(pj, pt, x0, Xref=XREF, Uref=None, state_j=None,
                state_t=None):
    b = x0.shape[:-1]
    state_j = tm.init_state(pj, b) if state_j is None else state_j
    state_t = tt.init_state(pt, b) if state_t is None else state_t
    sol_j, st_j, _ = tm.solve(pj, state_j, Xref=jnp.asarray(Xref),
                              Uref=None if Uref is None else jnp.asarray(Uref),
                              x0=jnp.asarray(x0))
    sol_t, st_t, _ = tt.solve(pt, state_t, torch.as_tensor(Xref),
                              None if Uref is None else torch.as_tensor(Uref),
                              torch.as_tensor(x0))
    return sol_j, st_j, sol_t, st_t


def _assert_parity(sol_j, st_j, sol_t, st_t, atol=1e-6):
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))
    for k in ("x", "u", "zc0new", "yc0", "pri_res_state", "pri_res_input",
              "dua_res_state", "dua_res_input"):
        np.testing.assert_allclose(getattr(st_t, k).numpy(),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=atol)


def _x0s(ng, G, seed=0):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (ng, G, 12))


def test_identical_scenarios_match_the_plain_solve():
    """tests/test_consensus.py:25-40: with identical scenarios the consensus
    constraint is inactive at the optimum, so the consensus solve and the
    plain one agree to 3e-3; and the port's consensus solve meets the
    parity bar against the JAX one."""
    pj = _jax_problem()
    pt = _port(pj)
    x0 = np.tile([0, 0.3, 0.5] + [0.0] * 9, (1, 4, 1))
    pjc, ptc = tm.with_consensus(pj), tt.with_consensus(pt)
    sol_j, st_j, sol_t, st_t = _solve_both(pjc, ptc, x0)
    _assert_parity(sol_j, st_j, sol_t, st_t)
    sol_p = tt.solve(pt, tt.init_state(pt, (1, 4)), torch.as_tensor(XREF),
                     None, torch.as_tensor(x0))[0]
    np.testing.assert_allclose(sol_t.u.numpy(), sol_p.u.numpy(), atol=3e-3)


@pytest.mark.parametrize("rho_c", [None, 1.0, 100.0, 1000.0])
def test_consensus_forces_a_common_u0(rho_c):
    """tests/test_consensus.py:43-80 at the default rho_c (rho = 5) and at
    1, 100 and 1000, its eight scenarios as one group (batch (1, 8)): the
    port meets the parity bar against the JAX package, and the group's u[0]
    spread contracts from the plain solve's (by 1.2x at the default, as
    there; at all at rho_c 1), and closes below 5e-3 (100) and 1e-4 (1000)
    with |u[0] - zc0new| below 2e-3 and 1e-4."""
    pj = tm.with_consensus(_jax_problem(), rho_c=rho_c)
    pt = _port(pj)
    x0 = _x0s(1, 8)
    sol_j, st_j, sol_t, st_t = _solve_both(pj, pt, x0)
    _assert_parity(sol_j, st_j, sol_t, st_t)
    plain = _port(_jax_problem())
    u0_plain = tt.solve(plain, tt.init_state(plain, (1, 8)),
                        torch.as_tensor(XREF), None,
                        torch.as_tensor(x0))[1].u[0].numpy()
    u0 = st_t.u[0].numpy()
    spread = np.ptp(u0, axis=1).max()
    gap = np.abs(u0 - st_t.zc0new.numpy()).max()
    assert np.ptp(u0_plain, axis=1).max() > 0.1
    if rho_c is None:
        assert spread < np.ptp(u0_plain, axis=1).max() / 1.2
    elif rho_c == 1.0:
        assert spread < np.ptp(u0_plain, axis=1).max()
    elif rho_c == 100.0:
        assert spread < 5e-3 and gap < 2e-3, (spread, gap)
    else:
        assert spread < 1e-4 and gap < 1e-4, (spread, gap)


def test_consensus_rho_via_with_settings_rebakes_the_gains():
    """tests/test_consensus.py:83-100: a new consensus_rho through
    with_settings re-bakes the step-0 gains, bitwise what with_consensus
    bakes, within 1e-12 of the JAX package's; the solve stays finite and
    contracts the spread."""
    pt = _port(_jax_problem())
    via_settings = tt.with_settings(tt.with_consensus(pt),
                                    consensus_rho=100.0)
    via_builder = tt.with_consensus(pt, rho_c=100.0)
    for k in ("Kinf0", "Quu0_inv"):
        assert torch.equal(getattr(via_settings.cache, k),
                           getattr(via_builder.cache, k))
    pj = tm.with_settings(tm.with_consensus(_jax_problem()),
                          consensus_rho=100.0)
    for k in ("Kinf0", "Quu0_inv"):
        np.testing.assert_allclose(getattr(via_settings.cache, k).numpy(),
                                   np.asarray(getattr(pj.cache, k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    st = tt.solve(via_settings, tt.init_state(via_settings, (1, 8)),
                  torch.as_tensor(XREF), None,
                  torch.as_tensor(_x0s(1, 8)))[1]
    u0 = st.u[0].numpy()
    assert np.isfinite(u0).all() and np.ptp(u0, axis=1).max() < 5e-3


def test_consensus_refuses_adaptive_rho():
    """tests/test_consensus.py:103-108, and a solve of a consensus spec
    under adaptive rho, with the JAX package's message. (The adaptive
    problems here skip the sensitivities, which the guards never read.)"""
    pt = _port(_jax_problem())
    adaptive = pt.replace(settings=dataclasses.replace(pt.settings,
                                                       adaptive_rho=True))
    with pytest.raises(ValueError, match="adaptive_rho"):
        tt.with_consensus(adaptive)
    with pytest.raises(ValueError, match="adaptive_rho"):
        tt.with_settings(tt.with_consensus(pt), adaptive_rho=True)
    pc = tt.with_consensus(pt)
    bad = pc.replace(settings=dataclasses.replace(pc.settings,
                                                  adaptive_rho=True))
    with pytest.raises(ValueError, match="consensus"):
        tt.solve(bad, tt.init_state(bad, (1, 2)))


def test_axis_name_and_missing_gains_are_refused():
    """Consensus over a named mesh axis waits for shard.py (ROADMAP.md); a
    consensus spec without the step-0 gains raises as the JAX package
    does, in the plain solve and the fused one."""
    pt = _port(_jax_problem(max_iter=5))
    sharded = tt.with_consensus(pt, axis_name="scen")
    assert sharded.settings.consensus_axis_name == "scen"
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tt.solve(sharded, tt.init_state(sharded, (1, 2)))
    bare = pt.replace(spec=dataclasses.replace(pt.spec, en_consensus=True))
    with pytest.raises(ValueError, match="with_consensus"):
        tt.solve(bare, tt.init_state(bare, (1, 2)))
    f32 = problem_from_numpy(problem_to_numpy(bare), "cpu")
    assert not tt.kernels.fused_supported(f32)
    assert not tt.kernels.fused_supported(tt.with_consensus(
        problem_from_numpy(problem_to_numpy(pt), "cpu"), axis_name="scen"))
    with pytest.raises(ValueError, match="with_consensus"):
        tt.kernels.solve_fused(f32, None, None, torch.zeros((1, 2, 12)))


def test_warm_sequence_carries_the_consensus_pair():
    """Four warm solves, each from the previous state, the plant stepped
    with u[0]: the slack re-seeds from the carried u[0] and the dual
    persists; parity bar at every step, zc0new and yc0 included."""
    pj = tm.with_consensus(_jax_problem(max_iter=40), rho_c=50.0)
    pt = _port(pj)
    x0 = _x0s(2, 4, seed=7)
    st_j, st_t = tm.init_state(pj, (2, 4)), tt.init_state(pt, (2, 4))
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    for _ in range(4):
        sol_j, st_j, sol_t, st_t = _solve_both(pj, pt, x0, state_j=st_j,
                                               state_t=st_t)
        _assert_parity(sol_j, st_j, sol_t, st_t)
        x0 = x0 @ A.T + np.asarray(st_j.u[0]) @ Bm.T


def test_soc_with_consensus_on_the_rocket():
    """The rocket with its cones and box bounds, consensus over groups of
    four (rho_c 100): parity bar, the cone duals included."""
    s = systems.rocket_landing_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  f=s["f"], dtype=jnp.float64)
    pj = tm.with_bounds(
        pj, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    pj = tm.with_cones(pj, state_cones=[(0, 3, 0.25)],
                       input_cones=[(0, 3, 0.5)])
    pj = tm.with_consensus(tm.with_settings(pj, max_iter=60,
                                            abs_pri_tol=2e-3), rho_c=100.0)
    pt = _port(pj)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x0 = xinit * np.random.default_rng(3).uniform(0.9, 1.2, (2, 4, 1))
    Xref = np.linspace(xinit, np.zeros(6), N)
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    sol_j, st_j, sol_t, st_t = _solve_both(pj, pt, x0, Xref, Uref)
    _assert_parity(sol_j, st_j, sol_t, st_t)
    for k in ("gc", "yc"):
        np.testing.assert_allclose(getattr(st_t, k).numpy(),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_closed_loop_with_consensus_and_shift_warm():
    """closed_loop with consensus and shift_warm against the JAX package's:
    the consensus pair passes through the shift unshifted, and the loop
    meets the parity bar on every step's applied input and counts."""
    pj = tm.with_consensus(_jax_problem(max_iter=30), rho_c=100.0)
    pt = _port(pj)
    x0 = _x0s(2, 2, seed=4)
    out_j = tm.closed_loop(pj, tm.init_state(pj, (2, 2)), jnp.asarray(x0),
                           jnp.asarray(XREF), 4, shift_warm=True)
    out_t = tt.closed_loop(pt, tt.init_state(pt, (2, 2)), torch.as_tensor(x0),
                           torch.as_tensor(XREF), 4, shift_warm=True)
    for k, (a, b) in enumerate(zip(out_t[:4], out_j[:4])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=str(k))
    for k in ("zc0new", "yc0", "u"):
        np.testing.assert_allclose(getattr(out_t[4], k).numpy(),
                                   np.asarray(getattr(out_j[4], k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    st = out_t[4]
    shifted = tt.shift_state(st)
    assert torch.equal(shifted.zc0new, st.zc0new)
    assert torch.equal(shifted.yc0, st.yc0)


def test_convert_carries_the_consensus_fields():
    """convert carries the step-0 gains in the cache, zc0new / yc0 in the
    state and zc0 / yc0 in the carry, both ways, as numpy."""
    pj = tm.with_consensus(_jax_problem(max_iter=5), rho_c=30.0)
    d = problem_to_numpy(pj)
    pt = problem_from_numpy(d, "cpu", torch.float64)
    for k in ("Kinf0", "Quu0_inv"):
        np.testing.assert_array_equal(getattr(pt.cache, k).numpy(),
                                      np.asarray(getattr(pj.cache, k)))
        np.testing.assert_array_equal(problem_to_numpy(pt)[k], d[k])
    assert pt.spec.en_consensus and pt.settings.consensus_rho == 30.0
    st_j = tm.solve(pj, tm.init_state(pj, (1, 3)), jnp.asarray(XREF), None,
                    jnp.asarray(_x0s(1, 3)))[1]
    st_t = state_from_numpy(state_to_numpy(st_j), "cpu", torch.float64)
    for k in ("zc0new", "yc0"):
        np.testing.assert_array_equal(getattr(st_t, k).numpy(),
                                      np.asarray(getattr(st_j, k)))
        np.testing.assert_array_equal(state_to_numpy(st_t)[k],
                                      np.asarray(getattr(st_j, k)))
    from tinympc_tpu.kernels import init_carry as jax_init_carry
    cj = jax_init_carry(tm.with_consensus(_jax_problem()), 6)
    rng = np.random.default_rng(5)
    cd = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in carry_to_numpy(cj).items()}
    assert {"zc0", "yc0", "x", "u"} <= set(cd)
    ct_ = carry_from_numpy(cd, "cpu")
    assert ct_.zc0.shape == (4, 6) and ct_.yc0.shape == (4, 6)
    back = carry_to_numpy(ct_)
    assert set(back) == set(cd)
    for k in cd:
        np.testing.assert_array_equal(back[k], cd[k])
