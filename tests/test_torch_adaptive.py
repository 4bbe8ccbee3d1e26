"""The port's adaptive rho against the JAX package on the CPU, in float64:
``riccati.compute_sensitivities``, the Crazyflie tables, the functions of
``rho_adapt``, ``admm.solve`` with adaptive rho (the telescoped plain
solve) on the box, the guard, ``apply_c``, SOC + box and a batched cache
threaded through three solves, and the golden ``quadrotor_hovering_adaptive``
replayed through the port at tests/test_parity.py's bar."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import riccati as jriccati
from tinympc_tpu import rho_adapt as jrho
from tinympc_tpu import systems

import tinympc_tpu_torch as tt
from tinympc_tpu_torch import rho_adapt as trho
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy

from helpers import load_golden, steps_array

torch.set_num_threads(1)

N = 10
RES = ("pri_res_state", "pri_res_input", "dua_res_state", "dua_res_input")
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _port(pj):
    """The JAX problem, sensitivities and (batched) cache included, as the
    port's float64 problem."""
    return problem_from_numpy(problem_to_numpy(pj), "cpu", F64)


# ------------------------------------------------------- sensitivities

@pytest.mark.parametrize("name", ["quadrotor_20hz", "cartpole"])
def test_compute_sensitivities_matches_jax(name):
    """d{Kinf, Pinf, Quu_inv, AmBKt}/drho by forward differentiation
    through the Riccati fixed point, from the raw cost diagonals, to
    1e-8."""
    s = getattr(systems, name)()
    args = [np.asarray(s[k], np.float64) for k in ("A", "B", "f", "Qdiag",
                                                   "Rdiag")]
    want = jriccati.compute_sensitivities(*(jnp.asarray(a) for a in args),
                                          jnp.float64(s["rho"]))
    got = tt.riccati.compute_sensitivities(*(_t(a) for a in args), s["rho"])
    for g, w, k in zip(got, want, ("dKinf", "dPinf", "dC1", "dC2")):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8, err_msg=k)


def test_crazyflie_tables_equal_the_jax_packages():
    for mine, theirs in zip(tt.systems.crazyflie_sensitivity_tables(),
                            systems.crazyflie_sensitivity_tables()):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert np.array_equal(mine, theirs)


def test_with_settings_attaches_the_sensitivities():
    """Turning adaptive rho on computes the sensitivities of the system,
    as the JAX package's with_settings does; explicit tables override."""
    s = systems.cartpole()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float64)
    pt = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=F64, device="cpu")
    assert pt.cache.dKinf_drho is None
    pj, pt = (tm.with_settings(pj, adaptive_rho=True),
              tt.with_settings(pt, adaptive_rho=True))
    for k in ("dKinf_drho", "dPinf_drho", "dC1_drho", "dC2_drho"):
        np.testing.assert_allclose(getattr(pt.cache, k).numpy(),
                                   np.asarray(getattr(pj.cache, k)), rtol=0,
                                   atol=1e-8, err_msg=k)
    tables = tt.systems.crazyflie_sensitivity_tables()
    pc = tt.with_sensitivities(pt, tables)
    assert np.array_equal(pc.cache.dPinf_drho.numpy(), tables[1])


# ------------------------------------------------------------ rho_adapt

def _random_state(rng, b=(5,), nx=12, nu=4):
    x = rng.normal(size=(N, *b, nx))
    u = rng.normal(size=(N - 1, *b, nu))
    return dict(x=x, u=u, vnew=x + 0.1 * rng.normal(size=x.shape),
                znew=np.clip(u, -0.5, 0.5), g=0.2 * rng.normal(size=x.shape),
                y=0.2 * rng.normal(size=u.shape))


@pytest.mark.parametrize("telescoped", [False, True])
def test_osqp_residuals_match_jax(telescoped):
    """The matrix-free OSQP residuals and norms, plain and with the
    terminal Pinf telescoped per problem."""
    rng = np.random.default_rng(0)
    s = systems.quadrotor_20hz()
    A, B = s["A"], s["B"]
    Q, R = s["Qdiag"] + 5.0, s["Rdiag"] + 5.0
    Pinf = rng.normal(size=(12, 12))
    st = _random_state(rng)
    kw = {}
    if telescoped:
        kw = dict(dPinf=rng.normal(size=(12, 12)),
                  drho=rng.normal(size=(5,)))
    want = jrho.osqp_residuals(
        *(jnp.asarray(a) for a in (A, B, Q, R, Pinf)),
        *(jnp.asarray(st[k]) for k in ("x", "u", "vnew", "znew", "g", "y")),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = trho.osqp_residuals(
        *(_t(a) for a in (A, B, Q, R, Pinf)),
        *(_t(st[k]) for k in ("x", "u", "vnew", "znew", "g", "y")),
        **{k: _t(v) for k, v in kw.items()})
    for g, w, k in zip(got, want, ("pri_res", "dual_res", "pri_norm",
                                   "dual_norm")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("clip", [True, False])
def test_predict_rho_matches_jax(clip):
    rng = np.random.default_rng(1)
    r = [np.abs(rng.normal(size=16)) * 10.0 ** rng.integers(-3, 3, 16)
         for _ in range(4)]
    rho = rng.uniform(0.5, 150.0, 16)
    jset = tm.Settings(adaptive_rho_clip=clip)
    tset = tt.Settings(adaptive_rho_clip=clip)
    want = jrho.predict_rho(*(jnp.asarray(a) for a in r), jnp.asarray(rho),
                            jset)
    got = trho.predict_rho(*(_t(a) for a in r), _t(rho), tset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    assert (got.numpy() > 100.0).any() != clip


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("apply_c", [False, True])
def test_taylor_update_matches_jax(apply_c, batched):
    """M += (new_rho - rho) dM/drho on Kinf, Pinf and the C1/C2 aliases,
    and on Quu_inv/AmBKt only under apply_c (the reference's quirk); on
    one cache, and on a per-problem cache of 3 problems."""
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float64)
    pj = tm.with_sensitivities(pj, systems.crazyflie_sensitivity_tables())
    new_rho = np.array(7.5)
    if batched:
        c = pj.cache
        pj = pj.replace(cache=dataclasses.replace(c, **{
            k: jnp.broadcast_to(getattr(c, k), (3,) + getattr(c, k).shape)
            for k in ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "C1",
                      "C2")}))
        new_rho = np.array([3.0, 5.0, 7.5])
    pt = _port(pj)
    cj = jrho.taylor_update(pj.cache, jnp.asarray(new_rho),
                            tm.Settings(adaptive_rho_apply_c=apply_c))
    ct = trho.taylor_update(pt.cache, _t(new_rho),
                            tt.Settings(adaptive_rho_apply_c=apply_c))
    for k in ("rho", "Kinf", "Pinf", "C1", "C2", "Quu_inv", "AmBKt"):
        np.testing.assert_allclose(getattr(ct, k).numpy(),
                                   np.asarray(getattr(cj, k)), rtol=0,
                                   atol=1e-14, err_msg=k)
    moved = not torch.equal(ct.Quu_inv, pt.cache.Quu_inv) or \
        not torch.equal(ct.AmBKt, pt.cache.AmBKt)
    assert moved == apply_c


def test_adapt_rho_matches_jax():
    """One whole adaptation step -- residuals, prediction, Taylor update --
    on one problem's iterate."""
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float64)
    pj = tm.with_sensitivities(pj, systems.crazyflie_sensitivity_tables())
    pt = _port(pj)
    st = _random_state(np.random.default_rng(2), b=())
    cj = jrho.adapt_rho(pj, pj.cache, types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in st.items()}), tm.Settings())
    ct = trho.adapt_rho(pt, pt.cache, types.SimpleNamespace(
        **{k: _t(v) for k, v in st.items()}), tt.Settings())
    for k in ("rho", "Kinf", "Pinf", "C1", "C2"):
        np.testing.assert_allclose(getattr(ct, k).numpy(),
                                   np.asarray(getattr(cj, k)), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    assert ct.rho.shape == () and float(ct.rho) != 5.0


# ------------------------------------------------------------ admm.solve

def _quad_problem(max_iter=100, tol=1.0, apply_c=False):
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float64)
    pj = tm.with_bounds(pj, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    pj = tm.with_sensitivities(pj, systems.crazyflie_sensitivity_tables())
    return tm.with_settings(pj, max_iter=max_iter, adaptive_rho=True,
                            adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c)


def _rocket_soc_problem():
    """The rocket with its box and cones, at rho 5 (its own rho of 1 sits
    on adaptive_rho_min, where the adaptation, which lowers it, stays);
    with_settings computes its rho sensitivities."""
    s = systems.rocket_landing_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=5.0, N=N,
                  f=s["f"], dtype=jnp.float64)
    pj = tm.with_bounds(
        pj, x_min=np.tile([-5.0, -5.0, -0.5, -10.0, -10.0, -20.0], (N, 1)),
        x_max=np.tile([5.0, 5.0, 100.0, 10.0, 10.0, 20.0], (N, 1)),
        u_min=-10.0, u_max=105.0)
    pj = tm.with_cones(pj, state_cones=[(0, 3, 0.25)],
                       input_cones=[(0, 3, 0.5)])
    return tm.with_settings(pj, max_iter=60, abs_pri_tol=2e-3,
                            adaptive_rho=True)


def _assert_same_adaptive_solve(out_j, out_t):
    """Exact counts and solved flags, 1e-6 on x, u and the residuals,
    final rho to 1e-8, final Kinf / Pinf to 1e-6."""
    (sol_j, st_j, c_j), (sol_t, st_t, c_t) = out_j, out_t
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))
    for a, b, k in ((sol_t.x, sol_j.x, "x"), (sol_t.u, sol_j.u, "u")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in RES:
        np.testing.assert_allclose(getattr(st_t, k).numpy(),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(c_t.rho.numpy(), np.asarray(c_j.rho), rtol=0,
                               atol=1e-8, err_msg="final rho")
    for k in ("Kinf", "Pinf", "C1", "C2", "Quu_inv", "AmBKt"):
        np.testing.assert_allclose(getattr(c_t, k).numpy(),
                                   np.asarray(getattr(c_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)


CASES = {
    # (problem, x0 scale): the guard commits on some lanes at scale 0.4.
    "box": (lambda: _quad_problem(), 0.2),
    "rho_tol_3": (lambda: _quad_problem(tol=3.0), 0.4),
    "apply_c": (lambda: _quad_problem(apply_c=True), 0.2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_solve_matches_jax_float64(case):
    """The telescoped plain solve against tinympc_tpu.solve on a batch of
    6 quadrotors, from the same problem (the Crazyflie tables): rho moves
    on every case, and the batch mixes converged and max-iter lanes."""
    make, scale = CASES[case]
    pj = make()
    pt = _port(pj)
    x0 = np.random.default_rng(0).uniform(-1, 1, (6, 12)) * scale
    Xref = np.tile([0, 0, 0.5] + [0] * 9, (N, 1))
    out_j = tm.solve(pj, tm.init_state(pj, (6,)), jnp.asarray(Xref), None,
                     jnp.asarray(x0))
    out_t = tt.solve(pt, tt.init_state(pt, (6,)), _t(Xref), None, _t(x0))
    _assert_same_adaptive_solve(out_j, out_t)
    rho = out_t[2].rho.numpy()
    assert (rho != 5.0).any()
    it = out_t[0].iter.numpy()
    assert (it < 100).any() and (it == 100).any()


def test_adaptive_solve_with_cones_matches_jax_float64():
    """Adaptive rho with the SOC family and the box on the rocket: the
    cones' linear-cost terms take the per-problem rho."""
    pj = _rocket_soc_problem()
    pt = _port(pj)
    x0 = np.asarray([4, 2, 20, -3, 2, -4.5]) * np.random.default_rng(
        3).uniform(0.9, 1.2, (5, 1))
    Xref = np.linspace([4, 2, 20, -3, 2, -4.5], np.zeros(6), N)
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    out_j = tm.solve(pj, tm.init_state(pj, (5,)), jnp.asarray(Xref),
                     jnp.asarray(Uref), jnp.asarray(x0))
    out_t = tt.solve(pt, tt.init_state(pt, (5,)), _t(Xref), _t(Uref),
                     _t(x0))
    _assert_same_adaptive_solve(out_j, out_t)
    np.testing.assert_allclose(out_t[1].gc.numpy(), np.asarray(out_j[1].gc),
                               rtol=0, atol=1e-6)
    assert (out_t[2].rho.numpy() != 5.0).any()


def test_batched_cache_threads_through_solves():
    """Three warm solves, each entered with the previous solve's final
    (per-problem) cache, as examples/scenarios.py:79-91 threads it; the
    cache crosses to the port through convert on every step."""
    pj = _quad_problem(max_iter=40)
    B = 4
    x0 = np.random.default_rng(5).uniform(-0.3, 0.3, (B, 12))
    Xref = np.tile([0, 0, 0.5] + [0] * 9, (N, 1))
    sj, st_ = tm.init_state(pj, (B,)), None
    pr_j = pj
    for step in range(3):
        pr_t = _port(pr_j)
        if step:
            assert pr_t.cache.rho.shape == (B,)
            assert pr_t.cache.Kinf.shape == (B, 4, 12)
        st_ = tt.init_state(pr_t, (B,)) if st_ is None else st_
        out_j = tm.solve(pr_j, sj, jnp.asarray(Xref), None, jnp.asarray(x0))
        out_t = tt.solve(pr_t, st_, _t(Xref), None, _t(x0))
        _assert_same_adaptive_solve(out_j, out_t)
        sj, st_ = out_j[1], out_t[1]
        pr_j = pr_j.replace(cache=out_j[2])
        A, Bm = np.asarray(pj.A), np.asarray(pj.B)
        x0 = x0 @ A.T + np.asarray(out_j[1].u[0]) @ Bm.T
    assert (out_t[2].rho.numpy() != 5.0).all()


def test_adaptive_solve_refuses_what_the_jax_package_refuses():
    """Adaptive rho with horizon-parallel sweeps or with consensus, and an
    adaptive problem without its sensitivities."""
    pt = _port(_quad_problem())
    with pytest.raises(ValueError, match="horizon_parallel"):
        tt.solve(tt.with_settings(pt, horizon_parallel=True),
                 tt.init_state(pt, (2,)))
    with pytest.raises(ValueError, match="consensus"):
        tt.solve(pt.replace(spec=dataclasses.replace(pt.spec,
                                                     en_consensus=True)),
                 tt.init_state(pt, (2,)))
    bare = pt.replace(cache=dataclasses.replace(
        pt.cache, dKinf_drho=None, dPinf_drho=None, dC1_drho=None,
        dC2_drho=None))
    with pytest.raises(ValueError, match="sensitivities"):
        tt.solve(bare, tt.init_state(pt, (2,)))


# ------------------------------------------------------------- golden

def test_golden_quadrotor_hovering_adaptive_replays_through_the_port():
    """examples/scenarios.py:run_quadrotor_hovering(adaptive=True) through
    the port, all 100 steps, unbatched float64, the Crazyflie tables, the
    final cache of each solve threaded into the next: tests/test_parity.py's
    bar on x0, u0, counts, solved flags and residuals, and final rho
    (1e-8), Kinf (1e-6) and Pinf (1e-5) against the golden."""
    g = load_golden("quadrotor_hovering_adaptive")
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=F64, device="cpu")
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    prob = tt.with_sensitivities(
        prob, tt.systems.crazyflie_sensitivity_tables())
    prob = tt.with_settings(prob, max_iter=100, adaptive_rho=True)
    state = tt.init_state(prob)
    x0 = _t([0, 1, 0, 0.2, 0, 0, 0.1, 0, 0, 0, 0, 0])
    Xref = _t(np.tile([0, 0, 2.0] + [0] * 9, (N, 1)))
    rec = {k: [] for k in ("x0", "u0", "iter", "solved") + RES}
    cache = prob.cache
    for _ in range(len(g["steps"])):
        sol, state, cache = tt.solve(prob.replace(cache=cache), state, Xref,
                                     None, x0)
        u0 = state.u[0]
        rec["x0"].append(x0.numpy().copy())
        rec["u0"].append(u0.numpy().copy())
        rec["iter"].append(int(sol.iter))
        rec["solved"].append(int(sol.solved))
        for k in RES:
            rec[k].append(float(getattr(state, k)))
        x0 = prob.A @ x0 + prob.B @ u0
    n = len(rec["iter"])
    for k in ("x0", "u0") + RES:
        np.testing.assert_allclose(np.asarray(rec[k]),
                                   steps_array(g, k)[:n], atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(rec["iter"], steps_array(g, "iter")[:n])
    np.testing.assert_array_equal(rec["solved"],
                                  steps_array(g, "solved")[:n])
    np.testing.assert_allclose(float(cache.rho), g["final_rho"], atol=1e-8)
    np.testing.assert_allclose(cache.Kinf.numpy(), np.asarray(
        g["final_Kinf"]), atol=1e-6)
    np.testing.assert_allclose(cache.Pinf.numpy(), np.asarray(
        g["final_Pinf"]), atol=1e-5)
