"""The port's constraint families beyond the box -- second-order cones,
hyperplanes and time-varying hyperplanes -- against the JAX package on the
CPU: the projections and the with_* constructors in float64, ``admm.solve`` on every
family in float64 at the parity bar (exact iteration counts, 1e-6), the
reference goldens that use them replayed through the port, ``convert``
round trips, the plain closed loop on a cone problem, and the fused closed
loop's refusal of the families."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import projections as jproj
from tinympc_tpu import systems
from tinympc_tpu.closed_loop import closed_loop as jax_closed_loop

import tinympc_tpu_torch as tt
from tinympc_tpu_torch import projections as tproj
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy,
                                       state_from_numpy, state_to_numpy)
from tinympc_tpu_torch.kernels import (closed_loop_fused,
                                       closed_loop_fused_supported)

from helpers import load_golden, steps_array

torch.set_num_threads(1)

N = 10
RES = ("pri_res_state", "pri_res_input", "dua_res_state", "dua_res_input")
XINIT = np.array([4, 2, 20, -3, 2, -4.5])
ROCKET_XMIN = [-5.0, -5.0, -0.5, -10.0, -10.0, -20.0]
ROCKET_XMAX = [5.0, 5.0, 100.0, 10.0, 10.0, 20.0]
FAMILY_FIELDS = ("vcnew", "gc", "zcnew", "yc", "vlnew", "gl", "zlnew", "yl",
                 "vlnew_tv", "gl_tv", "zlnew_tv", "yl_tv")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ------------------------------------------------------------ projections

@pytest.mark.parametrize("case", ["inside", "below", "outside", "apex",
                                  "mixed_dim4"])
def test_project_soc_matches_jax(case):
    """Every case of admm.cpp:39-60 on (T, b, dim) arrays, float64. At the
    apex a = 0 and the safe_a guard keeps NaN out."""
    rng = np.random.default_rng(0)
    if case == "inside":
        s = rng.normal(size=(3, 4, 3)) * 0.1
        s[..., -1] = 5.0
    elif case == "below":
        s = rng.normal(size=(3, 4, 3)) * 0.1
        s[..., -1] = -5.0
    elif case == "outside":
        s = rng.normal(size=(3, 4, 3)) * 3.0
        s[..., -1] = 0.1
    elif case == "apex":
        s = np.zeros((3, 4, 3))
    else:
        s = rng.normal(size=(5, 6, 4))
    mu = 0.5
    ref = np.asarray(jproj.project_soc(jnp.asarray(s), jnp.asarray(mu)))
    mine = tproj.project_soc(_t(s), _t(mu)).numpy()
    assert np.isfinite(mine).all()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-14)
    if case in ("inside", "apex"):
        np.testing.assert_array_equal(mine, s)


def test_project_hyperplane_if_violated_matches_jax():
    """Violated rows move onto the plane, the others stay; a per-row
    (T, 1, F) plane and b, float64."""
    rng = np.random.default_rng(1)
    z = rng.normal(size=(4, 5, 6))
    a = rng.normal(size=(4, 1, 6))
    b = rng.normal(size=(4, 1)) * 0.5
    ref = np.asarray(jproj.project_hyperplane_if_violated(
        jnp.asarray(z), jnp.asarray(a), jnp.asarray(b)))
    mine = tproj.project_hyperplane_if_violated(_t(z), _t(a), _t(b)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-14)
    val = (z * a).sum(-1)
    assert (val > b).any() and (val <= b).any()
    np.testing.assert_array_equal(mine[val <= b], z[val <= b])


# ------------------------------------------------------ with_* constructors

def _setup_both(name, N_=N):
    s = getattr(systems, name)()
    f = s["f"] if name == "rocket_landing_20hz" else None
    ref = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                   N=N_, f=f, dtype=jnp.float64)
    mine = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N_, f=f, dtype=torch.float64, device="cpu")
    return ref, mine


def _assert_same_problem(pj, pt):
    assert dataclasses.asdict(pt.spec) == dataclasses.asdict(pj.spec)
    for f in dataclasses.fields(pj.cons):
        a, b = getattr(pj.cons, f.name), getattr(pt.cons, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)


@pytest.mark.parametrize("enable", [True, False])
def test_with_cones_matches_jax(enable):
    """enable=False configures the cones but leaves them off (the
    reference's rocket example, examples/scenarios.py:181-190)."""
    pj, pt = _setup_both("rocket_landing_20hz")
    kw = dict(state_cones=[(0, 3, 0.25)], input_cones=[(0, 3, 0.5)],
              enable=enable)
    pj, pt = tm.with_cones(pj, **kw), tt.with_cones(pt, **kw)
    _assert_same_problem(pj, pt)
    assert pt.spec.any_extra_family == enable
    assert pt.spec.enabled_state_cones == (((0, 3),) if enable else ())
    st = tt.init_state(pt, (2,))
    assert (st.gc is None) == (not enable) and st.yl is None


def test_with_linear_constraints_matches_jax():
    pj, pt = _setup_both("quadrotor_50hz")
    Ax = np.zeros((1, 12))
    Ax[0, 2] = 1.0
    Au = np.ones((2, 4))
    pj = tm.with_linear_constraints(pj, Ax, [3.0], Au, [6.0, 5.0])
    pt = tt.with_linear_constraints(pt, Ax, [3.0], Au, [6.0, 5.0])
    _assert_same_problem(pj, pt)
    assert (pt.spec.n_state_lin, pt.spec.n_input_lin) == (1, 2)
    # A family left out is switched off.
    pj = tm.with_linear_constraints(pj, Alin_u=Au, blin_u=[6.0, 5.0])
    pt = tt.with_linear_constraints(pt, Alin_u=Au, blin_u=[6.0, 5.0])
    _assert_same_problem(pj, pt)
    assert not pt.spec.en_state_linear


def test_with_tv_linear_constraints_and_tv_from_stacked_match_jax():
    pj, pt = _setup_both("quadrotor_50hz")
    rng = np.random.default_rng(2)
    S = 2
    A_st, b_st = rng.normal(size=(S * N, 12)), rng.normal(size=(S, N))
    Aj, bj = tm.tv_from_stacked(A_st, b_st)
    At, bt = tt.tv_from_stacked(A_st, b_st)
    np.testing.assert_array_equal(At, np.asarray(Aj))
    np.testing.assert_array_equal(bt, np.asarray(bj))
    assert At.shape == (N, S, 12) and bt.shape == (N, S)
    Au = np.ones((N - 1, 1, 4))
    bu = np.full((N - 1, 1), 6.0)
    pj = tm.with_tv_linear_constraints(pj, Aj, bj, Au, bu)
    pt = tt.with_tv_linear_constraints(pt, At, bt, Au, bu)
    _assert_same_problem(pj, pt)
    assert (pt.spec.n_tv_state_lin, pt.spec.n_tv_input_lin) == (S, 1)


# ---------------------------------------------------------- admm.solve

def _family_problems(case, max_iter=60):
    """(JAX problem, port problem, x0s (B, nx), Xref, Uref) in float64.
    soc_box is the rocket with its cones and box; soc alone drops the box;
    linear and tv are the two quadrotor demos' hyperplanes, box off, with
    the z ceilings lowered so that the state planes bite too."""
    if case in ("soc_box", "soc"):
        pj, pt = _setup_both("rocket_landing_20hz")
        out = []
        for m, p in ((tm, pj), (tt, pt)):
            if case == "soc_box":
                p = m.with_bounds(p, x_min=np.tile(ROCKET_XMIN, (N, 1)),
                                  x_max=np.tile(ROCKET_XMAX, (N, 1)),
                                  u_min=-10.0, u_max=105.0)
            else:
                p = p.replace(spec=dataclasses.replace(
                    p.spec, en_state_bound=False, en_input_bound=False))
            p = m.with_cones(p, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
            out.append(m.with_settings(p, max_iter=max_iter,
                                       abs_pri_tol=2e-3))
        rng = np.random.default_rng(3)
        x0 = XINIT * (1 + 0.1 * rng.uniform(-1, 1, (6, 6)))
        Xref = XINIT * (1 - np.arange(N)[:, None] / 99.0)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
        return (*out, x0, Xref, Uref)
    pj, pt = _setup_both("quadrotor_50hz")
    out = []
    for m, p in ((tm, pj), (tt, pt)):
        if case == "linear":
            Ax = np.zeros((1, 12))
            Ax[0, 2] = 1.0
            p = m.with_linear_constraints(p, Ax, [1.1], np.ones((1, 4)),
                                          [6.0])
        else:
            Ax = np.zeros((N, 1, 12))
            Ax[:, 0, 2] = 1.0
            p = m.with_tv_linear_constraints(
                p, Ax, (1.02 + 0.01 * np.arange(N)).reshape(N, 1),
                np.ones((N - 1, 1, 4)), np.full((N - 1, 1), 6.0))
        p = m.with_settings(p, max_iter=max_iter)
        out.append(p.replace(spec=dataclasses.replace(
            p.spec, en_state_bound=False, en_input_bound=False)))
    rng = np.random.default_rng(4)
    start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
    x0 = start + 0.1 * rng.uniform(-1, 1, (6, 12))
    alpha = np.arange(N)[:, None] / 49.0       # the demo's step-0 window
    Xref = (1 - alpha) * start + alpha * np.asarray([2.0, 2.0, 4.0]
                                                    + [0.0] * 9)
    return (*out, x0, Xref, None)


def _assert_same_solve(out_j, out_t, atol=1e-6):
    (sol_j, st_j, _), (sol_t, st_t, _) = out_j, out_t
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=atol)
    for k in RES:
        np.testing.assert_allclose(getattr(st_t, k).numpy(),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=atol, err_msg=k)
    for k in FAMILY_FIELDS:
        a, b = getattr(st_j, k), getattr(st_t, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("batched", [True, False], ids=["batched",
                                                        "unbatched"])
@pytest.mark.parametrize("case", ["soc_box", "soc", "linear", "tv"])
def test_admm_solve_matches_jax_float64(case, batched):
    """Each family alone, and SOC with the box, through both solves in
    float64 on the same problem: exact iteration counts and solved flags,
    1e-6 on x, u, the residuals and every family slack and dual."""
    pj, pt, x0, Xref, Uref = _family_problems(case)
    if not batched:
        x0 = x0[0]
    b = x0.shape[:-1]
    Xr, Ur = (None if a is None else a for a in (Xref, Uref))
    out_j = tm.solve(pj, tm.init_state(pj, b),
                     None if Xr is None else jnp.asarray(Xr),
                     None if Ur is None else jnp.asarray(Ur), jnp.asarray(x0))
    out_t = tt.solve(pt, tt.init_state(pt, b),
                     None if Xr is None else _t(Xr),
                     None if Ur is None else _t(Ur), _t(x0))
    _assert_same_solve(out_j, out_t)
    it = out_t[0].iter.numpy()
    assert (it > 1).all()


# ------------------------------------------------------------ goldens

def _check_golden(rec, name, x_atol=1e-6, u_atol=1e-6, iter_slack=0,
                  res_atol=1e-6):
    """tests/test_parity.py:_check on the first n steps."""
    g = load_golden(name)
    n = len(rec["iter"])
    np.testing.assert_allclose(rec["x0"], steps_array(g, "x0")[:n],
                               atol=x_atol, err_msg=f"{name}: x0")
    np.testing.assert_allclose(rec["u0"], steps_array(g, "u0")[:n],
                               atol=u_atol, err_msg=f"{name}: u0")
    it = np.asarray(rec["iter"])
    assert np.all(np.abs(it - steps_array(g, "iter")[:n]) <= iter_slack)
    np.testing.assert_array_equal(rec["solved"],
                                  steps_array(g, "solved")[:n])
    for k in RES:
        np.testing.assert_allclose(rec[k], steps_array(g, k)[:n],
                                   atol=res_atol, err_msg=f"{name}: {k}")


def _record(rec, x0, u0, sol, state):
    rec["x0"].append(x0.numpy().copy())
    rec["u0"].append(u0.numpy().copy())
    rec["iter"].append(int(sol.iter))
    rec["solved"].append(int(sol.solved))
    for k in RES:
        rec[k].append(float(getattr(state, k)))


def _new_record():
    return {k: [] for k in ("x0", "u0", "iter", "solved") + RES}


def _run_rocket(steps, enable_soc):
    """examples/scenarios.py:run_rocket_landing through the port: the
    cones are configured in both goldens and on only in rocket_soc."""
    s = tt.systems.rocket_landing_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, f=s["f"], dtype=torch.float64, device="cpu")
    prob = tt.with_bounds(prob, x_min=np.tile(ROCKET_XMIN, (N, 1)),
                          x_max=np.tile(ROCKET_XMAX, (N, 1)), u_min=-10.0,
                          u_max=105.0)
    prob = tt.with_cones(prob, state_cones=[(0, 3, 0.25)],
                         input_cones=[(0, 3, 0.5)], enable=enable_soc)
    prob = tt.with_settings(prob, max_iter=100, abs_pri_tol=2e-3)
    state = tt.init_state(prob)
    x0 = _t(XINIT * 1.1)
    Uref = torch.zeros((N - 1, 3), dtype=torch.float64)
    Uref[:, 2] = 10.0
    rec = _new_record()
    for k in range(steps):
        frac = (torch.arange(N, dtype=torch.float64) + k) / 99.0
        Xref = _t(XINIT) * (1 - frac[:, None])
        sol, state, _ = tt.solve(prob, state, Xref, Uref, x0)
        u0 = state.u[0]
        _record(rec, x0, u0, sol, state)
        x0 = prob.A @ x0 + prob.B @ u0 + prob.f
    return rec


def _run_quadrotor_linear(steps, tv):
    """examples/scenarios.py:_quadrotor_linear_common through the port:
    box off, the tv bound rebuilt from z_lim_total's window every step, and
    an unsolved step moving x0 2% toward the goal instead of the model."""
    s = tt.systems.quadrotor_50hz()
    NTOTAL = 50
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=torch.float64, device="cpu")
    z_lim_total = 1.1 + (3.0 - 1.1) * np.arange(NTOTAL) / (NTOTAL - N - 1)
    tv_Ax = np.zeros((N, 1, 12))
    tv_Ax[:, 0, 2] = 1.0
    tv_Au, tv_bu = np.ones((N - 1, 1, 4)), np.full((N - 1, 1), 6.0)
    if tv:
        prob = tt.with_tv_linear_constraints(prob, tv_Ax, np.full((N, 1),
                                                                  3.0),
                                             tv_Au, tv_bu)
    else:
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        prob = tt.with_linear_constraints(prob, Ax, [3.0], np.ones((1, 4)),
                                          [6.0])
    prob = tt.with_settings(prob, max_iter=100, abs_pri_tol=1e-3,
                            abs_dua_tol=1e-3)
    prob = prob.replace(spec=dataclasses.replace(
        prob.spec, en_state_bound=False, en_input_bound=False))
    state = tt.init_state(prob)
    x0 = _t([-2.0, -2.0, 1.0] + [0.0] * 9)
    xgoal = _t([2.0, 2.0, 4.0] + [0.0] * 9)
    rec = _new_record()
    for k in range(steps):
        alpha = _t((k + np.arange(N)) / (NTOTAL - 1))
        Xref = (1 - alpha[:, None]) * x0 + alpha[:, None] * xgoal
        if tv:
            prob = tt.with_tv_linear_constraints(
                prob, tv_Ax, z_lim_total[k:k + N].reshape(N, 1), tv_Au,
                tv_bu)
        sol, state, _ = tt.solve(prob, state, Xref, None, x0)
        u0 = state.u[0]
        _record(rec, x0, u0, sol, state)
        if bool(sol.solved):
            x0 = prob.A @ x0 + prob.B @ u0 + prob.f
        else:
            x0 = 0.98 * x0 + 0.02 * xgoal
    return rec


# Steps of each golden replayed: past the first unsolved (max_iter) steps,
# and for the tv demo past its first solved step after them
# (quadrotor_linear turns unsolved at step 16, rocket_soc at 13, the tv
# demo at 7 and solves again at 16).
GOLDEN_PREFIX = {"rocket": 20, "rocket_soc": 16, "quadrotor_linear": 18,
                 "quadrotor_tv_linear": 17}


@pytest.mark.parametrize("name", ["rocket", "rocket_soc", "quadrotor_linear",
                                  "quadrotor_tv_linear"])
def test_golden_prefix_replays_through_the_port(name):
    """The reference demos that use the families, replayed through the
    port's admm.solve as examples/scenarios.py replays them, unbatched
    float64, over the first GOLDEN_PREFIX steps, at tests/test_parity.py's
    bars (rocket_soc at its own: 5e-4, counts within 1, residuals 1e-5)."""
    steps = GOLDEN_PREFIX[name]
    if name.startswith("rocket"):
        soc = name == "rocket_soc"
        rec = _run_rocket(steps, enable_soc=soc)
        if soc:
            _check_golden(rec, name, x_atol=5e-4, u_atol=5e-4, iter_slack=1,
                          res_atol=1e-5)
            assert 0 in rec["solved"]
            return
    else:
        rec = _run_quadrotor_linear(steps, tv=name == "quadrotor_tv_linear")
        assert 0 in rec["solved"]
        if name == "quadrotor_tv_linear":
            assert rec["solved"][-1] == 1
    _check_golden(rec, name)


# ------------------------------------------------------------ convert

def test_convert_round_trips_a_families_problem_and_its_state():
    """A JAX problem with cones, hyperplanes and tv hyperplanes read into
    the port solves the same (float64: exact counts, 1e-6), and its solver
    state, family fields included, continues the solve the same."""
    pj, _ = _setup_both("quadrotor_50hz")
    Ax = np.zeros((1, 12))
    Ax[0, 2] = 1.0
    Atv = np.zeros((N, 1, 12))
    Atv[:, 0, 1] = 1.0
    pj = tm.with_cones(pj, input_cones=[(0, 4, 2.0)])
    pj = tm.with_linear_constraints(pj, Ax, [3.0])
    pj = tm.with_tv_linear_constraints(pj, Atv, np.full((N, 1), 0.5))
    pj = tm.with_settings(pj, max_iter=30)
    d = problem_to_numpy(pj)
    pt = problem_from_numpy(d, "cpu", torch.float64)
    _assert_same_problem(pj, pt)
    assert problem_to_numpy(pt).keys() == d.keys()
    for k in ("Alin_u", "tv_Alin_u", "cx"):
        assert k not in d
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.5, 0.5, (4, 12))
    out_j = tm.solve(pj, tm.init_state(pj, (4,)), x0=jnp.asarray(x0))
    out_t = tt.solve(pt, tt.init_state(pt, (4,)), x0=_t(x0))
    _assert_same_solve(out_j, out_t)

    ds = state_to_numpy(out_j[1])
    assert {"zcnew", "yc", "vlnew", "gl", "vlnew_tv", "gl_tv"} <= ds.keys()
    assert "vcnew" not in ds and "zlnew" not in ds
    st = state_from_numpy(ds, "cpu", torch.float64)
    assert state_to_numpy(st).keys() == ds.keys()
    x1 = x0 * 0.9
    _assert_same_solve(tm.solve(pj, out_j[1], x0=jnp.asarray(x1)),
                       tt.solve(pt, st, x0=_t(x1)))


def test_convert_round_trips_a_families_carry():
    """A JAX families carry (duals and x/u) through numpy into the port and
    back is the identity; a box-only carry dict keeps the box fields
    alone."""
    from tinympc_tpu.kernels import FusedCarry as JaxCarry
    from tinympc_tpu.kernels import init_carry as jax_init_carry
    pj, pt, *_ = _family_problems("soc_box")
    rng = np.random.default_rng(6)
    cj = jax_init_carry(pj, 3)
    cj = JaxCarry(**{k: None if getattr(cj, k) is None else jnp.asarray(
        rng.normal(size=getattr(cj, k).shape), jnp.float32)
        for k in ("vnew", "znew", "g", "y", "v", "z", "gc", "yc", "gl", "yl",
                  "gtv", "ytv", "zc0", "yc0", "x", "u", "rho")})
    d = carry_to_numpy(cj)
    assert set(d) == {"vnew", "znew", "g", "y", "v", "z", "gc", "yc", "x",
                      "u"}
    ct_ = carry_from_numpy(d, "cpu")
    assert ct_.gl is None and ct_.gtv is None
    for k, v in carry_to_numpy(ct_).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(cj, k)))
    box = carry_to_numpy(tt.init_carry(tt.with_cones(pt), 3))
    assert set(box) == {"vnew", "znew", "g", "y", "v", "z"}


# ------------------------------------------------------------ closed loops

def test_plain_closed_loop_runs_a_cone_problem_like_jax():
    """The plain closed_loop runs family problems through admm.solve, as
    the JAX one does; shift_warm shifts the family fields too. float64:
    exact counts, 1e-6."""
    pj, pt, x0, Xref, Uref = _family_problems("soc_box", max_iter=40)
    x0 = x0[:3]
    out_j = jax_closed_loop(pj, tm.init_state(pj, (3,)), jnp.asarray(x0),
                            jnp.asarray(Xref), 6, Uref=jnp.asarray(Uref),
                            shift_warm=True)
    out_t = tt.closed_loop(pt, tt.init_state(pt, (3,)), _t(x0), _t(Xref), 6,
                           Uref=_t(Uref), shift_warm=True)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    for a, b in zip(out_t[:2], out_j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(out_t[4].gc.numpy(), np.asarray(out_j[4].gc),
                               rtol=0, atol=1e-6)


def test_shift_state_shifts_the_family_fields():
    _, pt, *_ = _family_problems("soc_box")
    st = tt.init_state(pt, (2,))
    marked = st.replace(gc=torch.arange(N * 2 * 6, dtype=torch.float64)
                        .reshape(N, 2, 6))
    sh = tt.shift_state(marked)
    assert torch.equal(sh.gc[:-1], marked.gc[1:])
    assert torch.equal(sh.gc[-1], marked.gc[-1])
    assert sh.gl is None and sh.vlnew_tv is None


@pytest.mark.parametrize("case", ["soc", "linear", "tv"])
def test_closed_loop_fused_refuses_the_families(case):
    """The fused closed loop is box-only, like the JAX one
    (closed_loop_pallas.py:326): a problem with cones or hyperplanes is not
    supported and raises ValueError."""
    if case == "soc":
        s = tt.systems.quadrotor_20hz()
        pt = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                      N=N, dtype=torch.float32, device="cpu")
        pt = tt.with_cones(tt.with_bounds(pt, u_min=-0.5, u_max=0.5),
                           input_cones=[(0, 4, 1.0)])
    else:
        pt = _family_problems(case)[1]
        pt = problem_from_numpy(problem_to_numpy(pt), "cpu")
    assert not closed_loop_fused_supported(pt)
    with pytest.raises(ValueError, match="box"):
        closed_loop_fused(pt, np.zeros((N, 12), np.float32),
                          torch.zeros((2, 12)), 3)
