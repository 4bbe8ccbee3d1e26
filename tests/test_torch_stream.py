"""The streamed long-horizon solve's plain PyTorch versions (what
``solve_fused_streamed`` and ``solve_fused_streamed_warm`` run on CPU
tensors, and what csrc/admm_stream.cu is held against on the card): against
the JAX package's streamed Pallas kernels in interpret mode, as
tests/test_stream_kernel.py runs them, and against the port's own resident
plain version, which the streamed solve must equal bitwise.

The CUDA kernels cannot run here; chip_smoke.py holds them against these
plain versions and against the resident kernel on the GPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused_streamed as jax_streamed
from tinympc_tpu.kernels import solve_fused_streamed_warm as jax_streamed_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (init_carry, solve_fused_reference,
                                       solve_fused_streamed,
                                       solve_fused_streamed_reference,
                                       solve_fused_streamed_warm,
                                       solve_fused_warm_reference)
from tinympc_tpu_torch.kernels import admm_stream

torch.set_num_threads(1)

XINIT = np.array([4, 2, 20, -3, 2, -4.5])


def _jax_problem(case, N, max_iter, dtype=jnp.float32):
    """Problems of tests/test_stream_kernel.py: the quadrotor with box
    bounds ("box"); the rocket with its cones and box ("soc"); on top of the
    quadrotor's box, the static hyperplanes ("linear": a z ceiling and a
    thrust-sum plane), the time-varying z ceiling ("tv"), or both, the
    corridor of :165-194 ("corridor")."""
    if case == "soc":
        s = systems.rocket_landing_20hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                        N=N, f=s["f"], dtype=dtype)
        prob = tm.with_bounds(
            prob, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        prob = tm.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
        return tm.with_settings(prob, max_iter=max_iter, abs_pri_tol=2e-3)
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    a = np.zeros(12)
    a[2] = 1.0
    if case in ("linear", "corridor"):
        prob = tm.with_linear_constraints(prob, Alin_x=a[None], blin_x=[0.4],
                                          Alin_u=np.ones((1, 4)),
                                          blin_u=[1.2])
    if case in ("tv", "corridor"):
        prob = tm.with_tv_linear_constraints(
            prob, tv_Alin_x=np.tile(a, (N, 1, 1)),
            tv_blin_x=np.linspace(0.6, 0.3, N)[:, None])
    return tm.with_settings(prob, max_iter=max_iter)


def _inputs(case, N, B, seed):
    """x0s (B, nx), Xref, Uref as float32 numpy."""
    rng = np.random.default_rng(seed)
    if case == "soc":
        x0 = XINIT * rng.uniform(0.9, 1.1, (B, 1))
        Xref = np.linspace(XINIT, np.zeros(6), N)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
    else:
        # The box quadrotor near a hover at z 0.5, where lanes converge at
        # different iterations; the hyperplanes as tests/test_stream_kernel.py
        # :183-186 sets them.
        spread, z = (0.2, 0.5) if case == "box" else (0.3, 1.0)
        x0 = rng.uniform(-spread, spread, (B, 12))
        Xref = np.tile([0, 0, z] + [0.0] * 9, (N, 1))
        Uref = None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(x0), f32(Xref), f32(Uref)


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _assert_close_to_jax(sol_t, res_t, sol_j, res_j, atol):
    """tests/test_stream_kernel.py's bar: x, u and the residuals to
    ``atol``, counts within 1, equal solved flags where counts agree."""
    it_t, it_j = sol_t.iter.numpy(), np.asarray(sol_j.iter)
    assert np.all(np.abs(it_t - it_j) <= 1), (it_t, it_j)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                               atol=atol)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=atol)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=atol)
    same = it_t == it_j
    np.testing.assert_array_equal(sol_t.solved.numpy()[same],
                                  np.asarray(sol_j.solved)[same])


# N, max_iter, bar of tests/test_stream_kernel.py (box 1e-4, SOC 2e-4,
# hyperplanes 2e-3; each hyperplane family alone matches at 1e-4, as the
# comment at :187-193 says).
COLD = {"box": (24, 100, 1e-4), "soc": (16, 20, 2e-4),
        "linear": (16, 20, 1e-4), "tv": (16, 20, 1e-4)}


@pytest.mark.parametrize("case", ["box", "soc", "linear", "tv"])
def test_plain_cold_matches_jax_streamed_kernel(case):
    """The same float32 problem through the port's plain streamed solve and
    the JAX streamed kernels in interpret mode, B=8: the box quadrotor
    (lanes converge mid-batch), the rocket's cones, the static hyperplanes
    and the time-varying ones."""
    N, max_iter, atol = COLD[case]
    pj = _jax_problem(case, N, max_iter)
    x0, Xref, Uref = _inputs(case, N, 8, 3 if case in ("box", "soc") else 6)
    sol_j, res_j = jax_streamed(pj, _j(Xref), _j(Uref), jnp.asarray(x0),
                                tile=8, chunk=8, interpret=True)
    sol_t, res_t = solve_fused_streamed(_port(pj), _t(Xref), _t(Uref),
                                        torch.as_tensor(x0))
    _assert_close_to_jax(sol_t, res_t, sol_j, res_j, atol)
    if case == "box":
        assert 0 < sol_t.solved.sum() < 8    # freeze and run-on both show


def test_plain_corridor_is_as_close_to_float64_as_the_jax_kernel():
    """The corridor of tests/test_stream_kernel.py:165-194 (a z ceiling, a
    tightening tv ceiling and a thrust-sum plane on top of the box), on its
    inputs. Three families act on one coordinate and the violated-only
    projections flip on marginally active rows: the problem amplifies
    rounding, so after 20 iterations every float32 solve lies ~1e-2 from
    the float64 one (and ~2 after 200), and two float32 solvers ~4e-3 apart
    (ROADMAP.md Queue 3). Witness that the port's difference is rounding:
    its float32 solve is no further from the JAX package's float64 solve
    than the JAX streamed kernel's is, less 1e-5, with equal counts."""
    N, B = 16, 8
    x0, Xref, _ = _inputs("corridor", N, B, 6)
    pj = _jax_problem("corridor", N, 20)
    p64 = _jax_problem("corridor", N, 20, jnp.float64)
    sol64, _, _ = tm.solve(p64, tm.init_state(p64, (B,)), Xref=jnp.asarray(
        Xref, jnp.float64), x0=jnp.asarray(x0, jnp.float64))
    sol_j, _ = jax_streamed(pj, _j(Xref), None, jnp.asarray(x0), tile=B,
                            chunk=8, interpret=True)
    sol_t, _ = solve_fused_streamed(_port(pj), _t(Xref), None,
                                    torch.as_tensor(x0))
    x64 = np.asarray(sol64.x)
    d_t = np.abs(sol_t.x.numpy() - x64).max()
    d_j = np.abs(np.asarray(sol_j.x) - x64).max()
    assert d_t <= d_j + 1e-5, (d_t, d_j)
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))


def test_plain_warm_family_sequence_matches_jax():
    """A 3-step external-plant sequence of warm rocket SOC solves, stale
    iteration 0 and all: solutions and the carry (box and family duals,
    the carried x/u) against the JAX streamed warm kernel at 2e-4, counts
    within 1."""
    N, B = 16, 8
    pj = _jax_problem("soc", N, 30)
    pt = _port(pj)
    x0, Xref, Uref = _inputs("soc", N, B, 4)
    c_j, c_t = jax_init_carry(pj, B), init_carry(pt, B)
    x = x0
    for step in range(3):
        sol_j, res_j, c_j = jax_streamed_warm(
            pj, _j(Xref), _j(Uref), jnp.asarray(x), c_j, tile=B, chunk=8,
            interpret=True)
        sol_t, res_t, c_t = solve_fused_streamed_warm(
            pt, _t(Xref), _t(Uref), torch.as_tensor(x), c_t)
        _assert_close_to_jax(sol_t, res_t, sol_j, res_j, 2e-4)
        for f in dataclasses.fields(c_t):
            a = getattr(c_t, f.name)
            if a is not None:
                np.testing.assert_allclose(a.numpy(),
                                           np.asarray(getattr(c_j, f.name)),
                                           atol=2e-4, err_msg=f.name)
        x = (x @ np.asarray(pj.A).T + sol_t.u[0].numpy() @ np.asarray(pj.B).T
             + np.asarray(pj.f)).astype(np.float32)


# Port-only problems (cheap): each family on its own, with lanes that
# converge at different iterations.
def _port_problem(case, N, max_iter, ct=1):
    if case in ("box", "soc"):
        p = _port(_jax_problem(case, N, max_iter))
    else:
        s = tt.systems.quadrotor_50hz()
        p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                     N=N, dtype=torch.float32, device="cpu")
        # z ceilings of chip_smoke.py's LOW_CEILING: they bind on part of
        # the lanes while most converge.
        if case == "linear":
            Ax = np.zeros((1, 12))
            Ax[0, 2] = 1.0
            p = tt.with_linear_constraints(p, Ax, [1.24], np.ones((1, 4)),
                                           [6.0])
        else:
            Ax = np.zeros((N, 1, 12))
            Ax[:, 0, 2] = 1.0
            p = tt.with_tv_linear_constraints(
                p, Ax, (1.07 + 0.02 * np.arange(N)).reshape(N, 1),
                np.ones((N - 1, 1, 4)), np.full((N - 1, 1), 6.0))
        # chip_smoke.py's tolerances for the hyperplane demos
        p = tt.with_settings(tt.with_bounds(p, enable=False),
                             abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct)


def _port_inputs(case, N, B, seed=5):
    if case in ("box", "soc"):
        return tuple(_t(a) for a in _inputs(case, N, B, seed))
    rng = np.random.default_rng(seed)
    start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
    x0 = start + 0.1 * rng.uniform(-1, 1, (B, 12))
    Xref = (1 - np.arange(N)[:, None] / 49.0) * start + \
        np.arange(N)[:, None] / 49.0 * np.asarray([2.0, 2.0, 4.0] + [0.0] * 9)
    return (torch.as_tensor(x0, dtype=torch.float32),
            torch.as_tensor(Xref, dtype=torch.float32), None)


def _assert_same(a, b):
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _assert_same_carry(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("case,ct", [("box", 5), ("soc", 1), ("linear", 1),
                                     ("tv", 3)])
def test_plain_cold_equals_resident_plain_bitwise(case, ct):
    """The streamed and the resident plain versions run the same
    arithmetic: bitwise equal solutions, counts, flags and residuals."""
    N = 12
    p = _port_problem(case, N, 150, ct)
    x0, Xref, Uref = _port_inputs(case, N, 16)
    sol_s, res_s = solve_fused_streamed_reference(p, Xref, Uref, x0)
    sol_r, res_r = solve_fused_reference(p, Xref, Uref, x0)
    _assert_same(sol_s, sol_r)
    assert torch.equal(res_s, res_r)
    assert sol_s.solved.any()


@pytest.mark.parametrize("max_iter", [1, 2])
@pytest.mark.parametrize("case", ["box", "tv"])
def test_one_and_two_launch_pairs_equal_resident(case, max_iter):
    """max_iter 1 isolates one backward and one forward launch; 2 adds the
    second pair, which reads the first pair's half of vnew/znew."""
    p = _port_problem(case, 12, max_iter)
    x0, Xref, Uref = _port_inputs(case, 12, 5)
    sol_s, res_s = solve_fused_streamed(p, Xref, Uref, x0)
    sol_r, res_r = solve_fused_reference(p, Xref, Uref, x0)
    _assert_same(sol_s, sol_r)
    assert torch.equal(res_s, res_r)
    assert (sol_s.iter == max_iter).all()


@pytest.mark.parametrize("case", ["box", "soc"])
def test_warm_carry_passes_between_resident_and_streamed(case):
    """A carry from solve_fused_warm serves solve_fused_streamed_warm and
    back: alternating the two over 4 steps gives bitwise the sequence of
    resident solves alone."""
    N, B = 12, 8
    p = _port_problem(case, N, 60, 1)
    x0, Xref, Uref = _port_inputs(case, N, B, 7)
    c_mix, c_res = init_carry(p, B), init_carry(p, B)
    x = x0
    for step in range(4):
        warm = (solve_fused_streamed_warm if step % 2 else
                solve_fused_warm_reference)
        sol_m, res_m, c_mix = warm(p, Xref, Uref, x, c_mix)
        sol_r, res_r, c_res = solve_fused_warm_reference(p, Xref, Uref, x,
                                                         c_res)
        _assert_same(sol_m, sol_r)
        assert torch.equal(res_m, res_r)
        _assert_same_carry(c_mix, c_res)
        x = x @ p.A.T + sol_r.u[0] @ p.B.T + p.f


def test_launch_plain_versions_leave_done_lanes_alone():
    """One backward and one forward plain launch: lanes already done keep
    their d, slacks, duals, counts and residuals; the running lanes take
    the new iterate, and ``active`` reports whether one still runs after
    the check."""
    p = _port_problem("soc", 10, 5)
    x0, Xref, Uref = _port_inputs("soc", 10, 6)
    tables, x0c, _, params = admm_stream._prepare(p, Xref, Uref, x0)
    spec = p.spec
    N, nx, nu = spec.N, spec.nx, spec.nu
    s = admm_stream._init(x0c, N, nx, nu, None, params["fam"])
    done = torch.tensor([True, False, True, False, False, False])
    s["d"] = torch.full_like(s["d"], 7.0)
    s["iters"] = torch.full_like(s["iters"], 3)
    dims = dict(N=N, nx=nx, nu=nu, rho=params["rho"], fam=params["fam"])
    d = admm_stream.stream_backward_reference(
        tables, s["vnew"][1], s["znew"][1], s["g"], s["y"], s["d"], done,
        s["fams"], **dims)
    assert (d[..., done] == 7.0).all() and not (d[..., ~done] == 7.0).all()
    out = admm_stream.stream_forward_reference(
        tables, x0c, s["vnew"][1], s["znew"][1], s["vnew"][0], s["znew"][0],
        s["g"], s["y"], d, s["iters"], done, s["res"], s["fams"], it=3,
        ct=1, tol_pri=params["tol_pri"], tol_dua=params["tol_dua"], **dims)
    assert out["iters"].tolist() == [3, 4, 3, 4, 4, 4]
    for k in ("vcur", "zcur", "g", "y"):
        assert (out[k][..., done] == 0).all(), k
    for new, old in zip(out["fams"], s["fams"]):
        if new is not None:
            assert torch.equal(new[..., done], old[..., done])
    assert (out["res"][:, done] == 0).all() and (out["res"][:, ~done] != 0).any()
    assert out["active"].item() == int(bool((~out["done"]).any()))
    assert torch.equal(out["done"] & done, done)
