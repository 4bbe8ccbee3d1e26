"""Adaptive rho with the constraint families beyond the box, and at the
rocket's (nx, nu) = (6, 3): the fused plain PyTorch version (what
``solve_fused`` and ``solve_fused_warm`` run on CPU tensors, and what the
families adaptive instantiation of csrc/admm_fused.cu is held against on
the card) against the JAX package's fused Pallas kernel in interpret mode at
tests/test_fused_adaptive.py's tolerances, and in float64 against the port's
own ``admm.solve``; the launch glue of the box-only rocket, which runs a
families instantiation with zero family counts; and
``compute_sensitivities`` on the host.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the GPU."""
import contextlib
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import riccati as jriccati
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy)
from tinympc_tpu_torch.kernels import (fused_supported, init_carry,
                                       solve_fused_reference,
                                       solve_fused_warm_reference,
                                       stream_supported)
from tinympc_tpu_torch.kernels import admm_fused

torch.set_num_threads(1)

N = 10
B = 8
MAX_ITER = 20              # adaptations at iterations 5, 10 and 15
XINIT = np.array([4, 2, 20, -3, 2, -4.5])
# The z ceilings of tests/test_torch_families_fused.py, low enough that the
# state hyperplanes bite.
ZMAX = 1.1
TV_ZMAX = 1.02 + 0.01 * np.arange(N)
# case: (system, families, rho0, adaptive_rho_tolerance, apply_c). The
# guard starts from a rho far above adaptive_rho_max, so that its first
# prediction, clipped to 100, commits.
CASES = {"soc": ("rocket", "soc", None, 1.0, False),
         "soc_apply_c": ("rocket", "soc", None, 1.0, True),
         "box63": ("rocket", "box", None, 1.0, False),
         "linear": ("quad", "linear", None, 1.0, False),
         "tv_guard": ("quad", "tv", 1000.0, 3.0, False)}


@functools.lru_cache(maxsize=None)
def _jax_problem(case, max_iter=MAX_ITER, dtype=jnp.float32):
    """The float32 configurations of tests/test_torch_families_fused.py
    (the rocket with its cones and box, or with the box alone; the
    quadrotor demos' static or time-varying hyperplanes with the box off)
    with adaptive rho, the sensitivities from the JAX package's
    with_settings."""
    system, fam, rho, tol, apply_c = CASES[case]
    if system == "rocket":
        s = systems.rocket_landing_20hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"],
                        rho=rho or s["rho"], N=N, f=s["f"], dtype=dtype)
        prob = tm.with_bounds(
            prob, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        if fam == "soc":
            prob = tm.with_cones(prob, state_cones=[(0, 3, 0.25)],
                                 input_cones=[(0, 3, 0.5)])
        # The rocket's rho of 1 is adaptive_rho_min's default, and its
        # predictions fall below it: a lower floor lets rho move.
        extra = dict(abs_pri_tol=2e-3, adaptive_rho_min=0.05)
    else:
        s = systems.quadrotor_50hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"],
                        rho=rho or s["rho"], N=N, dtype=dtype)
        if fam == "linear":
            Ax = np.zeros((1, 12))
            Ax[0, 2] = 1.0
            prob = tm.with_linear_constraints(prob, Ax, [ZMAX],
                                              np.ones((1, 4)), [6.0])
        else:
            Ax = np.zeros((N, 1, 12))
            Ax[:, 0, 2] = 1.0
            prob = tm.with_tv_linear_constraints(
                prob, Ax, TV_ZMAX.reshape(N, 1), np.ones((N - 1, 1, 4)),
                np.full((N - 1, 1), 6.0))
        prob = prob.replace(spec=dataclasses.replace(
            prob.spec, en_state_bound=False, en_input_bound=False))
        extra = {}
    return tm.with_settings(prob, max_iter=max_iter, adaptive_rho=True,
                            adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c, **extra)


def _port(pj, dtype=torch.float32):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", dtype)


def _inputs(case, seed, t=0):
    """x0s (B, nx), Xref, Uref as float32 numpy; ``t`` moves the rocket's
    reference window t steps along."""
    rng = np.random.default_rng(seed)
    if CASES[case][0] == "rocket":
        x0 = XINIT * (1 + 0.1 * rng.uniform(-1, 1, (B, 6)))
        Xref = XINIT * (1 - (np.arange(N)[:, None] + t) / 99.0)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
    else:
        start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
        x0 = start + 0.1 * rng.uniform(-1, 1, (B, 12))
        alpha = np.arange(N)[:, None] / 49.0
        Xref = (1 - alpha) * start + alpha * np.asarray([2.0, 2.0, 4.0]
                                                        + [0.0] * 9)
        Uref = None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(x0), f32(Xref), f32(Uref)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_cold_matches_jax_fused_kernel(case):
    """The same float32 problem through both fused cold solves, B=8,
    max_iter 20: atol 5e-4 on x and u (relative on the rocket's thrust of
    ~60, as the fixed-rho families tests take it), final rho rtol 1e-3,
    counts within 2 (tests/test_fused_adaptive.py's bar); rho has
    moved."""
    pj = _jax_problem(case)
    pt = _port(pj)
    assert fused_supported(pt) and stream_supported(pt)
    x0, Xref, Uref = _inputs(case, seed=1)
    sol_j, res_j = jax_solve_fused(pj, _j(Xref), _j(Uref), _j(x0), tile=B,
                                   interpret=True)
    sol_t, res_t = solve_fused_reference(pt, _t(Xref), _t(Uref), _t(x0))
    assert res_t.shape == (5, B) and bool(torch.isfinite(sol_t.x).all())
    for got, want in ((sol_t.x, sol_j.x), (sol_t.u, sol_j.u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-6,
                                   atol=5e-4)
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    assert np.any(np.abs(res_t[4].numpy() - float(pt.cache.rho)) > 1e-3)


@pytest.mark.parametrize("case", ["soc_apply_c", "tv_guard"])
def test_plain_warm_matches_jax_warm_kernel(case):
    """A warm sequence of 3 solves with rho and the family duals riding
    the carry, each package with its own carry (the JAX one converted at
    the start), the plant stepped with the JAX solve's u0: atol 2e-3 on u
    (relative on the thrust), the carried rho rtol 5e-3, counts within 3
    (tests/test_fused_adaptive.py:101-128)."""
    pj = _jax_problem(case)
    pt = _port(pj)
    cj = jax_init_carry(pj, B)
    ct_ = carry_from_numpy(carry_to_numpy(cj), "cpu")
    assert ct_.rho.shape == (1, B) and ct_.x is not None
    A, Bm, f = (np.asarray(getattr(pj, k), np.float32) for k in ("A", "B",
                                                                  "f"))
    x0 = _inputs(case, seed=3)[0]
    for t in range(3):
        _, Xref, Uref = _inputs(case, seed=3, t=t)
        sol_j, _, cj = jax_solve_fused_warm(pj, _j(Xref), _j(Uref), _j(x0),
                                            cj, tile=B, interpret=True)
        sol_t, res_t, ct_ = solve_fused_warm_reference(pt, _t(Xref),
                                                       _t(Uref), _t(x0), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=5e-6, atol=2e-3)
        np.testing.assert_allclose(ct_.rho.numpy(), np.asarray(cj.rho),
                                   rtol=5e-3)
        assert torch.equal(ct_.rho[0], res_t[4])
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 3)
        x0 = (x0 @ A.T + np.asarray(sol_j.u[0]) @ Bm.T + f).astype(
            np.float32)
    assert np.any(np.abs(ct_.rho.numpy() - float(pt.cache.rho)) > 1e-3)


def _plain64(prob, Xref, Uref, x0, carry=None):
    """The fused plain version on float64 tables and inputs."""
    spec, st = prob.spec, prob.settings
    tables = admm_fused._pack_tables(prob, Xref, Uref, torch.float64)
    params = dict(max_iter=int(st.max_iter), ct=int(st.check_termination),
                  rho=float(prob.cache.rho), tol_pri=float(st.abs_pri_tol),
                  tol_dua=float(st.abs_dua_tol),
                  fam=admm_fused._families(spec),
                  adapt=admm_fused._adaptive(st))
    out = admm_fused._solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                                  carry=carry, **params)
    return out[:2] if carry is None else out[:3]


@pytest.mark.parametrize("case", ["soc", "box63", "tv_guard"])
def test_plain_float64_meets_the_parity_bar_of_admm_solve(case):
    """In float64 the plain version and the port's telescoped admm.solve
    differ only in the order of their matrix sums: equal counts, x, u and
    the final rho to 1e-6 (tests/test_parity.py's bar), cold and over a
    warm solve that starts from each one's state."""
    pt = _port(_jax_problem(case, max_iter=40), torch.float64)
    x0, Xref, Uref = (_t(a, torch.float64) for a in _inputs(case, seed=2))
    sol_f, res_f = _plain64(pt, Xref, Uref, x0)
    sol_s, _, cache = tt.solve(pt, tt.init_state(pt, (B,)), Xref, Uref, x0)
    np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
    for got, want in ((sol_f.x, sol_s.x), (sol_f.u, sol_s.u)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(res_f[4].numpy(), cache.rho.numpy(),
                               rtol=1e-6)
    assert res_f.dtype == torch.float64


def test_box_rocket_runs_a_families_instantiation(monkeypatch):
    """The launch glue of the box-only rocket at (6, 3), against a stand-in
    for the C entry point of csrc/admm_group.cu,
    tinympc_admm_group_families: fixed and adaptive rho run its families
    kinds with zero counts (counted as families instantiations), and a
    warm solve hands it no x/u, which its carry does not keep; no launch
    reaches csrc/admm_fused.cu."""
    seen = []

    def entry(*args):
        assert len(args) == 26
        a = args[23]._obj
        counts = [getattr(a, n) for n in admm_fused.Families._fields]
        seen.append((bool(args[0]), counts, args[24] is not None,
                     [getattr(a, k) is not None
                      for k in ("x_in", "u_in", "x_out", "u_out")]))
        return 0

    def fused(*args):
        raise AssertionError("a launch reached csrc/admm_fused.cu")

    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda multi=False: fused)
    monkeypatch.setattr(admm_fused, "_group_policy_fn", lambda kind: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    names = [k for k in vars(admm_fused) if k.endswith("launch_count")]
    for k in names:
        monkeypatch.setattr(admm_fused, k, 0)
    adaptive = _port(_jax_problem("box63"))
    fixed = tt.with_settings(adaptive, adaptive_rho=False)
    for prob in (fixed, adaptive):
        assert fused_supported(prob)
        assert init_carry(prob, 3).x is None
        tables, x0, params = admm_fused._prepare(prob, None, None,
                                                 torch.zeros((3, 6)))
        admm_fused._solve_kernel(tables, x0, N, 6, 3, **params)
        carry = admm_fused._carry_tensors(prob, init_carry(prob, 3), 3)
        _, _, out = admm_fused._solve_kernel_warm(tables, x0, carry, N, 6,
                                                  3, **params)
        assert out.x is None and out.u is None
    zero = [0] * 6
    assert seen == [(False, zero, False, [False] * 4),
                    (True, zero, False, [False] * 4),
                    (False, zero, True, [False] * 4),
                    (True, zero, True, [False] * 4)]
    counts = {k: getattr(admm_fused, k) for k in names}
    assert counts == {k: int(k in ("families_launch_count",
                                   "families_warm_launch_count",
                                   "adaptive_families_launch_count",
                                   "adaptive_families_warm_launch_count"))
                      for k in names}


def test_instantiation_names_follow_the_dispatch():
    """csrc/admm_fused.cu's dispatch: box-only (12, 4) on the box kernel,
    every problem at (6, 3) and every family mix on a families kernel,
    adaptive or not."""
    inst = admm_fused._instantiation
    soc = admm_fused.Families(ncx=1)
    ad = admm_fused.Adaptive(False, True, 1.0, 100.0, 1.0)
    none = admm_fused.NO_FAMILIES
    assert inst(12, 4, none, None, None) == "box"
    assert inst(6, 3, none, None, None) == "families"
    assert inst(12, 4, soc, None, None) == "families"
    assert inst(12, 4, none, ad, None) == "adaptive"
    assert inst(6, 3, none, ad, None) == "adaptive_families"
    assert inst(12, 4, soc, ad, None) == "adaptive_families"
    assert inst(12, 4, none, None, admm_fused.Consensus(4, 1.0)) == \
        "consensus"


@pytest.mark.parametrize("name", ["quadrotor_20hz", "rocket_landing_20hz"])
def test_host_sensitivities_match_jax_and_the_fixed_point(name):
    """compute_sensitivities, which runs on the host and moves its tables
    to the problem's device, gives the JAX package's tangents in float64
    (1e-8, as test_torch_adaptive.py holds them), and bitwise what its
    fixed point gives run where its inputs are (sensitivity_tangents, the
    loop that reads the stopping test every step): in float64, and in
    float32 over its first 1,000 steps (the quadrotor's 1e-10 is never met
    in float32, so its set-up runs all 10,000)."""
    s = getattr(systems, name)()
    args = [np.asarray(s[k], np.float64) for k in ("A", "B", "f", "Qdiag",
                                                   "Rdiag")]
    want = jriccati.compute_sensitivities(*(jnp.asarray(a) for a in args),
                                          jnp.float64(s["rho"]))
    for dt, n in ((torch.float64, 10_000), (torch.float32, 1_000)):
        got = tt.riccati.compute_sensitivities(*(_t(a, dt) for a in args),
                                               s["rho"], max_iters=n)
        loop = tt.riccati.sensitivity_tangents(*(_t(a, dt) for a in args),
                                               s["rho"], max_iters=n)
        for g, o in zip(got, loop):
            assert g.dtype == dt and g.device.type == "cpu"
            assert torch.equal(g, o)
        if dt == torch.float64:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=1e-8)


@pytest.mark.parametrize("system", ["quadrotor_20hz", "rocket_landing_20hz"])
@pytest.mark.parametrize("family", ["box", "soc", "linear", "tv"])
def test_every_family_is_supported_with_adaptive_rho(system, family):
    """fused_supported and stream_supported hold for adaptive rho with
    each family at (12, 4) and (6, 3), the box alone included; the
    box-only problem at fixed rho too (at (6, 3) it runs the families
    kernel with zero counts). No solve runs."""
    s = getattr(tt.systems, system)()
    nx, nu = s["B"].shape
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, f=s.get("f"), device="cpu")
    prob = tt.with_bounds(prob, u_min=-1.0, u_max=1.0)
    if family == "soc":
        prob = tt.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
    elif family == "linear":
        prob = tt.with_linear_constraints(prob, np.eye(nx)[:1], [1.0],
                                          np.ones((1, nu)), [2.0])
    elif family == "tv":
        prob = tt.with_tv_linear_constraints(
            prob, np.tile(np.eye(nx)[:1], (N, 1, 1)), np.ones((N, 1)))
    else:
        assert fused_supported(prob) and stream_supported(prob)
    adaptive = tt.with_settings(tt.with_sensitivities(
        prob, [np.zeros((nu, nx)), np.zeros((nx, nx)), np.zeros((nu, nu)),
               np.zeros((nx, nx))]), adaptive_rho=True)
    assert fused_supported(adaptive) and stream_supported(adaptive)
