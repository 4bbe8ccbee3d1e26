"""Box adaptive rho at (12, 4) on the thread-group kernel
(csrc/admm_group.cu with admm_group.cuh's GroupAdaptiveRho), emulated on
the CPU in its own layout, and its launch glue.

The emulation is tests/test_torch_group_consensus.py's ``group_solve``
under adaptive rho: each problem's rho, virtual rho and drho on every
thread of its group; each thread's rows of the sensitivities (dKinf on an
input row, dKinf^T on a state row, and under apply_c dC1 / dC2), every
product the Taylor update moves formed as base + drho (dM v) from dot
products summed from zero with the correctly rounded float32 fma; on an
adaptation iteration the OSQP terms folded into the forward sweep -- row
j's at step j+1 from the new dual g[j+1] the state rows leave in the
problem's g slot, the terminal Pinf / dPinf row from x[N-1] in the x slot
-- the four maxima reduced over the group with max_nan and the new rho
formed by rho_update (correctly rounded quotients and root) with identical
operands on every thread; no scratch array.

It is held bitwise against the kernel's plain version (the final rho row
and the carried rho included), cold and over warm solves that carry rho,
with apply_c and with the guard from rho 1000, at PLACE_SHARED and
PLACE_SAVED_GLOBAL (the plain version's float32 root made correctly
rounded, as the card's is: torch's vectorised CPU root is not always);
against the JAX package's fused kernel in interpret mode at
tests/test_torch_adaptive_fused.py's bar; and the launch glue against a
stand-in for tinympc_admm_group_adaptive that runs the emulation through
its pointers, the multi-system fleet included. Adaptive rho with a family
or at (6, 3) keeps csrc/admm_fused.cu. The CUDA kernel runs on the card
only (chip_smoke.py phases 13-16, 26, 35-37; chip_compare.py)."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import solve_fused as jax_solve_fused

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import admm_fused, init_carry
from tinympc_tpu_torch.kernels.admm_fused import (
    BLOCK, PLACE_SAVED_GLOBAL, PLACE_SHARED, Adaptive, FusedCarry,
    group_arena_floats, group_geometry, group_route)
from test_torch_group_consensus import (_view, assert_bitwise, emulate,
                                        group_solve)
from test_torch_stream_team import sqrt_rn
from test_torch_stream_team_backward import _guard_tables

torch.set_num_threads(1)

N = 6


@pytest.fixture(autouse=True)
def _rounded_sqrt(monkeypatch):
    """The plain version's float32 root correctly rounded, as the card's
    sqrt_rn is (torch's vectorised CPU root is not always)."""
    raw = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: sqrt_rn(x)
                        if x.dtype == torch.float32 else raw(x, *a, **k))


def quad(mode, N=N, max_iter=30, ct=1, scale=1.0):
    """The quadrotor's box with adaptive rho: the Crazyflie tables at rho 5
    ("adaptive", "apply_c"), or the guard from rho 1000 with its own
    sensitivities (tolerance 3; its first predictions clipped to
    adaptive_rho_max commit)."""
    s = tt.systems.quadrotor_20hz()
    A = np.asarray(s["A"], dtype=np.float64).copy()
    A[~np.eye(12, dtype=bool)] *= scale
    rho = 1000.0 if mode == "guard" else s["rho"]
    p = tt.setup(A, s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    p = tt.with_sensitivities(p, _guard_tables() if mode == "guard"
                              else tt.systems.crazyflie_sensitivity_tables())
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                            adaptive_rho=True,
                            adaptive_rho_apply_c=mode == "apply_c",
                            adaptive_rho_tolerance=3.0 if mode == "guard"
                            else 1.0)


def x0s(B, seed=0, spread=0.4):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -spread, spread, (B, 12)), dtype=torch.float32)


HOVER = torch.as_tensor(np.tile([0, 0, 1.0] + [0.0] * 9, (N, 1)),
                        dtype=torch.float32)


# ------------------------------------------------------------ bitwise

@pytest.mark.parametrize("mode,ct,place", [
    ("adaptive", 1, PLACE_SHARED), ("apply_c", 2, PLACE_SAVED_GLOBAL),
    ("guard", 1, PLACE_SHARED), ("guard", 1, PLACE_SAVED_GLOBAL)])
def test_emulation_is_bitwise_the_plain_solve(mode, ct, place):
    """A cold solve, then two warm solves of an external plant, rho riding
    the carry: every output, the final rho row and every carry field
    bitwise the plain version's; rho has moved."""
    prob = quad(mode, ct=ct)
    B = 20
    x = x0s(B, seed=len(mode))
    got = emulate(prob, HOVER, x, place=place)
    assert_bitwise(got, tt.kernels.solve_fused_reference(prob, HOVER, None,
                                                         x))
    rho0 = float(prob.cache.rho)
    assert bool((got[1][4] != rho0).any())
    c_e = c_p = init_carry(prob, B)
    for _ in range(2):
        got = emulate(prob, HOVER, x, c_e, place=place)
        want = tt.kernels.solve_fused_warm_reference(prob, HOVER, None, x,
                                                     c_p)
        assert_bitwise(got, want)
        assert torch.equal(got[2].rho[0], got[1][4])
        c_e, c_p = got[2], want[2]
        x = x @ prob.A.T + got[0].u[0] @ prob.B.T + prob.f


# ------------------------------------------------------------ JAX

@pytest.mark.parametrize("case", ["apply_c", "rho_tol_3"])
def test_emulation_matches_the_jax_kernel(case):
    """tests/test_torch_adaptive_fused.py's float32 cases (N=10, B=8, the
    Crazyflie tables; apply_c from rho 5, the guard from rho 1000), max_iter
    40: the emulation against the JAX fused kernel in interpret mode at
    that file's bar -- atol 5e-4 on x and u, final rho rtol 1e-3, counts
    within 2 -- and rho has moved."""
    rho, tol, apply_c = {"apply_c": (5.0, 1.0, True),
                         "rho_tol_3": (1000.0, 3.0, False)}[case]
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=10,
                  dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    pj = tm.with_sensitivities(pj, systems.crazyflie_sensitivity_tables())
    pj = tm.with_settings(pj, max_iter=40, adaptive_rho=True,
                          adaptive_rho_tolerance=tol,
                          adaptive_rho_apply_c=apply_c)
    Xr = np.tile(np.asarray([0, 0, 0.5] + [0] * 9, np.float32), (10, 1))
    x0 = (np.random.default_rng(1 if apply_c else 0).uniform(
        -0.2, 0.2, (8, 12)) * 2.0).astype(np.float32)
    sol_j, res_j = jax_solve_fused(pj, jnp.asarray(Xr), None,
                                   jnp.asarray(x0), tile=8, interpret=True)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    sol_e, res_e = emulate(pt, torch.as_tensor(Xr), torch.as_tensor(x0))
    for got, want in ((sol_e.x, sol_j.x), (sol_e.u, sol_j.u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-4)
    np.testing.assert_allclose(res_e[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_e.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    assert np.any(np.abs(res_e[4].numpy() - rho) > 1e-3)


# ------------------------------------------------------------ geometry

def test_adaptive_arena_and_route():
    """The adaptive arena adds a g slot (nx floats) to each problem's
    exchange slot; the table adds the adaptive tables (and apply_c's). Box
    problems at (12, 4) take the group launch at every horizon the fused
    solve takes; a family or (6, 3) takes the families adaptive kinds."""
    for N_, P, saved in ((10, 8, False), (20, 8, True), (1150, 1, False)):
        for kind in ("adaptive", "adaptive_c"):
            assert group_arena_floats(N_, P, saved, kind=kind) == \
                group_arena_floats(N_, P, saved) + 12 * P
    for apply_c, extra in ((False, 6 * 144 - 2 * 144 + 2 * 48),
                           (True, 6 * 144 - 2 * 144 + 2 * 48 + 16 + 144)):
        ad = Adaptive(apply_c, True, 1.0, 100.0, 1.0)
        assert admm_fused._table_floats(12, 4, 20, adapt=ad) == \
            admm_fused._table_floats(12, 4, 20) + extra
    fam = admm_fused.NO_FAMILIES
    ad = Adaptive(False, True, 1.0, 100.0, 1.0)
    adc = ad._replace(apply_c=True)
    assert group_route(20, 12, 4, fam, ad, None, False) == (
        "adaptive", 8, PLACE_SHARED, 1)
    assert group_route(20, 12, 4, fam, adc, None, True)[0] == "adaptive_c"
    for N_ in (2, 700, 1117, 1118, 1196):
        for warm in (False, True):
            kind, P, place, _ = group_route(N_, 12, 4, fam, ad, None, warm)
            _, _, smem = group_geometry(N_, warm, kind="adaptive")
            assert smem <= admm_fused.SMEM_LIMIT and BLOCK % P == 0
    assert group_route(20, 12, 4, admm_fused.Families(ncx=1), ad, None,
                       False) == ("families_adaptive", 8, PLACE_SHARED, 1)
    assert group_route(20, 6, 3, fam, adc, None, True) == (
        "families_adaptive_c", 16, PLACE_SHARED, 1)


# ------------------------------------------------------------ launch glue

class Entry:
    """A stand-in for tinympc_admm_group_adaptive: its arguments checked
    and recorded, the emulation run through its pointers, each 128-lane
    tile of a fleet with its system's table."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert len(args) == 25
        (warm, nx, nu, P, place, N_, B, max_iter, ct, rho, tol_pri,
         tol_dua, tables, x0, ox, ou, oi, osv, orr, carry, block_sys,
         stride, saved, adapt, stream) = args
        a = adapt._obj
        assert all(p is None for p in (a.xs, a.us, a.axd, a.rho_v))
        assert (a.rho_in is not None) == bool(warm)
        ad = Adaptive(bool(a.apply_c), bool(a.clip), a.rho_min, a.rho_max,
                      a.rho_tol)
        self.calls.append(dict(warm=warm, P=P, place=place, adapt=ad,
                               fleet=block_sys is not None))
        x, u = (N_, nx, B), (N_ - 1, nu, B)
        res = _view(orr, (5, B))
        assert a.rho_out == res[4].data_ptr()
        tiles = [(0, B, 0)] if block_sys is None else [
            (k * BLOCK, min(B, (k + 1) * BLOCK), int(s)) for k, s in
            enumerate(_view(block_sys, (-(-B // BLOCK),), ctypes.c_int32))]
        cin = [_view(carry[k], s) for k, s in enumerate([x, u] * 3)] \
            if warm else None
        for lo, hi, sys_ in tiles:
            lanes = slice(lo, hi)
            c = None if not warm else FusedCarry(
                vnew=cin[0][..., lanes], znew=cin[1][..., lanes],
                g=cin[2][..., lanes], y=cin[3][..., lanes],
                v=cin[4][..., lanes], z=cin[5][..., lanes],
                rho=_view(a.rho_in, (1, B))[:, lanes].clone())
            sol, r, out = group_solve(
                _view(tables + 4 * sys_ * stride, (stride,)).clone(),
                _view(x0, (B, nx))[lanes].clone(), N_, nx, nu,
                max_iter=max_iter, ct=ct, rho=rho, tol_pri=tol_pri,
                tol_dua=tol_dua, carry=c, adapt=ad, P=P, place=place)
            _view(ox, (N_, B, nx))[:, lanes] = sol.x
            _view(ou, (N_ - 1, B, nu))[:, lanes] = sol.u
            _view(oi, (B,), ctypes.c_int32)[lanes] = sol.iter
            _view(osv, (B,), ctypes.c_bool)[lanes] = sol.solved
            res[:, lanes] = r
            if warm:
                for k, f in enumerate(("vnew", "znew", "v", "z", "g", "y")):
                    _view(carry[6 + k], [x, u][k % 2])[..., lanes] = \
                        getattr(out, f)
        return 0


@pytest.fixture
def entry(monkeypatch):
    e = Entry()
    monkeypatch.setattr(admm_fused, "_group_policy_fn",
                        lambda kind: e if kind.startswith("adaptive")
                        else None)
    monkeypatch.setattr(admm_fused, "_group_fn", lambda: None)
    monkeypatch.setattr(admm_fused, "_kernel_fn",
                        lambda multi=False: lambda *a: e.calls.append(
                            ("fused", a[1], [a[7][k] for k in range(6)]))
                        or 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(admm_fused, "entry_counts",
                        dict.fromkeys(admm_fused.entry_counts, 0))
    for k in ("adaptive_launch_count", "adaptive_warm_launch_count",
              "multi_launch_count"):
        monkeypatch.setattr(admm_fused, k, 0)
    return e


def test_box_adaptive_takes_the_group_entry(entry):
    """A cold and two warm solves of the box with apply_c through the
    launch glue: each on tinympc_admm_group_adaptive with its settings, 8
    problems a block in shared memory, the carried rho warm, no scratch;
    every output, the final rho and the carry bitwise the plain
    version's; counted as adaptive launches."""
    prob = quad("apply_c", ct=2)
    B = 20
    x = x0s(B, seed=9)
    tables, x0c, params = admm_fused._prepare(prob, HOVER, None, x)
    got = admm_fused._solve_kernel(tables, x0c, N, 12, 4, **params)
    assert_bitwise(got, tt.kernels.solve_fused_reference(prob, HOVER, None,
                                                         x))
    c_k = c_p = init_carry(prob, B)
    for _ in range(2):
        ck = admm_fused._carry_tensors(prob, c_k, B)
        got = admm_fused._solve_kernel_warm(tables, x0c, ck, N, 12, 4,
                                            **params)
        want = tt.kernels.solve_fused_warm_reference(prob, HOVER, None, x,
                                                     c_p)
        assert_bitwise(got, want)
        c_k, c_p = got[2], want[2]
    assert [(c["warm"], c["P"], c["place"], c["adapt"].apply_c, c["fleet"])
            for c in entry.calls] == [(w, 8, PLACE_SHARED, True, False)
                                      for w in (0, 1, 1)]
    assert admm_fused.entry_counts["tinympc_admm_group_adaptive"] == 3
    assert admm_fused.entry_counts["tinympc_admm_fused"] == 0
    assert (admm_fused.adaptive_launch_count,
            admm_fused.adaptive_warm_launch_count) == (1, 2)


def test_adaptive_fleet_takes_the_group_entry(entry):
    """A ragged two-system adaptive fleet (70 and 50 lanes) in one
    multi-system launch of tinympc_admm_group_adaptive: each 128-lane tile
    with its system's table, every lane bitwise
    solve_fused_multi_reference's."""
    probs = [quad("adaptive", scale=sc) for sc in (1.0, 1.004)]
    x0 = x0s(120, seed=4)
    tables, x0c, bk, spec, params = admm_fused._prepare_multi(probs, x0,
                                                              None, None)
    got = admm_fused._solve_systems_kernel(tables, x0c, bk, N, 12, 4,
                                           **params)
    want = tt.kernels.solve_fused_multi_reference(probs, x0)
    for f in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f))
    assert torch.equal(got[1], want[1])
    (call,) = entry.calls
    assert call["fleet"] and admm_fused.multi_launch_count == 1
    assert admm_fused.entry_counts["tinympc_admm_group_adaptive"] == 1


def test_adaptive_with_a_family_or_at_6_3_keeps_the_one_thread_entry(
        entry, monkeypatch):
    """Adaptive rho with a state hyperplane at (12, 4) and the rocket's box
    at (6, 3): one system's launch takes csrc/admm_group.cu's
    tinympc_admm_group_families (its nx and family counts recorded), while
    their multi-system launch, a fleet of two systems, keeps the one-thread
    kernel's tinympc_admm_fused_multi; neither reaches the box adaptive
    entry."""
    calls = []

    def families(*args):
        a = args[23]._obj
        calls.append(("group", args[1], [getattr(a, n) for n in
                                         admm_fused.Families._fields],
                      args[24] is not None))
        return 0

    monkeypatch.setattr(admm_fused, "_group_policy_fn", lambda kind:
                        families if kind in admm_fused.FAMILY_KINDS
                        else entry)
    lin = tt.with_linear_constraints(quad("adaptive"), np.eye(12)[2:3],
                                     [2.0])
    s = tt.systems.rocket_landing_20hz()
    rocket = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                      N=N, f=s["f"], device="cpu")
    rocket = tt.with_settings(tt.with_sensitivities(
        tt.with_bounds(rocket, u_min=-10.0, u_max=105.0),
        [np.zeros((3, 6)), np.zeros((6, 6)), np.zeros((3, 3)),
         np.zeros((6, 6))]), adaptive_rho=True)
    for prob in (lin, rocket):
        spec = prob.spec
        tables, x0c, params = admm_fused._prepare(
            prob, None, None, torch.zeros((3, spec.nx)))
        admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx, spec.nu,
                                 **params)
        tables, x0c, bk, _, params = admm_fused._prepare_multi(
            [prob, prob], torch.zeros((4, spec.nx)), None, None)
        admm_fused._solve_systems_kernel(tables, x0c, bk, spec.N, spec.nx,
                                         spec.nu, **params)
    assert calls == [("group", 12, [0, 0, 1, 0, 0, 0], True),
                     ("group", 6, [0] * 6, True)]
    assert entry.calls == [("fused", 12, [0, 0, 1, 0, 0, 0]),
                           ("fused", 6, [0] * 6)]
    assert admm_fused.entry_counts["tinympc_admm_group_adaptive"] == 0
    assert admm_fused.entry_counts["tinympc_admm_group_families"] == 2
    assert admm_fused.entry_counts["tinympc_admm_fused_multi"] == 2
