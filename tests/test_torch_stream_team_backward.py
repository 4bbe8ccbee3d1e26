"""The streamed backward kernel on lane teams, at fixed and adaptive rho,
and the streamed forward kernel on lane teams at adaptive rho
(csrc/admm_stream_team.cuh), emulated on the CPU in their own layout.

The backward emulation runs a block of TeamShape's lanes, one thread a
(lane, row), thread t holding row t // lanes of lane t % lanes; each
thread's row of [B^T; AmBKt], of Kinf^T (a state row) or Quu_inv (an input
row) and, under adaptive rho, of dKinf^T, dC1 and dC2; p, r and w passed
through the lane's slot in two halves by the step's parity, the input rows
forming r one step ahead and d one step behind; every dot summed from zero
in column order with a correctly rounded float32 fma (``fma32``); done
lanes and lanes past the batch store nothing. The adaptive forward
emulation is ``team_forward`` of tests/test_torch_stream_team.py with the
adaptation folded into the sweep.

Each emulation is held bitwise against its kernel's plain version, one
launch at a time; whole adaptive streamed solves driven through both are
held against the JAX package's streamed kernels in interpret mode; and the
launch glue against stand-ins for the C entries: box problems, at fixed
and adaptive rho, take the team entries for both launches. The CUDA
kernels themselves run on the card only (chip_smoke.py phases 17-22,
35-37)."""
import contextlib
import ctypes
import dataclasses
import functools
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import solve_fused_streamed as jax_streamed

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (admm_fused, admm_stream, init_carry,
                                       solve_fused_streamed_reference,
                                       solve_fused_streamed_warm_reference,
                                       stream_supported)
from test_torch_stream_team import (_offsets, _view, fma32, sqrt_rn,
                                    team_forward, team_lanes)

torch.set_num_threads(1)

XINIT = np.array([4, 2, 20, -3, 2, -4.5])


@pytest.fixture(autouse=True)
def _rounded_sqrt(monkeypatch):
    """The plain versions' float32 root correctly rounded, as the card's
    and the kernels' sqrt_rn are (torch's vectorised CPU root is not
    always)."""
    raw = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: sqrt_rn(x)
                        if x.dtype == torch.float32 else raw(x, *a, **k))


# ------------------------------------------------------------ the emulation

def team_backward(tables, vprev, zprev, g, y, d, done, active, *, N, nx, nu,
                  rho, adapt=None, rho_lane=None):
    """One launch of stream_backward_team_kernel<nx, nu, Rho>, every thread
    of every block at once as a (block, thread) tensor; writes d of the
    running lanes in place and zeroes ``active``."""
    B = vprev.shape[2]
    lanes = team_lanes(nx)
    rows = nx + nu
    T = lanes * rows
    nblk = -(-B // lanes)
    t = torch.arange(T)
    row, lane = t // lanes, t % lanes
    b = torch.arange(nblk)[:, None] * lanes + lane           # (block, thread)
    bc = b.clamp(max=B - 1)
    run = (b < B) & ~done[bc]
    st_row = row < nx
    k = torch.where(st_row, row, row - nx)
    kx, ku = k.clamp(max=nx - 1), k.clamp(max=nu - 1)
    o = _offsets(nx, nu, N, adapt)
    cx, cu = torch.arange(nx), torch.arange(nu)
    pick = lambda st, inp: torch.where(
        st_row.reshape((-1,) + (1,) * (st.dim() - 1)), st, inp)
    # Each thread's row of [B^T; AmBKt], of Kinf^T or Quu_inv, APf or BPf,
    # Q or R; under adaptive rho dKinf^T or dC1 (apply_c), and dC2.
    mrow = torch.where(st_row, nu + k, k)
    mb = tables[o["Mback"] + mrow[:, None] * nx + cx]
    c1 = pick(tables[o["KinfT"] + kx[:, None] * nu + cu],
              tables[o["Quu"] + ku[:, None] * nu + cu])
    cst = pick(tables[o["APf"] + kx], tables[o["BPf"] + ku])
    wq = pick(tables[o["Qd"] + kx], tables[o["Rd"] + ku])
    apply_c = adapt is not None and adapt.apply_c
    rl, drho = torch.full((nblk, T), rho), torch.zeros((nblk, T))
    if adapt is not None:
        e1 = pick(tables[o["dKT"] + kx[:, None] * nu + cu],
                  tables[o["dC1"] + ku[:, None] * nu + cu] if apply_c
                  else torch.zeros((T, nu)))
        if apply_c:
            e2 = tables[o["dC2"] + kx[:, None] * nx + cx]
        rl = torch.where(run, rho_lane[bc], torch.tensor(rho))
        drho = rl - rho
    active[0] = 0
    # The block's terminal term -Pinf^T Xref[N-1] and -dPinf^T Xref[N-1].
    xl = tables[o["Xref"] + (N - 1) * nx + cx]
    pn, pdp = torch.zeros(nx), torch.zeros(nx)
    for j in range(nx):
        pn = fma32(tables[o["PinfT"] + cx * nx + j], xl[j], pn)
        if adapt is not None:
            pdp = fma32(tables[o["dPT"] + cx * nx + j], xl[j], pdp)
    pn, pdp = -pn, -pdp
    sm, im = run & st_row, run & ~st_row
    kk = k.expand(nblk, T)
    blk = torch.arange(nblk)[:, None].expand(nblk, T)
    ln = lane.expand(nblk, T)
    # The lanes' slots: p, r, w, each in two halves by parity.
    P = torch.zeros((nblk, lanes, 2, nx))
    R = torch.zeros((nblk, lanes, 2, nu))
    W = torch.zeros((nblk, lanes, 2, nu))
    ref_x = tables[o["Xref"]:o["Xref"] + N * nx].reshape(N, nx)
    ref_u = tables[o["Uref"]:o["Uref"] + (N - 1) * nu].reshape(N - 1, nu)

    def lin(mask, j, state):
        """-(ref .* w) - rho (slack - dual) of row j on the masked threads,
        state rows (vprev / g / Xref) or input rows (zprev / y / Uref)."""
        ks, bs = kk[mask], b[mask]
        if state:
            slack, dual, ref = vprev[j, ks, bs], g[j, ks, bs], ref_x[j, ks]
        else:
            slack, dual, ref = zprev[j, ks, bs], y[j, ks, bs], ref_u[j, ks]
        return -(ref * wq.expand(nblk, T)[mask]) - rl[mask] * (slack - dual)

    def quu(wv):
        """d of the input rows from the lane's w (block, T, nu)."""
        acc = torch.zeros((nblk, T))
        for c in range(nu):
            acc = fma32(c1[:, c], wv[..., c], acc)
        if apply_c:
            s = torch.zeros((nblk, T))
            for c in range(nu):
                s = fma32(e1[:, c], wv[..., c], s)
            acc = acc + drho * s
        return acc

    pt = pn[kk[sm]]
    if adapt is not None:
        pt = pt + drho[sm] * pdp[kk[sm]]
    bs = b[sm]
    P[blk[sm], ln[sm], (N - 1) & 1, kk[sm]] = pt - rl[sm] * (
        vprev[N - 1, kk[sm], bs] - g[N - 1, kk[sm], bs])
    r_own = torch.zeros((nblk, T))
    r_own[im] = lin(im, N - 2, False)
    R[blk[im], ln[im], (N - 2) & 1, kk[im]] = r_own[im]
    for i in range(N - 2, -1, -1):
        # after the step's barrier: p[i+1], r[i], w[i+1] in the slots
        p = P[:, lane, (i + 1) & 1, :]
        acc = torch.zeros((nblk, T))
        for c in range(nx):
            acc = fma32(mb[:, c], p[..., c], acc)
        # state rows: p[i] = ((q + ap) - kr) + APf
        ap = acc
        if apply_c:
            s = torch.zeros((nblk, T))
            for c in range(nx):
                s = fma32(e2[:, c], p[..., c], s)
            ap = ap + drho * s
        r = R[:, lane, i & 1, :]
        kr = torch.zeros((nblk, T))
        for c in range(nu):
            kr = fma32(c1[:, c], r[..., c], kr)
        if adapt is not None:
            s = torch.zeros((nblk, T))
            for c in range(nu):
                s = fma32(e1[:, c], r[..., c], s)
            kr = kr + drho * s
        pnew = ((lin(sm, i, True) + ap[sm]) - kr[sm]) \
            + cst.expand(nblk, T)[sm]
        # input rows: w[i] = (B^T p + r) + BPf, d[i+1], r[i-1] ahead
        w = (acc + r_own) + cst
        if i + 1 <= N - 2:
            dv = quu(W[:, lane, (i + 1) & 1, :])
            d[i + 1, kk[im], b[im]] = dv[im]
        P[blk[sm], ln[sm], i & 1, kk[sm]] = pnew
        W[blk[im], ln[im], i & 1, kk[im]] = w[im]
        if i >= 1:
            r_own[im] = lin(im, i - 1, False)
            R[blk[im], ln[im], (i - 1) & 1, kk[im]] = r_own[im]
    dv = quu(W[:, lane, 0, :])
    d[0, kk[im], b[im]] = dv[im]


class _Teams(admm_stream._PLAIN):
    """Both launches on the emulations, on the working arrays of
    ``admm_stream._init``: the host loop of a box solve on the card, run on
    the CPU."""

    def backward(self, prev):
        s, p = self.s, self.params
        team_backward(self.tables, s["vnew"][prev], s["znew"][prev], s["g"],
                      s["y"], s["d"], s["done"], s["active"], rho=p["rho"],
                      adapt=p["adapt"], rho_lane=s["rho"], **self.dims)

    def forward(self, it, stale):
        s, cur, p = self.s, it % 2, self.params
        vd, zd = (self.carry.v, self.carry.z) if stale else \
            (s["vnew"][1 - cur], s["znew"][1 - cur])
        team_forward(self.tables, self.x0, vd, zd, s["vnew"][cur],
                     s["znew"][cur], s["g"], s["y"], s["d"], s["iters"],
                     s["done"], s["res"], s["active"], it=it, ct=p["ct"],
                     rho=p["rho"], tol_pri=p["tol_pri"],
                     tol_dua=p["tol_dua"], adapt=p["adapt"],
                     rho_lane=s["rho"], rho_v=s["rho_v"], **self.dims)


# ------------------------------------------------------------ problems

@functools.lru_cache(maxsize=None)
def _rocket_tables():
    """The rocket's rho sensitivities, computed once in float64 (the
    float32 fixed point runs to its iteration cap)."""
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=4,
                 f=s["f"], dtype=torch.float64, device="cpu")
    c = tt.with_sensitivities(p).cache
    return tuple(a.numpy() for a in (c.dKinf_drho, c.dPinf_drho, c.dC1_drho,
                                     c.dC2_drho))


@functools.lru_cache(maxsize=None)
def _guard_tables():
    """The quadrotor's sensitivities at rho 1000, in float64."""
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=1000.0, N=4,
                 dtype=torch.float64, device="cpu")
    c = tt.with_sensitivities(p).cache
    return tuple(a.numpy() for a in (c.dKinf_drho, c.dPinf_drho, c.dC1_drho,
                                     c.dC2_drho))


def _problem(nx, mode, N, max_iter=40, ct=1):
    """A box problem at (12, 4) (the quadrotor) or (6, 3) (the rocket's
    box alone): at fixed rho, or adaptive ("adaptive", "apply_c", or
    "guard": rho 1000, tolerance 3, its first predictions clipped to
    adaptive_rho_max)."""
    if nx == 12:
        s = tt.systems.quadrotor_20hz()
        rho = 1000.0 if mode == "guard" else s["rho"]
        p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=N,
                     dtype=torch.float32, device="cpu")
        p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
        tables = _guard_tables() if mode == "guard" else \
            tt.systems.crazyflie_sensitivity_tables()
        extra = {}
    else:
        s = tt.systems.rocket_landing_20hz()
        p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                     N=N, f=s["f"], dtype=torch.float32, device="cpu")
        p = tt.with_bounds(
            p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        tables = _rocket_tables()
        extra = dict(abs_pri_tol=2e-3, adaptive_rho_min=0.05)
    p = tt.with_settings(p, max_iter=max_iter, check_termination=ct)
    if mode == "fixed":
        return tt.with_settings(p, **{k: v for k, v in extra.items()
                                      if k == "abs_pri_tol"})
    p = tt.with_sensitivities(p, tables)
    return tt.with_settings(p, adaptive_rho=True,
                            adaptive_rho_apply_c=mode == "apply_c",
                            adaptive_rho_tolerance=3.0 if mode == "guard"
                            else 1.0, **extra)


def _inputs(nx, N, B, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    if nx == 6:
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
        return (f(XINIT * rng.uniform(0.6, 1.4, (B, 1))),
                f(np.linspace(XINIT, np.zeros(6), N)), f(Uref))
    return (f(rng.uniform(-0.4, 0.4, (B, 12))),
            f(np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1))), None)


def _state(prob, Xref, Uref, x0, iters, carry=None):
    """The working arrays after ``iters`` iterations of the plain host loop
    (fixed or adaptive rho), beside the launch parameters."""
    warm = carry is not None
    tables, x0c, carry_t, params = admm_stream._prepare(
        prob, Xref, Uref, x0, carry, warm)
    spec = prob.spec
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    s = admm_stream._init(x0c, spec.N, spec.nx, spec.nu, carry_t,
                          params["fam"], None,
                          None if params["adapt"] is None else params["rho"])
    run = admm_stream._PLAIN(tables, x0c, s, carry_t, spec.N, spec.nx,
                             spec.nu, **kw)
    for it in range(iters):
        run.backward(1 - it % 2)
        run.forward(it, warm and it == 0)
    return tables, x0c, carry_t, s, kw


def _clone(s):
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("mode", ["fixed", "adaptive", "apply_c"])
@pytest.mark.parametrize("nx", [12, 6])
def test_backward_emulation_is_bitwise_the_plain_backward_launch(nx, mode):
    """One backward launch from a state 7 iterations in (each lane's rho
    moved by an adaptation under adaptive rho), B=13 (a partial last team)
    with some lanes done: the emulation writes bitwise the d that
    stream_backward_reference writes, the done lanes' d untouched, and
    zeroes the flag."""
    N, B = 12, 13
    prob = _problem(nx, mode, N)
    x0, Xref, Uref = _inputs(nx, N, B, 5)
    tables, _, _, s, kw = _state(prob, Xref, Uref, x0, 7)
    s["done"][1::3] = True
    if mode != "fixed":
        assert len(torch.unique(s["rho"])) > 1
    prev = 1 - 7 % 2
    sentinel = torch.full_like(s["d"], 7.0)
    ref = admm_stream.stream_backward_reference(
        tables, s["vnew"][prev], s["znew"][prev], s["g"], s["y"], sentinel,
        s["done"], s["fams"], None, None, s["rho"], N=N, nx=nx,
        nu=prob.spec.nu, rho=kw["rho"], adapt=kw["adapt"])
    d = sentinel.clone()
    active = torch.ones(1, dtype=torch.int32)
    team_backward(tables, s["vnew"][prev], s["znew"][prev], s["g"], s["y"],
                  d, s["done"], active, N=N, nx=nx, nu=prob.spec.nu,
                  rho=kw["rho"], adapt=kw["adapt"], rho_lane=s["rho"])
    assert torch.equal(d, ref)
    assert torch.equal(d[:, :, s["done"]], sentinel[:, :, s["done"]])
    assert int(active[0]) == 0


# (iteration, check_termination, stale): an adaptation iteration with and
# without the check, a plain one with and without, and the stale launch
# of a warm solve's first iteration with and without.
LAUNCHES = {"adapt-check": (5, 1, False), "adapt-no-check": (5, 4, False),
            "check": (4, 1, False), "no-check": (4, 2, False),
            "stale-check": (0, 1, True), "stale-no-check": (0, 2, True)}


@pytest.mark.parametrize("launch", sorted(LAUNCHES))
@pytest.mark.parametrize("nx,mode", [(12, "adaptive"), (12, "guard"),
                                     (6, "adaptive")],
                         ids=["quad", "quad-guard", "rocket"])
def test_adaptive_forward_emulation_is_bitwise_the_plain_launch(nx, mode,
                                                               launch):
    """One adaptive forward launch from a state some iterations in (a warm
    state's first, for the stale launch), B=13 with some lanes done: the
    emulation writes bitwise what stream_forward_reference writes --
    slacks, duals, iterations, flags, residuals, the flag ``active``, each
    lane's rho and virtual rho. The guard's lanes start at rho 1000, whose
    predictions the clip holds at adaptive_rho_max, through the virtual
    rho."""
    it, ct, stale = LAUNCHES[launch]
    N, B = 12, 13
    prob = _problem(nx, mode, N, ct=ct)
    x0, Xref, Uref = _inputs(nx, N, B, 5)
    carry = None
    if stale:
        carry = solve_fused_streamed_warm_reference(
            tt.with_settings(prob, max_iter=7), Xref, Uref, x0,
            init_carry(prob, B))[2]
        x0 = x0 + 0.01
    tables, x0c, carry_t, s, kw = _state(prob, Xref, Uref, x0, it, carry)
    run = admm_stream._PLAIN(tables, x0c, s, carry_t, N, nx, prob.spec.nu,
                             **kw)
    run.backward(1 - it % 2)
    s["done"][1::3] = True
    cur = it % 2
    vd, zd = (carry_t.v, carry_t.z) if stale else (s["vnew"][1 - cur],
                                                   s["znew"][1 - cur])
    ref = admm_stream.stream_forward_reference(
        tables, x0c, s["vnew"][1 - cur], s["znew"][1 - cur], s["vnew"][cur],
        s["znew"][cur], s["g"], s["y"], s["d"], s["iters"], s["done"],
        s["res"], s["fams"], None, None, vd if stale else None,
        zd if stale else None, rho_lane=s["rho"], rho_v=s["rho_v"], it=it,
        N=N, nx=nx, nu=prob.spec.nu, **kw)
    em = _clone(s)
    em["active"] = torch.zeros(1, dtype=torch.int32)
    team_forward(tables, x0c, vd, zd, em["vnew"][cur], em["znew"][cur],
                 em["g"], em["y"], em["d"], em["iters"], em["done"],
                 em["res"], em["active"], it=it, N=N, nx=nx, nu=prob.spec.nu,
                 ct=ct, rho=kw["rho"], tol_pri=kw["tol_pri"],
                 tol_dua=kw["tol_dua"], adapt=kw["adapt"],
                 rho_lane=em["rho"], rho_v=em["rho_v"])
    got = dict(vcur=em["vnew"][cur], zcur=em["znew"][cur], rho=em["rho"],
               **{k: em[k] for k in ("g", "y", "iters", "done", "res",
                                     "active", "rho_v")})
    for name, value in got.items():
        assert torch.equal(value, ref[name]), name
    if it == 5:
        moved = ~s["done"] & (ref["rho"] != s["rho"])
        assert moved.any()
        if mode == "guard":
            assert (ref["rho_v"][~s["done"]] == 100.0).any()


@pytest.mark.parametrize("nx,mode", [(12, "fixed"), (12, "apply_c"),
                                     (12, "guard"), (6, "adaptive")])
def test_solve_through_both_emulations_is_the_plain_solve(nx, mode):
    """Whole streamed solves, cold and then two warm, with both launches on
    the emulations: bitwise the plain streamed solve (solutions, counts,
    flags, residuals with the final rho, carry), B=13, ct 2, max_iter 16
    (adaptations at iterations 5, 10 and 15)."""
    N, B = 8, 13
    prob = _problem(nx, mode, N, max_iter=16, ct=2)
    x0, Xref, Uref = _inputs(nx, N, B, 7)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_e, res_e = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                                     **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(sol_e, name), getattr(sol_p, name)), name
    assert torch.equal(res_e, res_p)
    c_e = c_p = init_carry(prob, B)
    for _ in range(2):
        x0 = x0 + 0.02
        t_, x_, c_t, params = admm_stream._prepare(prob, Xref, Uref, x0, c_e,
                                                   True)
        sol_e, res_e, c_e = admm_stream._loop(t_, x_, c_t, prob.spec,
                                              _Teams, **params)
        sol_p, res_p, c_p = solve_fused_streamed_warm_reference(
            prob, Xref, Uref, x0, c_p)
        assert torch.equal(sol_e.x, sol_p.x) and torch.equal(res_e, res_p)
        for f in dataclasses.fields(c_p):
            a, b = getattr(c_e, f.name), getattr(c_p, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name


def test_adaptive_solve_through_the_emulations_matches_the_jax_kernels():
    """The quadrotor's box with adaptive rho (the Crazyflie tables) and
    apply_c, N=12, B=8 (batched), max_iter 40, both launches on the
    emulations, against the JAX streamed kernels in interpret mode at
    tests/test_torch_stream_adaptive.py's bar: atol 5e-4 on x and u, final
    rho rtol 1e-3, counts within 2; rho has moved."""
    N, B = 12, 8
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    pj = tm.with_sensitivities(pj, systems.crazyflie_sensitivity_tables())
    pj = tm.with_settings(pj, max_iter=40, adaptive_rho=True,
                          adaptive_rho_apply_c=True)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.4, 0.4, (B, 12)).astype(np.float32)
    Xref = np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1)).astype(np.float32)
    sol_j, res_j = jax_streamed(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                                tile=B, chunk=4, interpret=True)
    prob = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    assert stream_supported(prob)
    tables, x0c, _, params = admm_stream._prepare(
        prob, torch.as_tensor(Xref), None, torch.as_tensor(x0))
    sol_t, res_t = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                                     **params)[:2]
    for got, want in ((sol_t.x, sol_j.x), (sol_t.u, sol_j.u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-6,
                                   atol=5e-4)
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    assert np.any(np.abs(res_t[4].numpy() - float(prob.cache.rho)) > 1e-3)


# ------------------------------------------------------------ launch glue

class _Entries:
    """Stand-ins for the C entries of csrc/admm_stream.cu: the team entries
    run the emulations through the pointers they are given; the one-thread
    entries record their launch and leave the flag at 0; ``fail`` makes a
    team entry return a CUDA error."""

    def __init__(self):
        self.calls, self.fail = [], None

    @staticmethod
    def _adapt(arg, nx, nu, B):
        """The Adaptive settings and each lane's rho / virtual rho behind
        an AdaptArgs pointer (None at fixed rho); the scratch is null."""
        if arg is None:
            return None, None, None
        a = ctypes.cast(arg, ctypes.POINTER(admm_fused._AdaptArgs))[0]
        assert a.rho_in == a.rho_out and a.xs is None and a.axd is None
        settings = admm_fused.Adaptive(bool(a.apply_c), bool(a.clip),
                                       a.rho_min, a.rho_max, a.rho_tol)
        return (settings, _view(a.rho_in, (B,)), _view(a.rho_v, (B,)))

    def team_backward(self, *args):
        assert len(args) == 15
        if self.fail == "backward":
            return 700
        nx, nu, N, B, rho = args[:5]
        tables, vprev, zprev, g, y, d, done, active = args[5:13]
        adapt, rho_lane, _ = self._adapt(args[13], nx, nu, B)
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, admm_fused.NO_FAMILIES, adapt))
        x, u = (N, nx, B), (N - 1, nu, B)
        team_backward(_view(tables, (ntab,)), _view(vprev, x),
                      _view(zprev, u), _view(g, x), _view(y, u),
                      _view(d, u), _view(done, (B,), torch.bool),
                      _view(active, (1,), torch.int32), N=N, nx=nx, nu=nu,
                      rho=rho, adapt=adapt, rho_lane=rho_lane)
        self.calls.append(("team_backward", adapt is not None))
        return 0

    def team_forward(self, *args):
        assert len(args) == 24
        if self.fail == "forward":
            return 700
        nx, nu, N, B, it, ct, rho, tol_pri, tol_dua = args[:9]
        (tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
         active) = args[9:22]
        adapt, rho_lane, rho_v = self._adapt(args[22], nx, nu, B)
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, admm_fused.NO_FAMILIES, adapt))
        x, u = (N, nx, B), (N - 1, nu, B)
        team_forward(_view(tables, (ntab,)), _view(x0, (B, nx)),
                     _view(vd, x), _view(zd, u), _view(vcur, x),
                     _view(zcur, u), _view(g, x), _view(y, u), _view(d, u),
                     _view(iters, (B,), torch.int32),
                     _view(done, (B,), torch.bool), _view(res, (4, B)),
                     _view(active, (1,), torch.int32), it=it, N=N, nx=nx,
                     nu=nu, ct=ct, rho=rho, tol_pri=tol_pri,
                     tol_dua=tol_dua, adapt=adapt, rho_lane=rho_lane,
                     rho_v=rho_v)
        self.calls.append(("team_forward", it, adapt is not None))
        return 0

    def backward(self, *args):
        self.calls.append(("backward",))
        return 0

    def forward(self, *args):
        self.calls.append(("forward", args[5]))
        if (args[5] + 1) % args[6] == 0:
            ctypes.c_int.from_address(args[22]).value = 0
        return 0


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (e.backward, e.forward))
    monkeypatch.setattr(admm_stream, "_team_fns",
                        lambda: (e.team_backward, e.team_forward))
    # the family team entries: a recorder, failing as the box ones do
    fam = lambda side: lambda *a: 700 if e.fail == side else (
        e.calls.append((f"team_families_{side}",)), 0)[1]
    monkeypatch.setattr(admm_stream, "_team_families_fns",
                        lambda: (fam("backward"), fam("forward")))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    return e


@pytest.mark.parametrize("nx,mode", [(12, "fixed"), (12, "apply_c"),
                                     (6, "adaptive")])
def test_box_solves_take_the_team_entries(nx, mode, entries):
    """A box problem through the kernel launchers, cold then warm (B=13,
    ct 3): both launches of every iteration on the team entries, counted
    under backward_team / forward_team / forward_team_stale (with
    _adaptive under adaptive rho), no one-thread launch and no scratch;
    the results, run through the pointers, bitwise the plain streamed
    solve."""
    N, B = 10, 13
    prob = _problem(nx, mode, N, max_iter=12, ct=3)
    x0, Xref, Uref = _inputs(nx, N, B, 9)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_k, res_k = admm_stream._loop(tables, x0c, None, prob.spec,
                                     admm_stream._KERNELS, **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    assert torch.equal(sol_k.x, sol_p.x) and torch.equal(sol_k.u, sol_p.u)
    assert torch.equal(sol_k.iter, sol_p.iter) and torch.equal(res_k, res_p)
    sfx = "" if mode == "fixed" else "_adaptive"
    its = int(sol_k.iter.max())
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        **{"backward_team" + sfx: its, "forward_team" + sfx: its})
    assert {c[0] for c in entries.calls} == {"team_backward", "team_forward"}
    _, _, carry = solve_fused_streamed_warm_reference(
        prob, Xref, Uref, x0, init_carry(prob, B))
    t_, x_, c_t, params = admm_stream._prepare(prob, Xref, Uref, x0 + 0.01,
                                               carry, True)
    out_k = admm_stream._loop(t_, x_, c_t, prob.spec, admm_stream._KERNELS,
                              **params)
    out_p = solve_fused_streamed_warm_reference(prob, Xref, Uref, x0 + 0.01,
                                                carry)
    assert torch.equal(out_k[0].x, out_p[0].x) and torch.equal(out_k[1],
                                                               out_p[1])
    for f in dataclasses.fields(out_p[2]):
        a, b = getattr(out_k[2], f.name), getattr(out_p[2], f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name
    assert admm_stream.launch_counts["forward_team" + sfx + "_stale"] == 1


def test_the_one_thread_entries_on_the_same_state(entries):
    """``_KERNELS(..., team=False)`` sends both launches of a box problem to
    the one-thread entries (the in-process A/B on the card), the adaptive
    forward with the scratch of an adaptation iteration, which only the
    one-thread design allocates; the counts fall under the one-thread
    keys."""
    prob = _problem(12, "adaptive", 8, max_iter=4, ct=2)
    tables, x0c, _, params = admm_stream._prepare(prob, None, None,
                                                  torch.zeros((5, 12)))
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    s = admm_stream._init(x0c, 8, 12, 4, None, params["fam"], None,
                          params["rho"])
    teams = admm_stream._KERNELS(tables, x0c, s, None, 8, 12, 4, **kw)
    assert teams.team is not None and teams.scratch == []
    assert teams.adapt._obj.xs is None
    run = admm_stream._KERNELS(tables, x0c, s, None, 8, 12, 4, **kw,
                               team=False)
    assert run.team is None
    assert [tuple(a.shape) for a in run.scratch] == [(8, 12, 5), (7, 4, 5),
                                                     (7, 12, 5)]
    assert [run.adapt._obj.xs, run.adapt._obj.us, run.adapt._obj.axd] == [
        a.data_ptr() for a in run.scratch]
    run.backward(1)
    run.forward(0, False)
    assert [c[0] for c in entries.calls] == ["backward", "forward"]
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0), backward_adaptive=1,
        forward_adaptive=1)


@pytest.mark.parametrize("side", ["backward", "forward"])
def test_a_failing_team_launch_raises(side, entries):
    """A team entry that returns a CUDA error raises, naming the launch;
    nothing falls back to the one-thread entries, and nothing is counted:
    a box problem on the box team entries, the rocket with its cones on
    the family team entries."""
    entries.fail = side
    soc = tt.with_cones(_problem(6, "fixed", 8, max_iter=4, ct=2),
                        state_cones=[(0, 3, 0.25)],
                        input_cones=[(0, 3, 0.5)])
    for prob, nx, key in ((_problem(12, "fixed", 8, max_iter=4, ct=2), 12,
                           f"{side}_team"),
                          (soc, 6, f"{side}_team_families")):
        tables, x0c, _, params = admm_stream._prepare(prob, None, None,
                                                      torch.zeros((5, nx)))
        with pytest.raises(RuntimeError,
                           match=f"team {side} launch failed"):
            admm_stream._loop(tables, x0c, None, prob.spec,
                              admm_stream._KERNELS, **params)
        assert not [c for c in entries.calls
                    if c[0] in ("backward", "forward")]
        assert admm_stream.launch_counts[key] == 0


def test_no_new_refusal_for_the_backward(entries, monkeypatch):
    """Every box problem the streamed solve took still runs both launches
    on the team entries: horizons from 2 to past the resident wall,
    batches that leave the last team partial or hold a single lane, at
    (12, 4) and (6, 3), fixed and adaptive (their arithmetic stood in by a
    recorder here)."""
    record = lambda name: lambda *a: (entries.calls.append((name, a[:4])),
                                      0)[1]
    monkeypatch.setattr(admm_stream, "_team_fns", lambda: (
        record("team_backward"), record("team_forward")))
    for nx in (12, 6):
        for mode in ("fixed", "adaptive"):
            for N, batches in ((2, (1, 13, 1029)), (3, (7,)),
                               (2048, (1, 13))):
                prob = _problem(nx, mode, N, max_iter=1, ct=2)
                assert stream_supported(prob)
                nu = prob.spec.nu
                for B in batches:
                    tables, x0c, _, params = admm_stream._prepare(
                        prob, None, None, torch.zeros((B, nx)))
                    kw = {k: v for k, v in params.items() if k != "max_iter"}
                    s = admm_stream._init(
                        x0c, N, nx, nu, None, params["fam"], None,
                        None if params["adapt"] is None else params["rho"])
                    run = admm_stream._KERNELS(tables, x0c, s, None, N, nx,
                                               nu, **kw)
                    run.backward(1)
                    run.forward(0, False)
                    assert entries.calls[-2:] == [
                        ("team_backward", (nx, nu, N, B)),
                        ("team_forward", (nx, nu, N, B))]
