"""The streamed forward kernel of box problems at fixed rho on lane teams
(csrc/admm_stream_team.cuh), emulated on the CPU in its own layout: a
block of TeamShape's lanes, one thread a (lane, row), thread t holding row
t // lanes of lane t % lanes; each thread's row of [Kinf; A] and of B, its
dot products summed from zero in column order with a correctly rounded
float32 fma; x and u exchanged through the lane's slot once their owners
have written; the residual maxima of each row reduced over the team with
max_nan; done lanes and lanes past the batch store nothing.

The emulation is held bitwise against the kernel's plain version,
``stream_forward_reference``, one launch at a time (cold and stale, on
check and non-check iterations, at (12, 4) and (6, 3), with a partial last
team), and a whole streamed solve driven through it against the JAX
package's streamed kernels in interpret mode. The launch glue is held
against stand-ins for the C entries: box problems at fixed rho take the
team entries and their counts, families (adaptive or not) and consensus
the one-thread kernels and theirs. The emulation also runs adaptive rho
(tests/test_torch_stream_team_backward.py holds it and the team backward
kernel). The CUDA kernels themselves run on the card only (chip_smoke.py
phases 17-22, 35-37)."""
import contextlib
import ctypes
import dataclasses
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
from tinympc_tpu_torch.types import ADAPTIVE_RHO_PERIOD
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (init_carry,
                                       solve_fused_streamed_reference,
                                       solve_fused_streamed_warm_reference,
                                       stream_supported)
from tinympc_tpu_torch.kernels import admm_fused, admm_stream

torch.set_num_threads(1)

XINIT = np.array([4, 2, 20, -3, 2, -4.5])


# ------------------------------------------------------------ the emulation

def fma32(a, b, c):
    """float32 fma(a, b, c), correctly rounded: a * b is exact in float64,
    the sum's rounding error comes from TwoSum, and a sum that lands on a
    float32 midpoint is moved to the neighbour the error points to."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    # A float64 whose low 29 mantissa bits are 1000...0 sits halfway
    # between two float32s; there the exact sum s + e decides, so s moves
    # one float64 step toward it before the rounding.
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.where(e > 0, math.inf, -math.inf)
    return torch.where(mid & (e != 0), torch.nextafter(s, toward),
                       s).float()


def clamp_nan(s, lo, hi):
    s = torch.where(s < lo, lo, s)
    return torch.where(s > hi, hi, s)


def max_nan(m, a):
    return torch.where((a > m) | (a != a), a, m)


def team_lanes(nx):
    """TeamShape::kLanes: the fewest lanes (8 or more) for which the state
    rows fill whole warps."""
    return 8 if 8 * nx % 32 == 0 else 16 if 16 * nx % 32 == 0 else 32


def _offsets(nx, nu, N, adapt=None):
    out, o = {}, 0
    for name, shape in admm_fused._table_layout(nx, nu, N,
                                                admm_fused.NO_FAMILIES,
                                                adapt):
        out[name] = o
        o += math.prod(shape)
    return out


def sqrt_rn(x):
    """The correctly rounded float32 root (the kernels' sqrt_rn)."""
    return torch.sqrt(x.double()).float()


def maxabs(m, a):
    return max_nan(m, a.abs())


def team_forward(tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
                 active, *, it, N, nx, nu, ct, rho, tol_pri, tol_dua,
                 adapt=None, rho_lane=None, rho_v=None):
    """One launch of stream_forward_team_kernel<nx, nu, Rho>, every thread
    of every block at once as a (block, thread) tensor. Reads and writes the
    lane-last arrays in place, as the kernel does. With ``adapt`` (the
    adaptive-rho settings) each lane's ``rho_lane`` telescopes the rollout
    gain and, on an adaptation iteration, the OSQP terms of row j are
    folded in at step j+1 from the lane's new dual g[j+1] in its slot; row
    0's thread forms the new rho, updating ``rho_lane`` / ``rho_v`` in
    place."""
    B = x0.shape[0]
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
    k = torch.where(st_row, row, row - nx)                   # (thread,)
    ku = k.clamp(max=nu - 1)
    o = _offsets(nx, nu, N, adapt)
    # Each thread's row of [Kinf; A] and of B, and f.
    mrow = torch.where(st_row, nu + k, k)
    f1 = tables[o["Mfwd"] + mrow[:, None] * nx + torch.arange(nx)]
    bm = torch.where(st_row[:, None],
                     tables[o["Bm"] + k[:, None] * nu + torch.arange(nu)],
                     torch.zeros(()))
    fv = torch.where(st_row, tables[o["f"] + k.clamp(max=nx - 1)],
                     torch.zeros(()))
    checking = (it + 1) % ct == 0
    adapting = adapt is not None and it > 0 and \
        it % ADAPTIVE_RHO_PERIOD == 0
    drho = torch.zeros(())
    if adapt is not None:
        # An input row's row of dKinf; the row of A^T (state) or B^T
        # (input) the adaptation applies to g[j+1]; Q or R; the lane's rho.
        cols = torch.arange(nx)
        dk = tables[o["dK"] + ku[:, None] * nx + cols]
        gr = torch.where(st_row[:, None],
                         tables[o["AT"] + k[:, None] * nx + cols],
                         tables[o["Mback"] + ku[:, None] * nx + cols])
        wq = torch.where(st_row, tables[o["Qd"] + k], tables[o["Rd"] + ku])
        rl = torch.where(run, rho_lane[bc], torch.tensor(rho))
        drho = rl - rho
    sm, im = run & st_row, run & ~st_row         # running state / input rows
    kk = k.expand(nblk, T)
    pr = torch.zeros((nblk, T))
    du = torch.zeros((nblk, T))

    def project(i, val, mask, lo, hi, dual, slack, prev):
        """Row i of the masked threads: project, update the dual from the
        pre-update one, store both, fold in the residual maxima; returns
        the new slack and dual (0 off the mask)."""
        nonlocal pr, du
        ks, bs = kk[mask], b[mask]
        v = val[mask]
        dn0 = dual[i, ks, bs]
        sn = clamp_nan(v + dn0, lo[i, ks], hi[i, ks])
        dn = dn0 + v - sn
        dual[i, ks, bs] = dn
        slack[i, ks, bs] = sn
        if checking:
            pr[mask] = max_nan(pr[mask], (v - sn).abs())
            du[mask] = max_nan(du[mask], (prev[i, ks, bs] - sn).abs())
        out_s, out_d = torch.zeros((nblk, T)), torch.zeros((nblk, T))
        out_s[mask], out_d[mask] = sn, dn
        return out_s, out_d

    t_ = {n: tables[o[n]:o[n] + math.prod(s)].reshape(s)
          for n, s in admm_fused._table_layout(nx, nu, N,
                                               admm_fused.NO_FAMILIES,
                                               adapt)}
    state = (t_["xmin"], t_["xmax"], g, vcur, vd)
    inputs = (t_["umin"], t_["umax"], y, zcur, zd)
    slot = torch.zeros((nblk, lanes, nx + nu))                # x, then u
    gslot = torch.zeros((nblk, lanes, nx))
    blk = torch.arange(nblk)[:, None].expand(nblk, T)
    ln = lane.expand(nblk, T)
    z = lambda: torch.zeros((nblk, T))
    pres, pnorm, dres, dnorm = z(), z(), z(), z()
    pa, pb, pc, ad1, ad2 = z(), z(), z(), z(), z()

    def terms(j):
        """Row j's OSQP terms on the running threads, g[j+1] in the
        slots; ad2 is the dynamics row j-1."""
        nonlocal pres, pnorm, dres, dnorm
        gv = gslot[:, lane, :]
        acc = torch.zeros((nblk, T))
        for c in range(nx):
            acc = fma32(gr[:, c], gv[..., c], acc)
        w = lambda mask, new, old: torch.where(mask, new, old)
        qx = wq * pa
        aty = acc - (pb if j >= 1 else 0.0)
        dres = w(sm, maxabs(dres, qx + qx + aty), dres)
        dnorm = w(sm, maxabs(maxabs(maxabs(dnorm, qx), aty), qx), dnorm)
        if j >= 1:
            pres = w(sm, maxabs(pres, ad2 - pc), pres)
            pnorm = w(sm, maxabs(maxabs(pnorm, ad2), pc), pnorm)
        ru = wq * pa
        atu = pb + acc
        dres = w(im, maxabs(dres, 2.0 * ru + atu), dres)
        dnorm = w(im, maxabs(maxabs(dnorm, ru), atu), dnorm)
        pres = w(im, maxabs(pres, pa - pc), pres)
        pnorm = w(im, maxabs(maxabs(pnorm, pa), pc), pnorm)

    xo = torch.zeros((nblk, T))
    xo[sm] = x0[b[sm], kk[sm]]
    slot[blk[sm], ln[sm], kk[sm]] = xo[sm]
    for i in range(N - 1):
        # after the first barrier: x of step i in the slots
        x = slot[:, lane, :nx]                                # (block, T, nx)
        a1 = torch.zeros((nblk, T))
        for c in range(nx):
            a1 = fma32(f1[:, c], x[..., c], a1)
        sn_x, dn_x = project(i, xo, sm, *state)
        kx = a1
        if adapt is not None:
            s = torch.zeros((nblk, T))
            for c in range(nx):
                s = fma32(dk[:, c], x[..., c], s)
            kx = a1 + drho * s
        u = torch.zeros((nblk, T))
        u[im] = -kx[im] - d[i, kk[im], b[im]]
        slot[blk[im], ln[im], nx + kk[im]] = u[im]
        sn_u, dn_u = project(i, u, im, *inputs)
        if adapting:
            gslot[blk[sm], ln[sm], kk[sm]] = dn_x[sm]
        # after the second barrier: u of step i in the slots
        us = slot[:, lane, nx:]
        acc = torch.zeros((nblk, T))
        for c in range(nu):
            acc = fma32(bm[:, c], us[..., c], acc)
        s = a1 + acc
        xn = torch.where(sm, s + fv, xo)
        slot[blk[sm], ln[sm], kk[sm]] = xn[sm]
        if adapting:
            if i >= 1:
                terms(i - 1)
            pa = torch.where(st_row, xo, u)
            pb = torch.where(st_row, dn_x, dn_u)
            pc = torch.where(st_row, sn_x, sn_u)
            ad2, ad1 = ad1, s - xn
        xo = xn
    snN, dnN = project(N - 1, xo, sm, *state)
    if adapting:
        gslot[blk[sm], ln[sm], kk[sm]] = dnN[sm]
        terms(N - 2)
        # Row N-1: the terminal Pinf telescoped by drho dPinf, no A^T g
        # term, the dynamics row N-2 against the slack of row N-1.
        x = slot[:, lane, :nx]
        pp, dp = torch.zeros((nblk, T)), torch.zeros((nblk, T))
        for c in range(nx):
            kc = k.clamp(max=nx - 1) * nx + c
            pp = fma32(tables[o["Pinf"] + kc], x[..., c], pp)
            dp = fma32(tables[o["dP"] + kc], x[..., c], dp)
        px = pp + drho * dp
        qx = wq * xo
        aty = 0.0 - dnN
        dres = torch.where(sm, maxabs(dres, px + qx + aty), dres)
        dnorm = torch.where(sm, maxabs(maxabs(maxabs(dnorm, px), aty), qx),
                            dnorm)
        pres = torch.where(sm, maxabs(pres, ad1 - snN), pres)
        pnorm = torch.where(sm, maxabs(maxabs(pnorm, ad1), snN), pnorm)
    # Row 0's thread of each running lane: the team's maxima, bookkeeping.
    lead = run & (row == 0)
    bl = b[lead]
    iters[bl] = it + 1
    team = lambda v: v.reshape(nblk, rows, lanes)
    rho_b = torch.full((nblk, lanes), rho)
    if adapt is not None:
        rho_b = rl[:, :lanes].clone()
        if adapting:
            m = []
            for v in (pres, pnorm, dres, dnorm):
                acc = torch.zeros((nblk, lanes))
                for r in range(rows):
                    acc = max_nan(acc, team(v)[:, r])
                m.append(acc)
            eps = 1e-10
            ratio = (m[0] / (m[1] + eps)) / (m[2] / (m[3] + eps) + eps)
            factor = sqrt_rn(ratio)
            clip = (lambda v: clamp_nan(v, torch.tensor(adapt.rho_min),
                                        torch.tensor(adapt.rho_max))) \
                if adapt.clip else (lambda v: v)
            rv = rho_v[bc[:, :lanes]]
            if adapt.rho_tol > 1.0:
                nv = clip(rv * factor)
                commit = (nv >= adapt.rho_tol * rho_b) | \
                    (nv * adapt.rho_tol <= rho_b)
                rho_b = torch.where(commit, nv, rho_b)
                rv = nv
            else:
                rho_b = clip(rho_b * factor)
            keep = lead[:, :lanes]
            rho_v[b[:, :lanes][keep]] = rv[keep]
        rho_lane[bl] = rho_b[lead[:, :lanes]]
    if not checking:
        return
    red = [team(r) for r in (pr, du)]
    m = [torch.zeros((nblk, lanes)) for _ in range(4)]   # ps, ds, pi, di
    for r in range(rows):
        side = 0 if r < nx else 2
        m[side] = max_nan(m[side], red[0][:, r])
        m[side + 1] = max_nan(m[side + 1], red[1][:, r])
    ps, ds, pi, di = (v[:, None, :].expand(nblk, rows, lanes)
                      .reshape(nblk, T)[lead] for v in m)
    rb = rho_b[:, None, :].expand(nblk, rows, lanes).reshape(nblk, T)[lead]
    r2, r3 = ds * rb, di * rb
    res[0, bl], res[1, bl], res[2, bl], res[3, bl] = ps, pi, r2, r3
    ok = (ps < tol_pri) & (pi < tol_pri) & (r2 < tol_dua) & (r3 < tol_dua)
    done[bl[ok]] = True
    if (~ok).any():
        active[0] = 1


class _Team(admm_stream._PLAIN):
    """The plain backward launch and the emulated team forward launch on
    the working arrays of ``admm_stream._init``: the host loop of a box
    solve on the card, run on the CPU."""

    def forward(self, it, stale):
        s, cur, p = self.s, it % 2, self.params
        vd, zd = (self.carry.v, self.carry.z) if stale else \
            (s["vnew"][1 - cur], s["znew"][1 - cur])
        s["active"] = torch.zeros(1, dtype=torch.int32)
        team_forward(self.tables, self.x0, vd, zd, s["vnew"][cur],
                     s["znew"][cur], s["g"], s["y"], s["d"], s["iters"],
                     s["done"], s["res"], s["active"], it=it, ct=p["ct"],
                     rho=p["rho"], tol_pri=p["tol_pri"],
                     tol_dua=p["tol_dua"], **self.dims)


# ------------------------------------------------------------ problems

def _quad(N, max_iter=100, ct=1):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct)


def _rocket_box(N, max_iter=100, ct=1):
    """The rocket (6, 3) with its box alone: a box problem at (6, 3)."""
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device="cpu")
    p = tt.with_bounds(
        p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=2e-3)


def _inputs(nx, N, B, seed):
    rng = np.random.default_rng(seed)
    if nx == 6:
        x0 = XINIT * rng.uniform(0.6, 1.4, (B, 1))
        Xref = np.linspace(XINIT, np.zeros(6), N)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
        f = lambda a: torch.as_tensor(a, dtype=torch.float32)
        return f(x0), f(Xref), f(Uref)
    x0 = rng.uniform(-0.2, 0.2, (B, 12))
    Xref = np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1))
    return (torch.as_tensor(x0, dtype=torch.float32),
            torch.as_tensor(Xref, dtype=torch.float32), None)


PROBLEMS = {12: _quad, 6: _rocket_box}


def _state(prob, Xref, Uref, x0, iters, carry=None):
    """The working arrays after ``iters`` iterations of the plain host loop
    (the backward launch of the next one run), beside the launcher."""
    tables, x0c, carry_t, params = admm_stream._prepare(
        prob, Xref, Uref, x0, carry, carry is not None)
    spec = prob.spec
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    s = admm_stream._init(x0c, spec.N, spec.nx, spec.nu, carry_t,
                          params["fam"])
    run = admm_stream._PLAIN(tables, x0c, s, carry_t, spec.N, spec.nx,
                             spec.nu, **kw)
    for it in range(iters):
        run.backward(1 - it % 2)
        run.forward(it, carry is not None and it == 0)
    run.backward(1 - iters % 2)
    return tables, x0c, carry_t, s, kw


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("B", [8, 13])
@pytest.mark.parametrize("stale,it,ct", [(False, 3, 1), (False, 3, 3),
                                         (True, 0, 1), (True, 0, 2)],
                         ids=["check", "no-check", "stale-check",
                              "stale-no-check"])
@pytest.mark.parametrize("nx", [12, 6])
def test_emulation_is_bitwise_the_plain_forward_launch(nx, stale, it, ct, B):
    """One forward launch from a state some iterations in (a warm state's
    first, for the stale launch), some lanes done: the emulation writes
    bitwise what stream_forward_reference writes -- slacks, duals,
    iterations, flags, residuals and the flag ``active``."""
    N = 12
    prob = PROBLEMS[nx](N, ct=ct)
    x0, Xref, Uref = _inputs(nx, N, B, 5)
    carry = None
    if stale:
        sol, _, carry = solve_fused_streamed_warm_reference(
            tt.with_settings(prob, max_iter=4), Xref, Uref, x0,
            init_carry(prob, B))
        x0 = x0 + 0.01
    tables, x0c, carry_t, s, kw = _state(prob, Xref, Uref, x0, it, carry)
    s["done"][1::3] = True            # lanes that converged earlier
    cur = it % 2
    vd, zd = (carry_t.v, carry_t.z) if stale else (s["vnew"][1 - cur],
                                                   s["znew"][1 - cur])
    ref = admm_stream.stream_forward_reference(
        tables, x0c, s["vnew"][1 - cur], s["znew"][1 - cur], s["vnew"][cur],
        s["znew"][cur], s["g"], s["y"], s["d"], s["iters"], s["done"],
        s["res"], s["fams"], vstale=vd if stale else None,
        zstale=zd if stale else None, it=it, N=N, nx=nx, nu=prob.spec.nu,
        **kw)
    em = {k: s[k].clone() for k in ("g", "y", "iters", "done", "res")}
    em["vcur"], em["zcur"] = s["vnew"][cur].clone(), s["znew"][cur].clone()
    em["active"] = torch.zeros(1, dtype=torch.int32)
    team_forward(tables, x0c, vd, zd, em["vcur"], em["zcur"], em["g"],
                 em["y"], s["d"], em["iters"], em["done"], em["res"],
                 em["active"], it=it, N=N, nx=nx, nu=prob.spec.nu,
                 ct=kw["ct"], rho=kw["rho"], tol_pri=kw["tol_pri"],
                 tol_dua=kw["tol_dua"])
    for name in ("vcur", "zcur", "g", "y", "iters", "done", "res", "active"):
        assert torch.equal(em[name], ref[name]), name
    if (it + 1) % ct == 0:
        assert (em["res"][:, ~s["done"]] != 0).any()


@pytest.mark.parametrize("nx", [12, 6])
def test_solve_through_the_emulation_is_the_plain_solve(nx):
    """Whole streamed solves, cold and two warm, with the forward launches
    on the emulation: bitwise the plain streamed solve (solutions, counts,
    flags, residuals, carry), B=13 (a partial last team), ct 2."""
    N, B = 10, 13
    prob = PROBLEMS[nx](N, max_iter=60, ct=2)
    x0, Xref, Uref = _inputs(nx, N, B, 7)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_e, res_e = admm_stream._loop(tables, x0c, None, prob.spec, _Team,
                                     **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(sol_e, name), getattr(sol_p, name)), name
    assert torch.equal(res_e, res_p)
    assert 0 < int(sol_e.solved.sum()) < B
    c_e = c_p = init_carry(prob, B)
    for _ in range(2):
        x0 = x0 + 0.02
        if _ == 0:      # the carry of a first warm solve, from the plain one
            c_e = c_p = solve_fused_streamed_warm_reference(
                prob, Xref, Uref, x0, c_p)[2]
            continue
        t_, x_, c_t, params = admm_stream._prepare(prob, Xref, Uref, x0,
                                                   c_e, True)
        sol_e, res_e, c_e = admm_stream._loop(t_, x_, c_t, prob.spec, _Team,
                                              **params)
        sol_p, res_p, c_p = solve_fused_streamed_warm_reference(
            prob, Xref, Uref, x0, c_p)
        assert torch.equal(sol_e.x, sol_p.x) and torch.equal(res_e, res_p)
        for f in dataclasses.fields(c_p):
            a, b = getattr(c_e, f.name), getattr(c_p, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name


def test_solve_through_the_emulation_matches_the_jax_streamed_kernels():
    """The box quadrotor of tests/test_torch_stream.py at N=12, max_iter 80
    (B=8: lanes converge mid-batch), with the forward launches on the
    emulation, against the JAX streamed kernels in interpret mode at
    tests/test_stream_kernel.py's bar: x, u, residuals to 1e-4, counts
    within 1, equal flags where the counts agree."""
    N, B = 12, 8
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    pj = tm.with_settings(pj, max_iter=80)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.2, 0.2, (B, 12)).astype(np.float32)
    Xref = np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1)).astype(np.float32)
    sol_j, res_j = jax_streamed(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                                tile=8, chunk=8, interpret=True)
    prob = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    tables, x0c, _, params = admm_stream._prepare(
        prob, torch.as_tensor(Xref), None, torch.as_tensor(x0))
    sol_t, res_t = admm_stream._loop(tables, x0c, None, prob.spec, _Team,
                                     **params)[:2]
    it_t, it_j = sol_t.iter.numpy(), np.asarray(sol_j.iter)
    assert np.all(np.abs(it_t - it_j) <= 1), (it_t, it_j)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                               atol=1e-4)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=1e-4)
    same = it_t == it_j
    np.testing.assert_array_equal(sol_t.solved.numpy()[same],
                                  np.asarray(sol_j.solved)[same])
    assert 0 < sol_t.solved.sum() < B


# ------------------------------------------------------------ launch glue

def _view(ptr, shape, dtype=torch.float32):
    """The CPU tensor at address ``ptr`` (a pointer the wrapper passed)."""
    n = math.prod(shape)
    ctype = {torch.float32: ctypes.c_float, torch.int32: ctypes.c_int32,
             torch.bool: ctypes.c_uint8}[dtype]
    return torch.frombuffer((ctype * n).from_address(ptr),
                            dtype=dtype).reshape(shape)


class _Entries:
    """Stand-ins for the C entries of csrc/admm_stream.cu. The team
    backward and the team forward entry run the plain backward launch and
    the team emulation through the pointers they are given; the one-thread
    forward entry records its launch and leaves the flag at 0."""

    def __init__(self):
        self.calls = []

    def backward(self, *args):
        assert len(args) == 15 and args[13] is None   # fixed rho
        nx, nu, N, B, rho = args[:5]
        tables, vprev, zprev, g, y, d, done, active = args[5:13]
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(nx, nu,
                                                                      N))
        x, u = (N, nx, B), (N - 1, nu, B)
        out = admm_stream.stream_backward_reference(
            _view(tables, (ntab,)), _view(vprev, x), _view(zprev, u),
            _view(g, x), _view(y, u), _view(d, u), _view(done, (B,),
                                                         torch.bool),
            [None] * 12, N=N, nx=nx, nu=nu, rho=rho)
        _view(d, u).copy_(out)
        _view(active, (1,), torch.int32).zero_()
        self.calls.append("backward")
        return 0

    def forward(self, *args):
        assert len(args) == 29
        it, ct = args[5], args[6]
        self.calls.append(("forward", bool(args[0]),
                           args[26] is not None, args[27] is not None))
        if (it + 1) % ct == 0:
            ctypes.c_int.from_address(args[22]).value = 0
        return 0

    def team(self, *args):
        assert len(args) == 24 and args[22] is None   # fixed rho
        nx, nu, N, B, it, ct, rho, tol_pri, tol_dua = args[:9]
        (tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
         active) = args[9:22]
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(nx, nu,
                                                                      N))
        x, u = (N, nx, B), (N - 1, nu, B)
        team_forward(_view(tables, (ntab,)), _view(x0, (B, nx)),
                     _view(vd, x), _view(zd, u), _view(vcur, x),
                     _view(zcur, u), _view(g, x), _view(y, u), _view(d, u),
                     _view(iters, (B,), torch.int32),
                     _view(done, (B,), torch.bool), _view(res, (4, B)),
                     _view(active, (1,), torch.int32), it=it, N=N, nx=nx,
                     nu=nu, ct=ct, rho=rho, tol_pri=tol_pri,
                     tol_dua=tol_dua)
        self.calls.append(("team", it))
        return 0


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (None, e.forward))
    monkeypatch.setattr(admm_stream, "_team_fns",
                        lambda: (e.backward, e.team))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    return e


@pytest.mark.parametrize("nx", [12, 6])
def test_box_solves_launch_the_team_entry(nx, entries):
    """A box problem at fixed rho through the kernel launchers, cold then
    warm (B=13, ct 3): every launch on the team entries, the warm solve's
    first forward as its stale launch (the carried v/z as the dual
    residual's slacks), counted under backward_team / forward_team /
    forward_team_stale; the results, run through the pointers, bitwise the
    plain streamed solve."""
    N, B = 10, 13
    prob = PROBLEMS[nx](N, max_iter=30, ct=3)
    x0, Xref, Uref = _inputs(nx, N, B, 9)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_k, res_k = admm_stream._loop(tables, x0c, None, prob.spec,
                                     admm_stream._KERNELS, **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    assert torch.equal(sol_k.x, sol_p.x) and torch.equal(sol_k.u, sol_p.u)
    assert torch.equal(sol_k.iter, sol_p.iter) and torch.equal(res_k, res_p)
    cold = dict(admm_stream.launch_counts)
    its = int(sol_k.iter.max())
    assert cold == dict(dict.fromkeys(cold, 0), backward_team=its,
                        forward_team=its)
    assert "forward" not in [c[0] for c in entries.calls
                             if isinstance(c, tuple)]
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
    assert torch.equal(out_k[2].v, out_p[2].v)
    assert admm_stream.launch_counts["forward_team_stale"] == 1


def _soc():
    p = _rocket_box(8, max_iter=4, ct=2)
    return tt.with_cones(p, state_cones=[(0, 3, 0.25)],
                         input_cones=[(0, 3, 0.5)])


def _consensus():
    return tt.with_consensus(_quad(8, max_iter=4, ct=2), rho_c=50.0)


def _adaptive():
    """Adaptive rho with a family (a time-varying hyperplane on z): an
    adaptive box problem runs on the team entries since the team backward
    kernel (tests/test_torch_stream_team_backward.py)."""
    N = 8
    a = np.zeros((N, 1, 12))
    a[:, 0, 2] = 1.0
    p = tt.with_tv_linear_constraints(_quad(N, max_iter=4, ct=2), a,
                                      np.full((N, 1), 0.6))
    p = tt.with_sensitivities(p, tt.systems.crazyflie_sensitivity_tables())
    return tt.with_settings(p, adaptive_rho=True)


@pytest.mark.parametrize("make,x0,suffix", [
    (_soc, (4, 6), "_team_families"),
    (_consensus, (2, 4, 12), "_team_consensus"),
    (_adaptive, (4, 12), "_adaptive")], ids=["soc", "consensus", "adaptive"])
def test_other_problems_keep_the_one_thread_forward_kernel(make, x0, suffix,
                                                          monkeypatch):
    """Families under adaptive rho: every launch on the one-thread entries,
    counted under their own keys, the box team entries never loaded.
    Families at fixed rho (the rocket's cones) take the family team entries
    instead, under backward_team_families / forward_team_families, and
    consensus the consensus team entries, under backward_team_consensus /
    forward_team_consensus; neither takes the one-thread ones."""
    calls = []
    teams = suffix.startswith("_team")
    cons = suffix == "_team_consensus"

    def record(name):
        def entry(*args):
            calls.append(name)
            # the iteration, ct and the flag's places in each forward entry
            at = {"fwd": (5, 6, 22), "team_fwd": (4, 5, 22),
                  "cons_fwd": (4, 5, 22)}.get(name)
            if at and (args[at[0]] + 1) % args[at[1]] == 0:
                ctypes.c_int.from_address(args[at[2]]).value = 0
            return 0
        return entry

    def no_team():
        raise AssertionError("the team entry was loaded")

    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (record("bwd"), record("fwd")))
    monkeypatch.setattr(admm_stream, "_team_fns", no_team)
    monkeypatch.setattr(admm_stream, "_team_families_fns",
                        lambda: (record("team_bwd"), record("team_fwd"))
                        if teams and not cons else no_team())
    monkeypatch.setattr(admm_stream, "_team_consensus_fns",
                        lambda: (record("cons_bwd"), record("cons_fwd"),
                                 lambda *a: True) if cons else no_team())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    prob = make()
    tables, x, _, params = admm_stream._prepare(prob, None, None,
                                                torch.zeros(x0))
    admm_stream._loop(tables, x, None, prob.spec, admm_stream._KERNELS,
                      **params)
    assert calls == (["cons_bwd", "cons_fwd"] if cons else
                     ["team_bwd", "team_fwd"] if teams else
                     ["bwd", "fwd"]) * 2
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        **{"backward" + suffix: 2, "forward" + suffix: 2})


def test_no_new_refusal(entries, monkeypatch):
    """Every box problem the streamed solve took still runs: horizons from
    2 to past the resident wall, batches that leave the last team partial
    or hold a single lane, at (12, 4) and (6, 3), all on the team entry
    (its arithmetic stood in by a recorder here); and so does the rocket
    with its cones, on the family team entry."""
    monkeypatch.setattr(admm_stream, "_team_fns", lambda: (
        entries.backward, lambda *a: (entries.calls.append(("team", a[:4])),
                                      0)[1]))
    monkeypatch.setattr(admm_stream, "_team_families_fns", lambda: (
        None, lambda *a: (entries.calls.append(("team", a[:4])), 0)[1]))
    soc = lambda N, **kw: tt.with_cones(
        _rocket_box(N, **kw), state_cones=[(0, 3, 0.25)],
        input_cones=[(0, 3, 0.5)])
    for make, nx in ((_quad, 12), (_rocket_box, 6), (soc, 6)):
        for N, batches in ((2, (1, 13, 1029)), (3, (7,)), (2048, (1, 13))):
            prob = make(N, max_iter=1, ct=2)
            assert stream_supported(prob)
            for B in batches:
                tables, x0c, _, params = admm_stream._prepare(
                    prob, None, None, torch.zeros((B, nx)))
                run = admm_stream._KERNELS(
                    tables, x0c, admm_stream._init(
                        x0c, N, nx, prob.spec.nu, None, params["fam"]),
                    None, N, nx, prob.spec.nu,
                    **{k: v for k, v in params.items() if k != "max_iter"})
                run.forward(0, False)
                assert entries.calls[-1] == ("team", (nx, prob.spec.nu, N,
                                                      B))
