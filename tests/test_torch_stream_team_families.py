"""The streamed launches of problems with constraint families at fixed rho
on lane teams (csrc/admm_stream_team.cuh with TeamFamilies), emulated on
the CPU in their own layout: a block of TeamShape's lanes, one thread a
(lane, row), thread t holding row t // lanes of lane t % lanes, every dot
summed from zero in column order with a correctly rounded float32 fma.

Backward: each thread adds its row's family terms, rho (slack - dual) in
the order SOC, hyperplane, time-varying hyperplane, to its q or r after
the box term (the terminal p too); p, r and w pass through the lane's slot
in parity halves as in the box kernel. Forward: each running row writes its
candidate x + dual (or u + dual) of each family into the lane's candidate
slot between the step's two barriers; after the second, every thread of
that side reads the whole candidate, projects it with the kernel's
arithmetic (cones in turn from a masked norm, ``sqrt_rn`` and IEEE
quotients; hyperplanes from a dot summed in feature order) and keeps its
own feature's slack and dual; the terminal state row takes one more
exchange after the loop; a warm solve's tracked x/u are stored row by row.

Each emulation is held bitwise against its kernel's plain version
(``stream_backward_reference`` / ``stream_forward_reference``) one launch
at a time -- the rocket's cones at (6, 3); static and time-varying
hyperplanes and all three families mixed at (12, 4); cold, stale, check and
non-check launches, done lanes, a partial last team, the tracked x/u --
whole solves through both emulations bitwise the plain streamed solve, and
one against the JAX package's streamed kernels in interpret mode. The
launch glue is held against stand-ins for the C entries. The CUDA kernels
themselves run on the card only (chip_smoke.py phases 19 and 21)."""
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
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (admm_fused, admm_stream, init_carry,
                                       solve_fused_streamed_reference,
                                       solve_fused_streamed_warm_reference,
                                       stream_supported)
from test_torch_stream_team import (_view, clamp_nan, fma32, max_nan,
                                    sqrt_rn, team_lanes)

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

def _tables(tables, nx, nu, N, fam):
    """The packed table's named parts, as the kernels index them."""
    out, o = {}, 0
    for name, shape in admm_fused._table_layout(nx, nu, N, fam):
        n = math.prod(shape)
        out[name] = tables[o:o + n].reshape(shape)
        o += n
    return out


def _geometry(nblk, lanes, nx, nu):
    """Each thread's row, lane, batch index, side and feature."""
    T = lanes * (nx + nu)
    t = torch.arange(T)
    row, lane = t // lanes, t % lanes
    b = torch.arange(nblk)[:, None] * lanes + lane           # (block, thread)
    st = row < nx
    k = torch.where(st, row, row - nx)
    return T, row, lane, b, st, k


def _side_families(fams, fam):
    """Per side, the (family index, slack, dual) of each family that is on,
    in the kernels' order: SOC, hyperplane, time-varying hyperplane."""
    x = [(f, fams[4 * f], fams[4 * f + 1]) for f in range(3)
         if fam[2 * f]]
    u = [(f, fams[4 * f + 2], fams[4 * f + 3]) for f in range(3)
         if fam[2 * f + 1]]
    return x, u


def project_cones(c, cones):
    """admm_families.cuh's project_cones on the rows of c (M, F): cone k
    sees cone k-1's result; the norm summed from zero over the cone's
    features, the root and the quotients correctly rounded."""
    c = c.clone()
    for k in range(cones.shape[0]):
        s = int(cones[k, 0])
        e = s + int(cones[k, 1]) - 1
        mu = cones[k, 2]
        a2 = torch.zeros(c.shape[0])
        for j in range(s, e):
            a2 = a2 + c[:, j] * c[:, j]
        u0 = c[:, e] * mu
        a = sqrt_rn(a2)
        below = a <= -u0
        change = below | ~(a <= u0)
        safe = torch.where(a > 0, a, torch.ones(()))
        scale = 0.5 * (1.0 + u0 / safe)
        top = scale * (a / mu)
        for j in range(s, e):
            c[:, j] = torch.where(change, torch.where(below, 0.0,
                                                      scale * c[:, j]),
                                  c[:, j])
        c[:, e] = torch.where(change, torch.where(below, 0.0, top), c[:, e])
    return c


def project_hyperplanes(c, A, b, asq):
    """admm_families.cuh's project_hyperplane for each row of A in turn,
    each only where violated: the dot summed in feature order from zero."""
    c = c.clone()
    for a, bk, q in zip(A, b, asq):
        val = torch.zeros(c.shape[0])
        for j in range(c.shape[1]):
            val = val + c[:, j] * a[j]
        dist = (val - bk) / q
        for j in range(c.shape[1]):
            c[:, j] = torch.where(val > bk, c[:, j] - dist * a[j], c[:, j])
    return c


def team_backward(tables, vprev, zprev, g, y, d, done, active, fams, *, N,
                  nx, nu, rho, fam):
    """One launch of stream_backward_team_kernel<nx, nu, TeamFamilies,
    FixedRho>, every thread of every block at once as a (block, thread)
    tensor; writes d of the running lanes in place, zeroes ``active``."""
    B = vprev.shape[2]
    lanes = team_lanes(nx)
    nblk = -(-B // lanes)
    T, row, lane, b, st_row, k = _geometry(nblk, lanes, nx, nu)
    run = (b < B) & ~done[b.clamp(max=B - 1)]
    t = _tables(tables, nx, nu, N, fam)
    kx, ku = k.clamp(max=nx - 1), k.clamp(max=nu - 1)
    cx, cu = torch.arange(nx), torch.arange(nu)
    pick = lambda s, i: torch.where(
        st_row.reshape((-1,) + (1,) * (s.dim() - 1)), s, i)
    mb = t["Mback"][torch.where(st_row, nu + k, k)]
    c1 = pick(t["KinfT"][kx], t["Quu"][ku])
    cst = pick(t["APf"][kx], t["BPf"][ku])
    wq = pick(t["Qd"][kx], t["Rd"][ku]).expand(nblk, T)
    active[0] = 0
    xl = t["Xref"][N - 1]
    pn = torch.zeros(nx)
    for j in range(nx):
        pn = fma32(t["PinfT"][:, j], xl[j], pn)
    pn = -pn
    sm, im = run & st_row, run & ~st_row
    kk = k.expand(nblk, T)
    blk = torch.arange(nblk)[:, None].expand(nblk, T)
    ln = lane.expand(nblk, T)
    P = torch.zeros((nblk, lanes, 2, nx))
    R = torch.zeros((nblk, lanes, 2, nu))
    W = torch.zeros((nblk, lanes, 2, nu))
    xf, uf = _side_families(fams, fam)

    def terms(mask, j, state, q):
        """q (or r) less rho (slack - dual) of each family on the side."""
        ks, bs = kk[mask], b[mask]
        for _, slack, dual in (xf if state else uf):
            q = q - rho * (slack[j, ks, bs] - dual[j, ks, bs])
        return q

    def lin(mask, j, state):
        """Row j's linear cost on the masked threads: box, then families."""
        ks, bs = kk[mask], b[mask]
        slack, dual, ref = ((vprev, g, t["Xref"]) if state
                            else (zprev, y, t["Uref"]))
        q = -(ref[j, ks] * wq[mask]) - rho * (slack[j, ks, bs]
                                              - dual[j, ks, bs])
        return terms(mask, j, state, q)

    def quu(wv):
        acc = torch.zeros((nblk, T))
        for c in range(nu):
            acc = fma32(c1[:, c], wv[..., c], acc)
        return acc

    bs, ks = b[sm], kk[sm]
    pt = pn[ks] - rho * (vprev[N - 1, ks, bs] - g[N - 1, ks, bs])
    P[blk[sm], ln[sm], (N - 1) & 1, ks] = terms(sm, N - 1, True, pt)
    r_own = torch.zeros((nblk, T))
    r_own[im] = lin(im, N - 2, False)
    R[blk[im], ln[im], (N - 2) & 1, kk[im]] = r_own[im]
    for i in range(N - 2, -1, -1):
        # after the step's barrier: p[i+1], r[i], w[i+1] in the slots
        p = P[:, lane, (i + 1) & 1, :]
        acc = torch.zeros((nblk, T))
        for c in range(nx):
            acc = fma32(mb[:, c], p[..., c], acc)
        r = R[:, lane, i & 1, :]
        kr = torch.zeros((nblk, T))
        for c in range(nu):
            kr = fma32(c1[:, c], r[..., c], kr)
        pnew = ((lin(sm, i, True) + acc[sm]) - kr[sm]) \
            + cst.expand(nblk, T)[sm]
        w = (acc + r_own) + cst
        if i + 1 <= N - 2:
            d[i + 1, kk[im], b[im]] = quu(W[:, lane, (i + 1) & 1, :])[im]
        P[blk[sm], ln[sm], i & 1, kk[sm]] = pnew
        W[blk[im], ln[im], i & 1, kk[im]] = w[im]
        if i >= 1:
            r_own[im] = lin(im, i - 1, False)
            R[blk[im], ln[im], (i - 1) & 1, kk[im]] = r_own[im]
    d[0, kk[im], b[im]] = quu(W[:, lane, 0, :])[im]


def team_forward(tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
                 active, fams, x_out=None, u_out=None, *, it, N, nx, nu, ct,
                 rho, tol_pri, tol_dua, fam):
    """One launch of stream_forward_team_kernel<nx, nu, TeamFamilies,
    FixedRho>, every thread of every block at once; reads and writes the
    lane-last arrays in place, the family slacks and duals and the tracked
    ``x_out`` / ``u_out`` too."""
    B = x0.shape[0]
    lanes = team_lanes(nx)
    rows = nx + nu
    nblk = -(-B // lanes)
    T, row, lane, b, st_row, k = _geometry(nblk, lanes, nx, nu)
    run = (b < B) & ~done[b.clamp(max=B - 1)]
    t = _tables(tables, nx, nu, N, fam)
    f1 = t["Mfwd"][torch.where(st_row, nu + k, k)]
    bm = torch.where(st_row[:, None], t["Bm"][k.clamp(max=nx - 1)],
                     torch.zeros(()))
    fv = torch.where(st_row, t["f"][k.clamp(max=nx - 1)], torch.zeros(()))
    checking = (it + 1) % ct == 0
    sm, im = run & st_row, run & ~st_row
    kk = k.expand(nblk, T)
    blk = torch.arange(nblk)[:, None].expand(nblk, T)
    ln = lane.expand(nblk, T)
    pr, du = torch.zeros((nblk, T)), torch.zeros((nblk, T))
    xf, uf = _side_families(fams, fam)
    # The candidate slots: each family's x-sized part, then its u-sized.
    cx = torch.zeros((nblk, lanes, 3, nx))
    cu = torch.zeros((nblk, lanes, 3, nu))

    def project(i, val, mask, lo, hi, dual, slack, prev):
        nonlocal pr, du
        ks, bs = kk[mask], b[mask]
        v = val[mask]
        dn0 = dual[i, ks, bs]
        sn = clamp_nan(v + dn0, lo[i, ks], hi[i, ks])
        dual[i, ks, bs] = dn0 + v - sn
        slack[i, ks, bs] = sn
        if checking:
            pr[mask] = max_nan(pr[mask], (v - sn).abs())
            du[mask] = max_nan(du[mask], (prev[i, ks, bs] - sn).abs())

    def candidates(i, val, mask, state):
        """Each running row's feature of its side's candidates, val +
        the family's dual from before its update, into the lane's slot;
        the tracked x or u of row i."""
        ks, bs = kk[mask], b[mask]
        for f, _, dual in (xf if state else uf):
            (cx if state else cu)[blk[mask], ln[mask], f, ks] = \
                val[mask] + dual[i, ks, bs]
        out = x_out if state else u_out
        if out is not None:
            out[i, ks, bs] = val[mask]

    def family_rows(i, val, mask, state):
        """After the barrier: each running thread of the side reads the
        whole candidate of its lane, projects it and keeps its own
        feature's slack and the dual from the one before its update."""
        ks, bs = kk[mask], b[mask]
        F = nx if state else nu
        for f, slack, dual in (xf if state else uf):
            c = (cx if state else cu)[blk[mask], ln[mask], f]   # (M, F)
            if f == 0:
                c = project_cones(c, t["xcones" if state else "ucones"])
            elif f == 1:
                sfx = "x" if state else "u"
                c = project_hyperplanes(c, t["Alin_" + sfx],
                                        t["blin_" + sfx], t["asq_" + sfx])
            else:
                sfx = "x" if state else "u"
                c = project_hyperplanes(c, t["tv_Alin_" + sfx][i],
                                        t["tv_blin_" + sfx][i],
                                        t["tv_asq_" + sfx][i])
            sn = c.gather(1, ks[:, None])[:, 0]
            assert sn.shape == ks.shape and F == c.shape[1]
            dual[i, ks, bs] = dual[i, ks, bs] + val[mask] - sn
            slack[i, ks, bs] = sn

    state = (t["xmin"], t["xmax"], g, vcur, vd)
    inputs = (t["umin"], t["umax"], y, zcur, zd)
    slot = torch.zeros((nblk, lanes, nx + nu))
    xo = torch.zeros((nblk, T))
    xo[sm] = x0[b[sm], kk[sm]]
    slot[blk[sm], ln[sm], kk[sm]] = xo[sm]
    for i in range(N - 1):
        # after the first barrier: x of step i in the slots
        x = slot[:, lane, :nx]
        a1 = torch.zeros((nblk, T))
        for c in range(nx):
            a1 = fma32(f1[:, c], x[..., c], a1)
        project(i, xo, sm, *state)
        u = torch.zeros((nblk, T))
        u[im] = -a1[im] - d[i, kk[im], b[im]]
        slot[blk[im], ln[im], nx + kk[im]] = u[im]
        project(i, u, im, *inputs)
        candidates(i, xo, sm, True)
        candidates(i, u, im, False)
        # after the second barrier: u and the candidates of step i
        us = slot[:, lane, nx:]
        acc = torch.zeros((nblk, T))
        for c in range(nu):
            acc = fma32(bm[:, c], us[..., c], acc)
        xn = torch.where(sm, (a1 + acc) + fv, xo)
        slot[blk[sm], ln[sm], kk[sm]] = xn[sm]
        family_rows(i, xo, sm, True)
        family_rows(i, u, im, False)
        xo = xn
    project(N - 1, xo, sm, *state)
    # the terminal exchange: a barrier, row N-1's candidates, a barrier
    candidates(N - 1, xo, sm, True)
    family_rows(N - 1, xo, sm, True)
    lead = run & (row == 0)
    bl = b[lead]
    iters[bl] = it + 1
    if not checking:
        return
    red = [v.reshape(nblk, rows, lanes) for v in (pr, du)]
    m = [torch.zeros((nblk, lanes)) for _ in range(4)]   # ps, ds, pi, di
    for r in range(rows):
        side = 0 if r < nx else 2
        m[side] = max_nan(m[side], red[0][:, r])
        m[side + 1] = max_nan(m[side + 1], red[1][:, r])
    ps, ds, pi, di = (v[:, None, :].expand(nblk, rows, lanes)
                      .reshape(nblk, T)[lead] for v in m)
    r2, r3 = ds * rho, di * rho
    res[0, bl], res[1, bl], res[2, bl], res[3, bl] = ps, pi, r2, r3
    ok = (ps < tol_pri) & (pi < tol_pri) & (r2 < tol_dua) & (r3 < tol_dua)
    done[bl[ok]] = True
    if (~ok).any():
        active[0] = 1


class _Teams(admm_stream._PLAIN):
    """Both launches on the emulations, on the working arrays of
    ``admm_stream._init``: the host loop of a family solve on the card, run
    on the CPU."""

    def backward(self, prev):
        s, p = self.s, self.params
        team_backward(self.tables, s["vnew"][prev], s["znew"][prev], s["g"],
                      s["y"], s["d"], s["done"], s["active"], s["fams"],
                      rho=p["rho"], fam=p["fam"], **self.dims)

    def forward(self, it, stale):
        s, cur, p = self.s, it % 2, self.params
        vd, zd = (self.carry.v, self.carry.z) if stale else \
            (s["vnew"][1 - cur], s["znew"][1 - cur])
        s["active"] = torch.zeros(1, dtype=torch.int32)
        team_forward(self.tables, self.x0, vd, zd, s["vnew"][cur],
                     s["znew"][cur], s["g"], s["y"], s["d"], s["iters"],
                     s["done"], s["res"], s["active"], s["fams"], s["x"],
                     s["u"], it=it, ct=p["ct"], rho=p["rho"],
                     tol_pri=p["tol_pri"], tol_dua=p["tol_dua"],
                     fam=p["fam"], **self.dims)


# ------------------------------------------------------------ problems

def _rocket(N, max_iter=60, ct=1):
    """The rocket (6, 3) with its box and cones: chip_smoke.py phase 19's
    problem."""
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device="cpu")
    p = tt.with_bounds(
        p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    p = tt.with_cones(p, state_cones=[(0, 3, 0.25)],
                      input_cones=[(0, 3, 0.5)])
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=2e-3)


def _quad(kind, N, max_iter=60, ct=1):
    """The quadrotor (12, 4): phase 21's static ("linear") or time-varying
    ("tv") planes under low ceilings, box off; or ("mixed") every family
    on both sides with the box: two state cones and one input cone, the
    static planes, two time-varying state planes and one input plane."""
    s = tt.systems.quadrotor_50hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    if kind in ("linear", "mixed"):
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        p = tt.with_linear_constraints(p, Ax, [1.24], np.ones((1, 4)), [6.0])
    if kind == "tv":
        Ax = np.zeros((N, 1, 12))
        Ax[:, 0, 2] = 1.0
        p = tt.with_tv_linear_constraints(
            p, Ax, (1.07 + 0.02 * np.arange(N)).reshape(N, 1),
            np.ones((N - 1, 1, 4)), np.full((N - 1, 1), 6.0))
    if kind == "mixed":
        Ax = np.zeros((N, 2, 12))
        Ax[:, 0, 2] = 1.0
        Ax[:, 1, :2] = 0.5
        bx = np.stack([1.07 + 0.02 * np.arange(N), np.full(N, -1.5)], 1)
        Au = np.ones((N - 1, 1, 4))
        Au[:, 0, 3] = 2.0
        p = tt.with_tv_linear_constraints(p, Ax, bx, Au,
                                          np.full((N - 1, 1), 6.0))
        p = tt.with_cones(p, state_cones=[(3, 3, 0.5), (6, 4, 2.0)],
                          input_cones=[(0, 2, 0.3)])
        p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=3.0)
    else:
        p = tt.with_bounds(p, enable=False)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)


def _inputs(case, N, B, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    if case == "soc":
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
        return (f(XINIT * rng.uniform(0.6, 1.4, (B, 1))),
                f(np.linspace(XINIT, np.zeros(6), N)), f(Uref))
    start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
    a = np.arange(N)[:, None] / 49.0
    Xref = (1 - a) * start + a * np.asarray([2.0, 2.0, 4.0] + [0.0] * 9)
    return f(start + 0.1 * rng.uniform(-1, 1, (B, 12))), f(Xref), None


def _problem(case, N, max_iter=60, ct=1):
    return (_rocket(N, max_iter, ct) if case == "soc"
            else _quad(case, N, max_iter, ct))


CASES = ["soc", "linear", "tv", "mixed"]


def _state(prob, Xref, Uref, x0, iters, carry=None):
    """The working arrays after ``iters`` iterations of the plain host loop
    (and the backward launch of the next one), beside the launcher."""
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
    return tables, x0c, carry_t, s, kw


def _clone(s):
    return {k: ([None if a is None else a.clone() for a in v]
                if isinstance(v, list) else
                v.clone() if torch.is_tensor(v) else v)
            for k, v in s.items()}


def _warm_carry(prob, Xref, Uref, x0):
    """The carry of a short warm solve from a zero carry."""
    return solve_fused_streamed_warm_reference(
        tt.with_settings(prob, max_iter=4), Xref, Uref, x0,
        init_carry(prob, x0.shape[0]))[2]


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", CASES)
def test_backward_emulation_is_bitwise_the_plain_backward_launch(case, warm):
    """One backward launch from a state some iterations in (a warm
    state's first launch), some lanes done, B=13 (a partial last team):
    the emulation writes bitwise the d that stream_backward_reference
    writes, and zeroes the flag."""
    N, B = 12, 13
    prob = _problem(case, N, ct=2)
    x0, Xref, Uref = _inputs(case, N, B, 5)
    carry = _warm_carry(prob, Xref, Uref, x0) if warm else None
    tables, x0c, carry_t, s, kw = _state(prob, Xref, Uref, x0 + 0.01 * warm,
                                         0 if warm else 3, carry)
    s["done"][1::4] = True
    prev = 1 if warm else 0
    spec = prob.spec
    ref = admm_stream.stream_backward_reference(
        tables, s["vnew"][prev], s["znew"][prev], s["g"], s["y"], s["d"],
        s["done"], s["fams"], N=N, nx=spec.nx, nu=spec.nu, rho=kw["rho"],
        fam=kw["fam"])
    em = s["d"].clone()
    active = torch.ones(1, dtype=torch.int32)
    team_backward(tables, s["vnew"][prev], s["znew"][prev], s["g"], s["y"],
                  em, s["done"], active, s["fams"], N=N, nx=spec.nx,
                  nu=spec.nu, rho=kw["rho"], fam=kw["fam"])
    assert torch.equal(em, ref) and int(active[0]) == 0
    assert (em[:, :, ~s["done"]] != s["d"][:, :, ~s["done"]]).any()


@pytest.mark.parametrize("stale,it,ct", [(False, 3, 1), (False, 3, 3),
                                         (True, 0, 1), (True, 0, 2)],
                         ids=["check", "no-check", "stale-check",
                              "stale-no-check"])
@pytest.mark.parametrize("case", CASES)
def test_forward_emulation_is_bitwise_the_plain_forward_launch(case, stale,
                                                               it, ct):
    """One forward launch from a state some iterations in (a warm state's
    first, for the stale launch, with the tracked x/u), some lanes done,
    B=13: the emulation writes bitwise what stream_forward_reference
    writes -- slacks, duals, each family's slack and dual, the tracked x/u,
    iterations, flags, residuals and ``active``."""
    N, B = 12, 13
    prob = _problem(case, N, ct=ct)
    x0, Xref, Uref = _inputs(case, N, B, 5)
    carry = _warm_carry(prob, Xref, Uref, x0) if stale else None
    tables, x0c, carry_t, s, kw = _state(
        prob, Xref, Uref, x0 + 0.01 * stale, it, carry)
    admm_stream._PLAIN(tables, x0c, s, carry_t, N, prob.spec.nx,
                       prob.spec.nu, **kw).backward(1 - it % 2)
    s["done"][1::3] = True
    spec, cur = prob.spec, it % 2
    vd, zd = (carry_t.v, carry_t.z) if stale else (s["vnew"][1 - cur],
                                                   s["znew"][1 - cur])
    assert (s["x"] is not None) == stale
    em = _clone(s)
    ref = admm_stream.stream_forward_reference(
        tables, x0c, s["vnew"][1 - cur], s["znew"][1 - cur], s["vnew"][cur],
        s["znew"][cur], s["g"], s["y"], s["d"], s["iters"], s["done"],
        s["res"], s["fams"], s["x"], s["u"], vstale=vd if stale else None,
        zstale=zd if stale else None, it=it, N=N, nx=spec.nx, nu=spec.nu,
        **kw)
    em["active"] = torch.zeros(1, dtype=torch.int32)
    team_forward(tables, x0c, vd, zd, em["vnew"][cur], em["znew"][cur],
                 em["g"], em["y"], em["d"], em["iters"], em["done"],
                 em["res"], em["active"], em["fams"], em["x"], em["u"],
                 it=it, N=N, nx=spec.nx, nu=spec.nu, ct=kw["ct"],
                 rho=kw["rho"], tol_pri=kw["tol_pri"], tol_dua=kw["tol_dua"],
                 fam=kw["fam"])
    pairs = [(em["vnew"][cur], ref["vcur"]), (em["znew"][cur], ref["zcur"])]
    pairs += [(em[k], ref[k]) for k in ("g", "y", "iters", "done", "res",
                                        "active")]
    pairs += [(a, b) for a, b in zip(em["fams"], ref["fams"])
              if a is not None]
    if stale:
        pairs += [(em["x"], ref["x_out"]), (em["u"], ref["u_out"])]
    for n, (a, b) in enumerate(pairs):
        assert torch.equal(a, b), n
    moved = [not torch.equal(a, b) for a, b in zip(em["fams"], s["fams"])
             if a is not None]
    assert any(moved)


@pytest.mark.parametrize("case", CASES)
def test_solves_through_the_emulations_are_the_plain_solves(case):
    """A cold solve and two warm ones (B=13, ct 2) with both launches on
    the emulations: bitwise the plain streamed solves -- solutions, counts,
    flags, residuals and every field of the carry (the family duals and
    the tracked x/u)."""
    N, B = 10, 13
    prob = _problem(case, N, max_iter=30, ct=2)
    x0, Xref, Uref = _inputs(case, N, B, 7)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_e, res_e = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                                     **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(sol_e, name), getattr(sol_p, name)), name
    assert torch.equal(res_e, res_p)
    c_e = c_p = init_carry(prob, B)
    for step in range(2):
        x = x0 + 0.02 * (step + 1)
        t_, x_, c_t, params = admm_stream._prepare(prob, Xref, Uref, x,
                                                   c_e, True)
        sol_e, res_e, c_e = admm_stream._loop(t_, x_, c_t, prob.spec, _Teams,
                                              **params)
        sol_p, res_p, c_p = solve_fused_streamed_warm_reference(
            prob, Xref, Uref, x, c_p)
        assert torch.equal(sol_e.x, sol_p.x) and torch.equal(res_e, res_p)
        for f in dataclasses.fields(c_p):
            a, b = getattr(c_e, f.name), getattr(c_p, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name


def _jax_problem(case, N, max_iter):
    """The rocket's cones, or phase 21's time-varying planes, in the JAX
    package."""
    if case == "soc":
        s = systems.rocket_landing_20hz()
        p = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                     N=N, f=s["f"], dtype=jnp.float32)
        p = tm.with_bounds(
            p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        p = tm.with_cones(p, state_cones=[(0, 3, 0.25)],
                          input_cones=[(0, 3, 0.5)])
        return tm.with_settings(p, max_iter=max_iter, abs_pri_tol=2e-3)
    s = systems.quadrotor_50hz()
    p = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=jnp.float32)
    Ax = np.zeros((N, 1, 12))
    Ax[:, 0, 2] = 1.0
    p = tm.with_tv_linear_constraints(
        p, tv_Alin_x=Ax, tv_blin_x=(1.07 + 0.02 * np.arange(N))[:, None],
        tv_Alin_u=np.ones((N - 1, 1, 4)),
        tv_blin_u=np.full((N - 1, 1), 6.0))
    p = tm.with_bounds(p, enable=False)
    return tm.with_settings(p, max_iter=max_iter, abs_pri_tol=1e-3,
                            abs_dua_tol=1e-3)


@pytest.mark.parametrize("case", ["soc", "tv"])
def test_solve_through_the_emulations_matches_the_jax_streamed_kernels(case):
    """The rocket's cones (N=16, max_iter 20) and the time-varying planes
    (N=12, max_iter 40), B=8, both launches on the emulations, against the
    JAX streamed kernels in interpret mode at tests/test_torch_stream.py's
    bar (tests/test_stream_kernel.py's): x, u, residuals to 2e-4 (SOC) or
    1e-4, counts within 1, equal flags where the counts agree."""
    N, max_iter, atol = (16, 20, 2e-4) if case == "soc" else (12, 40, 1e-4)
    pj = _jax_problem(case, N, max_iter)
    x0, Xref, Uref = (a if a is None else a.numpy()
                      for a in _inputs(case, N, 8, 3))
    sol_j, res_j = jax_streamed(
        pj, jnp.asarray(Xref), None if Uref is None else jnp.asarray(Uref),
        jnp.asarray(x0), tile=8, chunk=8, interpret=True)
    prob = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    tables, x0c, _, params = admm_stream._prepare(
        prob, torch.as_tensor(Xref), None if Uref is None else
        torch.as_tensor(Uref), torch.as_tensor(x0))
    sol_t, res_t = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                                     **params)[:2]
    it_t, it_j = sol_t.iter.numpy(), np.asarray(sol_j.iter)
    assert np.all(np.abs(it_t - it_j) <= 1), (it_t, it_j)
    for a, b in ((sol_t.x, sol_j.x), (sol_t.u, sol_j.u), (res_t, res_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    same = it_t == it_j
    np.testing.assert_array_equal(sol_t.solved.numpy()[same],
                                  np.asarray(sol_j.solved)[same])


# ------------------------------------------------------------ launch glue

class _Entries:
    """Stand-ins for the C entries of csrc/admm_stream.cu: the family team
    entries run the emulations through the pointers they are given; the
    one-thread and box team entries record their launch (the forward
    leaves the flag at 0); ``fail`` makes a family team entry return a CUDA
    error."""

    def __init__(self):
        self.calls, self.fail = [], None

    @staticmethod
    def _fams(ptrs, counts, nx, nu, N, B):
        """The 12 family arrays behind the kernel's family array."""
        arr = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p))
        out = []
        for k in range(12):
            on = counts[k // 2]
            shape = (N, nx, B) if (k // 2) % 2 == 0 else (N - 1, nu, B)
            out.append(_view(arr[k], shape) if on else None)
        return out

    def team_backward(self, *args):
        assert len(args) == 16
        if self.fail == "backward":
            return 700
        nx, nu, N, B, counts, rho = args[:6]
        tables, vprev, zprev, g, y, d, done, active = args[6:14]
        fam = admm_fused.Families(*counts[:6])
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, fam))
        x, u = (N, nx, B), (N - 1, nu, B)
        team_backward(_view(tables, (ntab,)), _view(vprev, x),
                      _view(zprev, u), _view(g, x), _view(y, u),
                      _view(d, u), _view(done, (B,), torch.bool),
                      _view(active, (1,), torch.int32),
                      self._fams(args[14], fam, nx, nu, N, B), N=N, nx=nx,
                      nu=nu, rho=rho, fam=fam)
        self.calls.append(("team_backward",))
        return 0

    def team_forward(self, *args):
        assert len(args) == 27
        if self.fail == "forward":
            return 700
        nx, nu, N, B, it, ct, counts, rho, tol_pri, tol_dua = args[:10]
        (tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
         active) = args[10:23]
        fam = admm_fused.Families(*counts[:6])
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, fam))
        x, u = (N, nx, B), (N - 1, nu, B)
        xo, uo = args[24:26]
        team_forward(_view(tables, (ntab,)), _view(x0, (B, nx)),
                     _view(vd, x), _view(zd, u), _view(vcur, x),
                     _view(zcur, u), _view(g, x), _view(y, u), _view(d, u),
                     _view(iters, (B,), torch.int32),
                     _view(done, (B,), torch.bool), _view(res, (4, B)),
                     _view(active, (1,), torch.int32),
                     self._fams(args[23], fam, nx, nu, N, B),
                     None if xo is None else _view(xo, x),
                     None if uo is None else _view(uo, u), it=it, N=N,
                     nx=nx, nu=nu, ct=ct, rho=rho, tol_pri=tol_pri,
                     tol_dua=tol_dua, fam=fam)
        self.calls.append(("team_forward", it, xo is not None))
        return 0

    def record(self, name, it_at, active_at):
        def entry(*args):
            self.calls.append((name,))
            if it_at is not None and (args[it_at] + 1) % args[it_at + 1] == 0:
                ctypes.c_int.from_address(args[active_at]).value = 0
            return 0
        return entry


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns", lambda: (
        e.record("backward", None, None), e.record("forward", 5, 22)))
    monkeypatch.setattr(admm_stream, "_team_fns", lambda: (
        e.record("box_backward", None, None), e.record("box_forward", 4, 21)))
    monkeypatch.setattr(admm_stream, "_team_families_fns",
                        lambda: (e.team_backward, e.team_forward))
    monkeypatch.setattr(admm_stream, "_team_consensus_fns", lambda: (
        e.record("consensus_backward", None, None),
        e.record("consensus_forward", 4, 22), lambda *a: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    return e


@pytest.mark.parametrize("case", ["soc", "mixed"])
def test_family_solves_take_the_family_team_entries(case, entries):
    """A problem with families at fixed rho through the kernel launchers,
    cold then warm (B=13, ct 3): both launches of every iteration on the
    family team entries, the warm solve's first forward its stale launch
    with the tracked x/u, counted under backward_team_families /
    forward_team_families / forward_team_families_stale; the results, run
    through the pointers, bitwise the plain streamed solves."""
    N, B = 10, 13
    prob = _problem(case, N, max_iter=12, ct=3)
    x0, Xref, Uref = _inputs(case, N, B, 9)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_k, res_k = admm_stream._loop(tables, x0c, None, prob.spec,
                                     admm_stream._KERNELS, **params)[:2]
    sol_p, res_p = solve_fused_streamed_reference(prob, Xref, Uref, x0)
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(sol_k, name), getattr(sol_p, name)), name
    assert torch.equal(res_k, res_p)
    its = int(sol_k.iter.max())
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        backward_team_families=its, forward_team_families=its)
    assert {c[0] for c in entries.calls} == {"team_backward", "team_forward"}
    carry = _warm_carry(prob, Xref, Uref, x0)
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
    assert admm_stream.launch_counts["forward_team_families_stale"] == 1
    assert ("team_forward", 0, True) in entries.calls


def _adaptive_families():
    p = tt.with_sensitivities(_quad("tv", 8, max_iter=4, ct=2),
                              tt.systems.crazyflie_sensitivity_tables())
    return tt.with_settings(p, adaptive_rho=True)


def _consensus_families():
    return tt.with_consensus(_quad("linear", 8, max_iter=4, ct=2),
                             rho_c=50.0)


@pytest.mark.parametrize("make,x0,suffix", [
    (_adaptive_families, (4, 12), "_adaptive"),
    (_consensus_families, (2, 4, 12), "_team_consensus")],
    ids=["adaptive", "consensus"])
def test_adaptive_families_and_consensus_keep_the_one_thread_entries(
        make, x0, suffix, entries):
    """Families under adaptive rho: every launch on the one-thread entries,
    under their own keys. Families with consensus take the consensus team
    entries (tests/test_torch_stream_team_consensus.py), under
    backward_team_consensus / forward_team_consensus, and not the family
    team entries."""
    prob = make()
    tables, x, _, params = admm_stream._prepare(prob, None, None,
                                                torch.zeros(x0))
    admm_stream._loop(tables, x, None, prob.spec, admm_stream._KERNELS,
                      **params)
    side = ("consensus_backward", "consensus_forward") \
        if suffix == "_team_consensus" else ("backward", "forward")
    assert entries.calls == [(side[0],), (side[1],)] * 2
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        **{"backward" + suffix: 2, "forward" + suffix: 2})


def test_team_false_sends_families_to_the_one_thread_entries(entries):
    """``_KERNELS(..., team=False)`` runs a family problem's launches on the
    one-thread entries (the in-process A/B on the card), counted under the
    one-thread keys."""
    prob = _problem("soc", 8, max_iter=4, ct=2)
    tables, x0c, _, params = admm_stream._prepare(prob, None, None,
                                                  torch.zeros((5, 6)))
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    s = admm_stream._init(x0c, 8, 6, 3, None, params["fam"])
    assert admm_stream._KERNELS(tables, x0c, s, None, 8, 6, 3,
                                **kw).families
    run = admm_stream._KERNELS(tables, x0c, s, None, 8, 6, 3, **kw,
                               team=False)
    assert run.team is None
    run.backward(1)
    run.forward(0, False)
    assert entries.calls == [("backward",), ("forward",)]
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0), backward=1, forward=1)


def test_no_new_refusal_for_the_family_launches(entries):
    """Every family mix the streamed solve took at fixed rho still runs on
    the family team entries: the rocket's cones and the quadrotor's planes
    and mix, horizons from 2 to past the resident wall, batches that leave
    the last team partial or hold a single lane (the entries' arithmetic
    stood in by recorders here)."""
    rec = lambda name: lambda *a: (entries.calls.append((name, a[:4])), 0)[1]
    entries.team_backward, entries.team_forward = (rec("team_backward"),
                                                   rec("team_forward"))
    for case in CASES:
        for N, batches in ((2, (1, 13, 1029)), (3, (7,)), (2048, (1, 13))):
            prob = _problem(case, N, max_iter=1, ct=2)
            assert stream_supported(prob)
            spec = prob.spec
            for B in batches:
                tables, x0c, _, params = admm_stream._prepare(
                    prob, None, None, torch.zeros((B, spec.nx)))
                kw = {k: v for k, v in params.items() if k != "max_iter"}
                run = admm_stream._KERNELS(
                    tables, x0c, admm_stream._init(x0c, N, spec.nx, spec.nu,
                                                   None, params["fam"]),
                    None, N, spec.nx, spec.nu, **kw)
                run.backward(1)
                run.forward(0, False)
                want = (spec.nx, spec.nu, N, B)
                assert entries.calls[-2:] == [("team_backward", want),
                                              ("team_forward", want)]
