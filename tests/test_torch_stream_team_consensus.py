"""The streamed launches of consensus problems at fixed rho on lane teams
(csrc/admm_stream_team.cuh with TeamConsensus), emulated on the CPU in
their own layout: a block of TeamShape's lanes, one thread a (lane, row),
thread t holding row t // lanes of lane t % lanes, every dot summed from
zero in column order with a correctly rounded float32 fma (``fma32``).

Backward: the box kernel's sweep (and the families' terms) with row 0
changed: each input row forms r[0] - rho_c (zc0 - yc0) from its lane's
arrays, and d[0] takes the Quu0_inv row. Forward: the sweep with row 0's
input rows rolling out with the Kinf0 row and parking u[0] in the block's
offer slot (nu, lanes); at the end of the launch every input row of a
running lane puts its offer u[0] + yc0 there, a done lane's its standing
offer, a lane past the batch zero; each running input row sums its group's
G offers in lane order from zero (in its block, or, for G past the block's
lanes, from the blocks of its thread-block cluster, read in cluster-rank
order), divides by G, moves yc0 and zc0, and row 0's thread folds the
lane's |u[0] - zc0| into the convergence gate and stores the offer of a
converging lane. A cluster votes: it leaves at once only when none of its
lanes runs, and a block of it whose lanes are all done still serves its
standing offers.

Each emulation is held bitwise against its kernel's plain version
(``stream_backward_reference`` / ``stream_forward_reference`` with
``cons``) one launch at a time -- cold, stale, check and non-check
launches, done lanes with standing offers, converging lanes storing
theirs; G = 1, 2, 8 in a block and 16, 128 across clusters of 2 and 16
blocks (one block of the cluster wholly done) at (12, 4), and the rocket's
cones at (6, 3) -- whole solves through both emulations bitwise the plain
streamed solve, cold and warm, and one solve against the JAX package's
streamed consensus kernels in interpret mode. The launch glue and the
route are held against stand-ins for the C entries. The CUDA kernels
themselves run on the card only (chip_smoke.py phases 27 and 31)."""
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
                                       solve_fused_streamed_warm_reference)
from test_torch_stream_team import (_view, clamp_nan, fma32, max_nan,
                                    sqrt_rn, team_lanes)
from test_torch_stream_team_families import (_geometry, _side_families,
                                             project_cones,
                                             project_hyperplanes)

torch.set_num_threads(1)

XINIT = np.array([4, 2, 20, -3, 2, -4.5])


@pytest.fixture(autouse=True)
def _rounded_sqrt(monkeypatch):
    """The plain versions' float32 root correctly rounded, as the kernels'
    sqrt_rn is (torch's vectorised CPU root is not always)."""
    raw = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: sqrt_rn(x)
                        if x.dtype == torch.float32 else raw(x, *a, **k))


# ------------------------------------------------------------ the emulation

def _tables(tables, nx, nu, N, fam):
    """The packed table's named parts, the consensus gains last."""
    out, o = {}, 0
    for name, shape in admm_fused._table_layout(nx, nu, N, fam, None, True):
        n = math.prod(shape)
        out[name] = tables[o:o + n].reshape(shape)
        o += n
    return out


def team_backward(tables, vprev, zprev, g, y, d, done, active, fams, zc0,
                  yc0, *, N, nx, nu, rho, rho_c, fam):
    """One launch of stream_backward_team_kernel<nx, nu, Fam, FixedRho,
    TeamConsensus>, every thread of every block at once as a (block,
    thread) tensor; writes d of the running lanes in place, zeroes
    ``active``."""
    B = vprev.shape[2]
    lanes = team_lanes(nx)
    nblk = -(-B // lanes)
    T, row, lane, b, st_row, k = _geometry(nblk, lanes, nx, nu)
    run = (b < B) & ~done[b.clamp(max=B - 1)]
    t = _tables(tables, nx, nu, N, fam)
    kx, ku = k.clamp(max=nx - 1), k.clamp(max=nu - 1)
    pick = lambda s, i: torch.where(
        st_row.reshape((-1,) + (1,) * (s.dim() - 1)), s, i)
    mb = t["Mback"][torch.where(st_row, nu + k, k)]
    c1 = pick(t["KinfT"][kx], t["Quu"][ku])
    q0 = t["Quu0"][ku]                 # an input row's row of Quu0_inv
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
    # Each running input row's prox term of r[0], read before the loop.
    cterm = torch.zeros((nblk, T))
    cterm[im] = rho_c * (zc0[kk[im], b[im]] - yc0[kk[im], b[im]])

    def terms(mask, j, state, q):
        ks, bs = kk[mask], b[mask]
        for _, slack, dual in (xf if state else uf):
            q = q - rho * (slack[j, ks, bs] - dual[j, ks, bs])
        return q

    def lin(mask, j, state):
        ks, bs = kk[mask], b[mask]
        slack, dual, ref = ((vprev, g, t["Xref"]) if state
                            else (zprev, y, t["Uref"]))
        q = -(ref[j, ks] * wq[mask]) - rho * (slack[j, ks, bs]
                                              - dual[j, ks, bs])
        q = terms(mask, j, state, q)
        return q - cterm[mask] if not state and j == 0 else q

    def dot(rows, wv):
        acc = torch.zeros((nblk, T))
        for c in range(nu):
            acc = fma32(rows[:, c], wv[..., c], acc)
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
        kr = dot(c1, R[:, lane, i & 1, :])
        pnew = ((lin(sm, i, True) + acc[sm]) - kr[sm]) \
            + cst.expand(nblk, T)[sm]
        w = (acc + r_own) + cst
        if i + 1 <= N - 2:
            d[i + 1, kk[im], b[im]] = dot(c1, W[:, lane, (i + 1) & 1, :])[im]
        P[blk[sm], ln[sm], i & 1, kk[sm]] = pnew
        W[blk[im], ln[im], i & 1, kk[im]] = w[im]
        if i >= 1:
            r_own[im] = lin(im, i - 1, False)
            R[blk[im], ln[im], (i - 1) & 1, kk[im]] = r_own[im]
    d[0, kk[im], b[im]] = dot(q0, W[:, lane, 0, :])[im]


def team_forward(tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
                 active, fams, zc0, yc0, offer, x_out=None, u_out=None, *,
                 it, N, nx, nu, ct, rho, tol_pri, tol_dua, fam, group):
    """One launch of stream_forward_team_kernel<nx, nu, Fam, FixedRho,
    TeamConsensus> on groups of ``group`` lanes, every thread of every
    block at once; reads and writes the lane-last arrays in place: the
    slacks and duals, the family slacks and duals, zc0 / yc0 of the running
    lanes, the standing offer of a converging one and the tracked
    ``x_out`` / ``u_out``."""
    B = x0.shape[0]
    lanes = team_lanes(nx)
    rows = nx + nu
    nblk = -(-B // lanes)
    T, row, lane, b, st_row, k = _geometry(nblk, lanes, nx, nu)
    t = _tables(tables, nx, nu, N, fam)
    # The vote: a cluster leaves at once when none of its lanes runs.
    cluster = admm_stream.team_cluster(group, lanes)
    run = (b < B) & ~done[b.clamp(max=B - 1)]
    votes = torch.zeros(-(-nblk // cluster) * cluster, dtype=torch.bool)
    votes[:nblk] = run.any(1)
    alive = votes.reshape(-1, cluster).any(1).repeat_interleave(
        cluster)[:nblk]
    f1 = t["Mfwd"][torch.where(st_row, nu + k, k)]
    k0 = t["Kinf0"][k.clamp(max=nu - 1)]   # an input row's row of Kinf0
    bm = torch.where(st_row[:, None], t["Bm"][k.clamp(max=nx - 1)],
                     torch.zeros(()))
    fv = torch.where(st_row, t["f"][k.clamp(max=nx - 1)], torch.zeros(()))
    checking = (it + 1) % ct == 0
    sm, im = run & st_row, run & ~st_row
    kk = k.expand(nblk, T)
    ku = kk.clamp(max=nu - 1)
    blk = torch.arange(nblk)[:, None].expand(nblk, T)
    ln = lane.expand(nblk, T)
    pr, du = torch.zeros((nblk, T)), torch.zeros((nblk, T))
    xf, uf = _side_families(fams, fam)
    cx = torch.zeros((nblk, lanes, 3, nx))
    cu = torch.zeros((nblk, lanes, 3, nu))
    offers = torch.zeros((nblk, nu, lanes))   # each block's offer slot

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
        ks, bs = kk[mask], b[mask]
        for f, _, dual in (xf if state else uf):
            (cx if state else cu)[blk[mask], ln[mask], f, ks] = \
                val[mask] + dual[i, ks, bs]
        out = x_out if state else u_out
        if out is not None:
            out[i, ks, bs] = val[mask]

    def family_rows(i, val, mask, state):
        ks, bs = kk[mask], b[mask]
        sfx = "x" if state else "u"
        for f, slack, dual in (xf if state else uf):
            c = (cx if state else cu)[blk[mask], ln[mask], f]
            if f == 0:
                c = project_cones(c, t[sfx + "cones"])
            elif f == 1:
                c = project_hyperplanes(c, t["Alin_" + sfx],
                                        t["blin_" + sfx], t["asq_" + sfx])
            else:
                c = project_hyperplanes(c, t["tv_Alin_" + sfx][i],
                                        t["tv_blin_" + sfx][i],
                                        t["tv_asq_" + sfx][i])
            sn = c.gather(1, ks[:, None])[:, 0]
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
        kx = a1
        if i == 0:
            # row 0's input rows roll out with Kinf0
            kx = torch.zeros((nblk, T))
            for c in range(nx):
                kx = fma32(k0[:, c], x[..., c], kx)
        project(i, xo, sm, *state)
        u = torch.zeros((nblk, T))
        u[im] = -kx[im] - d[i, kk[im], b[im]]
        slot[blk[im], ln[im], nx + kk[im]] = u[im]
        if i == 0:
            offers[blk[im], kk[im], ln[im]] = u[im]   # u[0], parked
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
    candidates(N - 1, xo, sm, True)
    family_rows(N - 1, xo, sm, True)

    # The exchange. Every input row of a block that has not left puts its
    # lane's offer into the block's slot: u[0] + yc0 running, the standing
    # offer done, zero past the batch.
    serve = ~st_row & alive[:, None]
    u0 = offers[blk, ku, ln]
    held = serve & ~run & (b < B)
    past = serve & (b >= B)
    offers[blk[im], kk[im], ln[im]] = u0[im] + yc0[kk[im], b[im]]
    offers[blk[held], kk[held], ln[held]] = offer[kk[held], b[held]]
    offers[blk[past], kk[past], ln[past]] = 0.0
    # (A) a barrier of the block or the cluster; (R) each running input row
    # sums its group's offers in lane order from zero: in its block, or
    # from each block of its cluster in rank order.
    total = torch.zeros((nblk, T))
    if cluster > 1:
        mates = [offers[(blk // cluster) * cluster + q, ku]
                 for q in range(cluster)]                # (nblk, T, lanes)
        for q in range(cluster):
            for j in range(lanes):
                total = total + mates[q][..., j]
    else:
        first = ln & ~(group - 1)
        for j in range(group):
            total = total + offers[blk, ku, first + j]
    z = total / group
    cres = torch.zeros((nblk, T))
    yc_old = yc0[kk[im], b[im]]
    yc0[kk[im], b[im]] = yc_old + u0[im] - z[im]
    zc0[kk[im], b[im]] = z[im]
    cres[im] = (u0[im] - z[im]).abs()
    # (E) a barrier; row 0's thread of each running lane: the bookkeeping.
    lead = run & (row == 0)
    bl = b[lead]
    iters[bl] = it + 1
    if not checking:
        return
    team = lambda v: v.reshape(nblk, rows, lanes)
    red = [team(r) for r in (pr, du)]
    m = [torch.zeros((nblk, lanes)) for _ in range(4)]   # ps, ds, pi, di
    c = torch.zeros((nblk, lanes))
    for r in range(rows):
        side = 0 if r < nx else 2
        m[side] = max_nan(m[side], red[0][:, r])
        m[side + 1] = max_nan(m[side + 1], red[1][:, r])
        if r >= nx:
            c = max_nan(c, team(cres)[:, r])
    at_lead = lambda v: v[:, None, :].expand(nblk, rows, lanes).reshape(
        nblk, T)[lead]
    ps, ds, pi, di = (at_lead(v) for v in m)
    r2, r3 = ds * rho, di * rho
    res[0, bl], res[1, bl], res[2, bl], res[3, bl] = ps, pi, r2, r3
    ok = (ps < tol_pri) & (pi < tol_pri) & (r2 < tol_dua) & (r3 < tol_dua) \
        & (at_lead(c) < tol_pri)
    done[bl[ok]] = True
    # the offer of the converging iteration, from the slot, then stands
    offer[:, bl[ok]] = offers[blk[lead][ok], :, ln[lead][ok]].T
    if (~ok).any():
        active[0] = 1


class _Teams(admm_stream._PLAIN):
    """Both launches on the emulations, on the working arrays of
    ``admm_stream._init``: the host loop of a consensus solve on the card,
    run on the CPU."""

    def backward(self, prev):
        s, p = self.s, self.params
        team_backward(self.tables, s["vnew"][prev], s["znew"][prev], s["g"],
                      s["y"], s["d"], s["done"], s["active"], s["fams"],
                      s["zc0"], s["yc0"], rho=p["rho"],
                      rho_c=p["cons"].rho_c, fam=p["fam"], **self.dims)

    def forward(self, it, stale):
        s, cur, p = self.s, it % 2, self.params
        vd, zd = (self.carry.v, self.carry.z) if stale else \
            (s["vnew"][1 - cur], s["znew"][1 - cur])
        s["active"] = torch.zeros(1, dtype=torch.int32)
        team_forward(self.tables, self.x0, vd, zd, s["vnew"][cur],
                     s["znew"][cur], s["g"], s["y"], s["d"], s["iters"],
                     s["done"], s["res"], s["active"], s["fams"], s["zc0"],
                     s["yc0"], s["offer"], s["x"], s["u"], it=it, ct=p["ct"],
                     rho=p["rho"], tol_pri=p["tol_pri"],
                     tol_dua=p["tol_dua"], fam=p["fam"],
                     group=p["cons"].group, **self.dims)


# ------------------------------------------------------------ problems

def _quad(N, max_iter=60, ct=1, rho_c=100.0):
    """The quadrotor's box with consensus at rho_c (none for None)."""
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    p = tt.with_settings(p, max_iter=max_iter, check_termination=ct)
    return p if rho_c is None else tt.with_consensus(p, rho_c=rho_c)


def _rocket(N, max_iter=60, ct=1, rho_c=100.0):
    """The rocket's cones (6, 3) with consensus."""
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device="cpu")
    p = tt.with_bounds(
        p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    p = tt.with_cones(p, state_cones=[(0, 3, 0.25)],
                      input_cones=[(0, 3, 0.5)])
    p = tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                         abs_pri_tol=2e-3)
    return tt.with_consensus(p, rho_c=rho_c)


PROBLEMS = {"box": _quad, "rocket": _rocket}


def _inputs(case, N, ng, G, seed):
    """x0s (ng, G, nx): a nominal start per group plus small branches; the
    reference (and the rocket's Uref)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    if case == "rocket":
        x0 = XINIT * (1 + 0.1 * rng.uniform(-1, 1, (ng, G, 6)))
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
        return f(x0), f(np.linspace(XINIT, np.zeros(6), N)), f(Uref)
    x0 = rng.uniform(-0.3, 0.3, (ng, 1, 12)) \
        + 0.05 * rng.uniform(-1, 1, (ng, G, 12))
    return f(x0), f(np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1))), None


def _state(prob, Xref, Uref, x0, iters, carry=None):
    """The working arrays after ``iters`` iterations of the plain host
    loop, and the launch parameters."""
    warm = carry is not None
    tables, x0c, carry_t, params = admm_stream._prepare(prob, Xref, Uref, x0,
                                                        carry, warm)
    spec = prob.spec
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    s = admm_stream._init(x0c, spec.N, spec.nx, spec.nu, carry_t,
                          params["fam"], params["cons"])
    run = admm_stream._PLAIN(tables, x0c, s, carry_t, spec.N, spec.nx,
                             spec.nu, **kw)
    for it in range(iters):
        run.backward(1 - it % 2)
        run.forward(it, warm and it == 0)
    return tables, x0c, carry_t, s, kw


def _clone(s):
    return {k: v.clone() if torch.is_tensor(v) else
            [a if a is None else a.clone() for a in v] if isinstance(v, list)
            else v for k, v in s.items()}


def _freeze(s, B, G, lanes):
    """Lanes that converged earlier, each with a standing offer: every
    third lane, and, where a group spans a cluster, the whole second block
    of each cluster."""
    done = torch.zeros(B, dtype=torch.bool)
    done[1::3] = True
    if G > lanes:
        for c in range(B // G):
            done[c * G + lanes:c * G + 2 * lanes] = True
    s["done"] |= done
    gen = torch.Generator().manual_seed(B + G)
    s["offer"][:, done] = torch.rand((s["offer"].shape[0], int(done.sum())),
                                     generator=gen) - 0.5
    return done


# (case, groups, G): in a block at (12, 4) -- G = 1, 2 (a partial last
# block) and 8 -- across clusters of 2 and 16 blocks; the rocket's cones at
# (6, 3), 16 lanes a block, in a block and across a cluster of 2.
LAUNCH_CASES = [("box", 13, 1), ("box", 13, 2), ("box", 3, 8),
                ("box", 2, 16), ("box", 2, 128), ("rocket", 3, 8),
                ("rocket", 2, 32)]
CASE_IDS = [f"{c}-{ng}x{G}" for c, ng, G in LAUNCH_CASES]


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("case,ng,G", LAUNCH_CASES, ids=CASE_IDS)
def test_backward_emulation_is_bitwise_the_plain_launch(case, ng, G):
    """One backward launch from a state two iterations in, some lanes done
    (a whole block of each cluster): the emulation writes bitwise what
    stream_backward_reference writes, r[0]'s prox term and the Quu0_inv row
    included."""
    N = 8
    prob = PROBLEMS[case](N)
    x0, Xref, Uref = _inputs(case, N, ng, G, 3)
    tables, x0c, _, s, kw = _state(prob, Xref, Uref, x0, 2)
    spec, B = prob.spec, ng * G
    _freeze(s, B, G, team_lanes(spec.nx))
    assert (s["zc0"] != s["yc0"]).any()
    ref = admm_stream.stream_backward_reference(
        tables, s["vnew"][1], s["znew"][1], s["g"], s["y"], s["d"],
        s["done"], s["fams"], s["zc0"], s["yc0"], N=N, nx=spec.nx,
        nu=spec.nu, rho=kw["rho"], fam=kw["fam"], cons=kw["cons"])
    d = s["d"].clone()
    active = torch.ones(1, dtype=torch.int32)
    team_backward(tables, s["vnew"][1], s["znew"][1], s["g"], s["y"], d,
                  s["done"], active, s["fams"], s["zc0"], s["yc0"], N=N,
                  nx=spec.nx, nu=spec.nu, rho=kw["rho"],
                  rho_c=kw["cons"].rho_c, fam=kw["fam"])
    assert torch.equal(d, ref) and active.item() == 0
    assert not torch.equal(d[0], s["d"][0])


@pytest.mark.parametrize("launch", ["check", "no-check", "stale",
                                    "converge"])
@pytest.mark.parametrize("case,ng,G", LAUNCH_CASES, ids=CASE_IDS)
def test_forward_emulation_is_bitwise_the_plain_launch(case, ng, G, launch):
    """One forward launch -- a check launch, a non-check one (ct 2), the
    stale launch of a warm solve, and a check launch at tolerances every
    running lane meets -- from a state some iterations in, lanes done with
    standing offers (a whole block of each cluster): the emulation writes
    bitwise what stream_forward_reference writes -- slacks, duals, family
    slacks and duals, the tracked x/u, zc0, yc0, the offers stored,
    iterations, flags, residuals and ``active``."""
    N = 8
    ct = 2 if launch == "no-check" else 1
    prob = PROBLEMS[case](N, ct=ct)
    x0, Xref, Uref = _inputs(case, N, ng, G, 5)
    spec, B = prob.spec, ng * G
    carry, it = None, 3 if launch == "no-check" else 2
    if launch == "stale":
        carry = solve_fused_streamed_warm_reference(
            tt.with_settings(prob, max_iter=4), Xref, Uref, x0,
            init_carry(prob, B))[2]
        x0, it = x0 + 0.01, 0
    tables, x0c, carry_t, s, kw = _state(prob, Xref, Uref, x0, it, carry)
    _freeze(s, B, G, team_lanes(spec.nx))
    if launch == "converge":
        kw.update(tol_pri=1e6, tol_dua=1e6)
    s["d"] = admm_stream.stream_backward_reference(
        tables, s["vnew"][1 - it % 2], s["znew"][1 - it % 2], s["g"], s["y"],
        s["d"], s["done"], s["fams"], s["zc0"], s["yc0"], N=N, nx=spec.nx,
        nu=spec.nu, rho=kw["rho"], fam=kw["fam"], cons=kw["cons"])
    cur = it % 2
    stale = launch == "stale"
    vd, zd = (carry_t.v, carry_t.z) if stale else (s["vnew"][1 - cur],
                                                   s["znew"][1 - cur])
    ref = admm_stream.stream_forward_reference(
        tables, x0c, s["vnew"][1 - cur], s["znew"][1 - cur], s["vnew"][cur],
        s["znew"][cur], s["g"], s["y"], s["d"], s["iters"], s["done"],
        s["res"], s["fams"], s["x"], s["u"], vd if stale else None,
        zd if stale else None, s["zc0"], s["yc0"], s["offer"], it=it, N=N,
        nx=spec.nx, nu=spec.nu, **kw)
    em = _clone(s)
    em["active"] = torch.zeros(1, dtype=torch.int32)
    team_forward(tables, x0c, vd, zd, em["vnew"][cur], em["znew"][cur],
                 em["g"], em["y"], s["d"], em["iters"], em["done"],
                 em["res"], em["active"], em["fams"], em["zc0"], em["yc0"],
                 em["offer"], em["x"], em["u"], it=it, N=N, nx=spec.nx,
                 nu=spec.nu, ct=kw["ct"], rho=kw["rho"],
                 tol_pri=kw["tol_pri"], tol_dua=kw["tol_dua"],
                 fam=kw["fam"], group=G)
    got = dict(vcur=em["vnew"][cur], zcur=em["znew"][cur], x_out=em["x"],
               u_out=em["u"], **{k: em[k] for k in (
                   "g", "y", "iters", "done", "res", "active", "zc0", "yc0",
                   "offer")})
    for name, a in got.items():
        b = ref[name]
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    for a, b in zip(em["fams"], ref["fams"]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert stale == (em["x"] is not None)
    newly = em["done"] & ~s["done"]
    if launch == "converge":
        assert bool(em["done"].all())
        assert not torch.equal(em["offer"][:, newly], s["offer"][:, newly])
    else:
        assert not newly.any()
    frozen = s["done"]
    assert torch.equal(em["offer"][:, frozen], s["offer"][:, frozen])
    assert torch.equal(em["zc0"][:, frozen], s["zc0"][:, frozen])


@pytest.mark.parametrize("case,ng,G", [("box", 4, 16), ("box", 2, 128),
                                       ("rocket", 4, 32)],
                         ids=["box-4x16", "box-2x128", "rocket-4x32"])
def test_solve_through_the_emulations_is_the_plain_solve(case, ng, G):
    """Whole streamed consensus solves with both launches on the
    emulations, cold and then two warm (the first launch of each stale),
    ct 2, across clusters of 2 and 16 blocks: bitwise the plain streamed
    solve -- solutions, counts, flags, residuals and every carry field,
    zc0 / yc0 and the tracked x/u included."""
    N = 8
    prob = PROBLEMS[case](N, max_iter=24, ct=2)
    x0, Xref, Uref = _inputs(case, N, ng, G, 7)
    tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
    sol_e, res_e = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                                     **params)[:2]
    sol_p, res_p = admm_stream._loop(tables, x0c, None, prob.spec,
                                     admm_stream._PLAIN, **params)[:2]
    for name in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(sol_e, name), getattr(sol_p, name)), name
    assert torch.equal(res_e, res_p)
    c_e = c_p = init_carry(prob, ng * G)
    for step in range(2):
        x0 = x0 + 0.01
        t_, x_, ce_t, params = admm_stream._prepare(prob, Xref, Uref, x0,
                                                    c_e, True)
        out_e = admm_stream._loop(t_, x_, ce_t, prob.spec, _Teams, **params)
        out_p = solve_fused_streamed_warm_reference(prob, Xref, Uref, x0, c_p)
        assert torch.equal(out_e[0].x, out_p[0].x.reshape(out_e[0].x.shape))
        assert torch.equal(out_e[1], out_p[1].reshape(out_e[1].shape))
        for f in dataclasses.fields(out_p[2]):
            a, b = getattr(out_e[2], f.name), getattr(out_p[2], f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name
        assert out_e[2].zc0 is not None and out_e[2].u is not None
        c_e, c_p = out_e[2], out_p[2]


def test_solve_through_the_emulations_matches_the_jax_streamed_kernels():
    """tests/test_torch_stream_consensus.py's cold case (2 groups of 4, the
    default rho_c) at N=12, max_iter 40, with both launches on the
    emulations, against the JAX package's streamed consensus kernels in
    interpret mode at that file's float32 bar: x and u within 2e-4, counts
    within 1."""
    ng, G, N = 2, 4, 12
    s = systems.quadrotor_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    pj = tm.with_consensus(tm.with_settings(pj, max_iter=40))
    x0 = np.random.default_rng(7).uniform(-0.3, 0.3, (ng, G, 12)).astype(
        np.float32)
    Xref = np.tile(np.asarray([0, 0, 0.5] + [0.0] * 9, np.float32), (N, 1))
    sol_j, _ = jax_streamed(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                            tile=ng * G, chunk=4, interpret=True)
    prob = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    tables, x0c, _, params = admm_stream._prepare(
        prob, torch.as_tensor(Xref), None, torch.as_tensor(x0))
    sol, _ = admm_stream._loop(tables, x0c, None, prob.spec, _Teams,
                               **params)[:2]
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(sol_j.x).reshape(
        N, ng * G, 12), atol=2e-4)
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(sol_j.u).reshape(
        N - 1, ng * G, 4), atol=2e-4)
    assert np.all(np.abs(sol.iter.numpy()
                         - np.asarray(sol_j.iter).reshape(-1)) <= 1)


def test_route_and_clusters():
    """The lanes of a block and the cluster of a group: (12, 4) 8 lanes, so
    G = 16 and 128 are clusters of 2 and 16 blocks; (6, 3) 16 lanes, so
    G = 16 lies in a block and 128 is a cluster of 8. A cluster past
    TEAM_MAX_CLUSTER blocks, or one the card cannot hold, takes the
    one-thread kernels (None); a group in a block never asks the card."""
    assert (team_lanes(12), team_lanes(6)) == (8, 16)
    assert admm_stream.team_lanes(12) == 8 and admm_stream.team_lanes(6) == 16
    route = admm_stream.team_consensus_route
    asked = []

    def fits(c):
        asked.append(c)
        return c <= 8

    assert [route(G, 12) for G in (1, 2, 8, 16, 32, 128)] == \
        [1, 1, 1, 2, 4, 16]
    assert [route(G, 6) for G in (1, 16, 32, 128)] == [1, 1, 2, 8]
    assert route(8, 12, fits) == 1 and asked == []
    assert route(64, 12, fits) == 8 and route(128, 12, fits) is None
    assert asked == [8, 16]
    assert route(256, 12) is None         # 32 blocks: past the largest
    assert admm_stream.TEAM_MAX_CLUSTER == 16


# ------------------------------------------------------------ launch glue

class _Entries:
    """Stand-ins for the C entries of csrc/admm_stream.cu. The team
    consensus entries run the emulations through the pointers they are
    given; the one-thread entries record their launch and leave the flag at
    0; ``fits`` answers the occupancy query."""

    def __init__(self):
        self.calls = []
        self.fit = True

    @staticmethod
    def _cons(arg):
        c = ctypes.cast(arg, ctypes.POINTER(admm_stream._StreamConsensus))[0]
        return c

    def team_backward(self, *args):
        assert len(args) == 17
        nx, nu, N, B, counts, rho = args[:6]
        tables, vprev, zprev, g, y, d, done, active = args[6:14]
        assert all(p is None for p in args[14])       # a box problem
        c = self._cons(args[15])
        fam = admm_fused.Families(*counts)
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, fam, None, True))
        x, u, l = (N, nx, B), (N - 1, nu, B), (nu, B)
        team_backward(_view(tables, (ntab,)), _view(vprev, x),
                      _view(zprev, u), _view(g, x), _view(y, u),
                      _view(d, u), _view(done, (B,), torch.bool),
                      _view(active, (1,), torch.int32), [None] * 12,
                      _view(c.zc0, l), _view(c.yc0, l), N=N, nx=nx, nu=nu,
                      rho=rho, rho_c=c.rho_c, fam=fam)
        self.calls.append(("team_backward", c.group))
        return 0

    def team_forward(self, *args):
        assert len(args) == 28
        nx, nu, N, B, it, ct, counts, rho, tol_pri, tol_dua = args[:10]
        (tables, x0, vd, zd, vcur, zcur, g, y, d, iters, done, res,
         active) = args[10:23]
        assert all(p is None for p in args[23])
        x_out, u_out = args[24:26]
        c = self._cons(args[26])
        fam = admm_fused.Families(*counts)
        ntab = sum(math.prod(s) for _, s in admm_fused._table_layout(
            nx, nu, N, fam, None, True))
        x, u, l = (N, nx, B), (N - 1, nu, B), (nu, B)
        team_forward(_view(tables, (ntab,)), _view(x0, (B, nx)), _view(vd, x),
                     _view(zd, u), _view(vcur, x), _view(zcur, u),
                     _view(g, x), _view(y, u), _view(d, u),
                     _view(iters, (B,), torch.int32),
                     _view(done, (B,), torch.bool), _view(res, (4, B)),
                     _view(active, (1,), torch.int32), [None] * 12,
                     _view(c.zc0, l), _view(c.yc0, l), _view(c.offer, l),
                     None if x_out is None else _view(x_out, x),
                     None if u_out is None else _view(u_out, u), it=it, N=N,
                     nx=nx, nu=nu, ct=ct, rho=rho, tol_pri=tol_pri,
                     tol_dua=tol_dua, fam=fam, group=c.group)
        self.calls.append(("team_forward", it, x_out is not None))
        return 0

    def fits(self, nx, nu, counts, cluster):
        self.calls.append(("fits", cluster))
        return self.fit

    def record(self, name, it_at=None, active_at=None):
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
        e.record("backward"), e.record("forward", 5, 22)))
    monkeypatch.setattr(admm_stream, "_team_fns", lambda: (
        e.record("box_backward"), e.record("box_forward", 4, 21)))
    monkeypatch.setattr(admm_stream, "_team_families_fns", lambda: (
        e.record("families_backward"), e.record("families_forward", 4, 22)))
    monkeypatch.setattr(admm_stream, "_team_consensus_fns", lambda: (
        e.team_backward, e.team_forward, e.fits))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    return e


def _drive(prob, x0, Xref=None, Uref=None, carry=None, launcher=None):
    tables, x, c_t, params = admm_stream._prepare(prob, Xref, Uref, x0,
                                                  carry, carry is not None)
    return admm_stream._loop(tables, x, c_t, prob.spec,
                             launcher or admm_stream._KERNELS, **params)


@pytest.mark.parametrize("ng,G", [(4, 8), (2, 16), (1, 128)],
                         ids=["block", "cluster-2", "cluster-16"])
def test_consensus_solves_take_the_team_entries(ng, G, entries):
    """A box consensus problem through the kernel launchers, cold then warm
    (N=8, ct 2): every launch on the team consensus entries, counted under
    backward_team_consensus / forward_team_consensus /
    forward_team_consensus_stale (the warm solve's first forward), the warm
    solve's x/u tracked, the card asked only for a cluster; the results,
    run through the pointers, bitwise the plain streamed solve."""
    N = 8
    prob = _quad(N, max_iter=30, ct=2)
    x0, Xref, _ = _inputs("box", N, ng, G, 9)
    cold = _drive(prob, x0, Xref)
    want = solve_fused_streamed_reference(prob, Xref, None, x0)
    assert torch.equal(cold[0].x, want[0].x.reshape(cold[0].x.shape))
    assert torch.equal(cold[0].iter, want[0].iter.reshape(-1))
    its = int(cold[0].iter.max())
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        backward_team_consensus=its, forward_team_consensus=its)
    assert [c for c in entries.calls if c[0] == "fits"] == (
        [("fits", G // 8)] if G > 8 else [])
    carry = solve_fused_streamed_warm_reference(prob, Xref, None, x0,
                                                init_carry(prob, ng * G))[2]
    warm = _drive(prob, x0 + 0.01, Xref, carry=carry)
    want = solve_fused_streamed_warm_reference(prob, Xref, None, x0 + 0.01,
                                               carry)
    assert torch.equal(warm[0].u, want[0].u.reshape(warm[0].u.shape))
    for name in ("zc0", "yc0", "x", "u", "v", "g"):
        assert torch.equal(getattr(warm[2], name), getattr(want[2], name))
    assert admm_stream.launch_counts["forward_team_consensus_stale"] == 1
    assert ("team_forward", 0, True) in entries.calls
    assert not any(c[0] in ("backward", "forward") for c in entries.calls)


def _ceiling(rho_c=100.0):
    """The quadrotor with a time-varying z ceiling, with consensus at rho_c
    (none for None)."""
    N = 8
    a = np.zeros((N, 1, 12))
    a[:, 0, 2] = 1.0
    return tt.with_tv_linear_constraints(
        _quad(N, max_iter=4, ct=2, rho_c=rho_c), a, np.full((N, 1), 0.6))


def _adaptive_families():
    p = tt.with_sensitivities(_ceiling(None),
                              tt.systems.crazyflie_sensitivity_tables())
    return tt.with_settings(p, adaptive_rho=True)


def _recorder(calls, name, fam_at, it_at=None, active_at=None):
    """A stand-in C entry that records how many family arrays it was given
    and, on a check iteration, leaves 0 in the flag."""
    def entry(*args):
        calls.append((name, sum(p is not None for p in args[fam_at])))
        if it_at is not None and (args[it_at] + 1) % args[it_at + 1] == 0:
            ctypes.c_int.from_address(args[active_at]).value = 0
        return 0
    return entry


@pytest.mark.parametrize("how", ["team=False", "too large", "no fit",
                                 "families", "adaptive families"])
def test_the_route_of_other_launches(how, entries, monkeypatch):
    """Where each launch goes: ``team=False`` (the in-process A/B), a
    cluster past TEAM_MAX_CLUSTER blocks and one the card cannot hold take
    the one-thread consensus entries, counted under their own keys, never
    after a failed launch; consensus with a family takes the team consensus
    entries (the family arrays passed); families under adaptive rho stay
    on the one-thread adaptive entries."""
    x0 = torch.zeros((1, 128, 12))
    prob, launcher, keys = _quad(8, max_iter=4, ct=2), None, "_consensus"
    if how == "team=False":
        launcher = functools.partial(admm_stream._KERNELS, team=False)
    elif how == "too large":
        monkeypatch.setattr(admm_stream, "TEAM_MAX_CLUSTER", 8)
    elif how == "no fit":
        entries.fit = False
    elif how == "families":
        prob, x0, keys = _ceiling(), torch.zeros((2, 4, 12)), None
        recorded = []
        monkeypatch.setattr(admm_stream, "_team_consensus_fns", lambda: (
            _recorder(recorded, "b", 14), _recorder(recorded, "f", 23, 4, 22),
            entries.fits))
    else:
        prob, x0, keys = _adaptive_families(), torch.zeros((4, 12)), \
            "_adaptive"
    _drive(prob, x0, launcher=launcher)
    counts = {k: v for k, v in admm_stream.launch_counts.items() if v}
    if keys is None:
        assert counts == {"backward_team_consensus": 2,
                          "forward_team_consensus": 2}
        assert recorded == [("b", 2), ("f", 2)] * 2   # vtv, gtv
        return
    assert counts == {"backward" + keys: 2, "forward" + keys: 2}
    assert [c[0] for c in entries.calls if c[0] != "fits"] == \
        ["backward", "forward"] * 2
    if how == "no fit":
        assert ("fits", 16) in entries.calls


def test_no_new_refusal(entries, monkeypatch):
    """Every group the streamed solve took still runs, on the team
    consensus entries: G = 1 to 128 at (12, 4) and (6, 3), horizons from 2
    to past the resident wall (the entries' arithmetic stood in by
    recorders here)."""
    rec = lambda name: lambda *a: (entries.calls.append(
        (name, a[:4], ctypes.cast(a[15 if name == "b" else 26], ctypes.POINTER(
            admm_stream._StreamConsensus))[0].group)), 0)[1]
    monkeypatch.setattr(admm_stream, "_team_consensus_fns", lambda: (
        rec("b"), rec("f"), entries.fits))
    for make, nx in ((_quad, 12), (_rocket, 6)):
        for N in (2, 2048):
            prob = make(N, max_iter=1, ct=2)
            for G in (1, 2, 8, 16, 32, 64, 128):
                B = 2 * G
                tables, x0c, _, params = admm_stream._prepare(
                    prob, None, None, torch.zeros((2, G, nx)))
                kw = {k: v for k, v in params.items() if k != "max_iter"}
                spec = prob.spec
                run = admm_stream._KERNELS(
                    tables, x0c, admm_stream._init(
                        x0c, N, nx, spec.nu, None, params["fam"],
                        params["cons"]), None, N, nx, spec.nu, **kw)
                assert run.kind == "consensus"
                assert run.cluster == admm_stream.team_cluster(
                    G, team_lanes(nx))
                run.backward(1)
                run.forward(0, False)
                want = (nx, spec.nu, N, B)
                assert entries.calls[-2:] == [("b", want, G), ("f", want, G)]
