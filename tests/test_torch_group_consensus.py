"""Box consensus at (12, 4) on the thread-group kernel (csrc/admm_group.cu
with admm_group.cuh's GroupConsensus), emulated on the CPU in its own
layout, and its launch glue.

The emulation (``group_solve``, which tests/test_torch_group_adaptive.py
also drives under adaptive rho) runs the kernel as the card does, every
problem at once: P problems a block, a problem a group of nx + nu threads,
one row a thread (state rows, then input rows), each thread's rows of the
matrices; every dot product summed from zero in column order with the
correctly rounded float32 fma of tests/test_torch_stream_team.py
(``fma32``); each problem's arena -- its exchange slot (x, r / u, w; the g
slot under adaptive rho), a single slack copy and the dual of every row
and step, the saved column (in the arena, or at ``PLACE_SAVED_GLOBAL`` in
a device-memory buffer of its own), the input rows' feedforward d; the
residual maxima of each row reduced over the group with max_nan. Under
consensus each block keeps an offers array (nu, P): a running problem's
input rows write u[0] + yc0 there, and each running input row sums its
scenario group's G offers in lane order from zero -- in its own block when
G <= P, else across the G / P blocks of its cluster -- divides by G, moves
zc0 / yc0 and gates convergence on max|u[0] - zc0| over the group. A
converged problem freezes (its offer stands); a block (a cluster) leaves
once all its problems are done. A warm solve hands over x/u by re-running
the last iteration's rollout from x0 and its d.

It is held bitwise against the kernel's plain version
(``solve_fused_reference`` / ``solve_fused_warm_reference``), cold, warm
and ``final=True``, at G in {1, 2, 8, 16} with P = 8 (so G > P runs the
cluster's exchange) and at both places; a solve through it against the JAX
package's fused kernel in interpret mode at
tests/test_torch_consensus_fused.py's bar; and the launch glue against a
stand-in for the C entry that runs the emulation through its pointers: a
box consensus problem at (12, 4) reaches tinympc_admm_group_consensus with
its group, cluster, block and place; families, (6, 3), group 0 and a
cluster the rule refuses reach tinympc_admm_fused. The CUDA kernel runs on
the card only (chip_smoke.py phases 23-25, 31; chip_compare.py)."""
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
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm
from tinympc_tpu.kernels import init_carry as jax_init_carry

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.admm import apply_cones, apply_hyperplanes
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import admm_fused, init_carry
from tinympc_tpu_torch.kernels.admm_fused import (
    PLACE_SAVED_GLOBAL, PLACE_SHARED, Consensus, FusedCarry,
    group_arena_floats, group_geometry, group_route)
from tinympc_tpu_torch.types import ADAPTIVE_RHO_PERIOD, Solution
from tinympc_tpu_torch.rho_adapt import RHO_EPS
from test_torch_stream_team import fma32, sqrt_rn

torch.set_num_threads(1)


# ------------------------------------------------------------ the emulation

def max_nan(m, a):
    return torch.where((a > m) | (a != a), a, m)


def maxabs(m, a):
    return max_nan(m, a.abs())


def clamp_nan(s, lo, hi):
    s = torch.where(s < lo, lo, s)
    return torch.where(s > hi, hi, s)


def dot(mat, vec):
    """Each row of ``mat`` (rows, n) against each problem's ``vec``
    (B, n), summed from zero in column order with a correctly rounded
    float32 fma: (B, rows). Each step forms a * b + acc in float64 (the
    product exact) and rounds once to float32, which is the fma's result
    unless the float64 sum sits on a float32 midpoint; there fma32 (the
    exact TwoSum correction) decides."""
    m, v = mat.double(), vec.double()
    acc = torch.zeros((vec.shape[0], mat.shape[0]))
    for c in range(mat.shape[1]):
        s = m[:, c][None, :] * v[:, c][:, None] + acc.double()
        if bool(((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000).any()):
            acc = fma32(mat[:, c][None, :], vec[:, c][:, None], acc)
        else:
            acc = s.float()
    return acc


def group_reduce(a):
    """max_nan of each problem's threads (B, rows): the shuffle tree, the
    idle threads of a group (past the rows, at (6, 3)) holding zeros."""
    width = 1 << (a.shape[1] - 1).bit_length()
    a = torch.cat([a, torch.zeros((a.shape[0], width - a.shape[1]))], 1)
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        a = max_nan(a[:, :h], a[:, h:])
    return a[:, 0]


class Rows:
    """Each thread's rows of the tables (the GroupSweep constructor):
    thread t of a problem owns row t, a state row k < nx or an input row
    k = t - nx."""

    def __init__(self, t, nx, nu, N, adapt, cons):
        self.nx, self.nu, self.N = nx, nu, N
        rows = nx + nu
        r = torch.arange(rows)
        self.st = r < nx
        k = torch.where(self.st, r, r - nx)
        kx, ku = k.clamp(max=nx - 1), k.clamp(max=nu - 1)
        st = self.st[:, None]
        mrow = torch.where(self.st, nu + k, k)
        self.m1 = t["Mback"][mrow]                   # AmBKt / B^T
        self.f1 = t["Mfwd"][mrow]                    # A / Kinf
        self.m2 = torch.where(st, t["KinfT"][kx], t["Quu"][ku])
        self.bm = torch.where(st, t["Bm"][kx], torch.zeros(()))
        self.add = torch.where(self.st, t["APf"][kx], t["BPf"][ku])
        self.fv = torch.where(self.st, t["f"][kx], torch.zeros(()))
        self.wt = torch.where(self.st, t["Qd"][kx], t["Rd"][ku])
        self.kx, self.ku = kx, ku
        self.t = t
        if cons is not None:
            zx = torch.zeros((nx, nx))
            self.k0 = torch.cat([zx, t["Kinf0"]])   # Kinf0 (input rows)
            self.q0 = torch.cat([torch.zeros((nx, nu)), t["Quu0"]])
        if adapt is not None:
            # s12: dKinf (input rows) or, under apply_c, dC2 (state rows);
            # s4: dKinf^T (state rows) or, under apply_c, dC1 (input rows).
            zs = torch.zeros((nx, nx))
            dc2 = t["dC2"] if adapt.apply_c else zs
            self.s12 = torch.cat([dc2, t["dK"]])
            dc1 = t["dC1"] if adapt.apply_c else torch.zeros((nu, nu))
            self.s4 = torch.cat([t["dKT"], dc1])

    def per_step(self, name_x, name_u, i):
        """Row i of a per-step table, each thread its feature."""
        ux = self.t[name_u][min(i, self.N - 2)][self.ku]
        return torch.where(self.st, self.t[name_x][i][self.kx], ux)


def align4(n):
    return -(-n // 4) * 4


class Slot:
    """A problem's exchange slot (GroupArena): x at 0, r / u at align4(nx),
    w after align4(nu) more, each part padded to whole float4s (at (6, 3)
    x takes 8 floats, r and w 4 each); the vectors of the matvecs pass
    through it."""

    def __init__(self, n, nx, nu):
        self.uo = align4(nx)
        self.wo = self.uo + align4(nu)
        self.buf = torch.full((n, self.wo + align4(nu)), float("nan"))
        self.nx, self.nu = nx, nu

    def put(self, off, v):
        self.buf[:, off:off + v.shape[1]] = v
        return self.buf[:, off:off + v.shape[1]].clone()


class FamilyArena:
    """The family columns of every block (GroupArena's, after the
    feedforward): family f of the state side keeps row k's (slack, dual)
    of step i at f N P nx + i P nx + p nx + k, of the input side at
    fx N P nx + f (N - 1) P nu + i P nu + p nu + k (p the problem's place
    in its block, fx the state families that are on); read and written
    through problem indices."""

    def __init__(self, B, N, P, nx, nu, fam):
        self.fx, self.fu = admm_fused._sides(fam)
        self.N, self.P, self.nx, self.nu = N, P, nx, nu
        self.buf = torch.zeros((-(-B // P), self.fx * N * P * nx
                                + self.fu * (N - 1) * P * nu, 2))

    def _where(self, idx, state, f):
        N, P, nx, nu = self.N, self.P, self.nx, self.nu
        steps, F = (N, nx) if state else (N - 1, nu)
        start = f * N * P * nx if state else \
            self.fx * N * P * nx + f * (N - 1) * P * nu
        i = torch.arange(steps)[None, :, None]
        k = torch.arange(F)[None, None, :]
        pos = start + i * P * F + (idx % P)[:, None, None] * F + k
        return (idx // P)[:, None, None].expand_as(pos), pos

    def get(self, idx, state, f):
        """(n, steps, F, 2): the (slack, dual) of the problems ``idx``."""
        return self.buf[self._where(idx, state, f)]

    def put(self, idx, state, f, val):
        self.buf[self._where(idx, state, f)] = val


def _family_sides(t, fam, nx, nu, N):
    """Each side's families that are on, in order (SOC, hyperplane,
    time-varying hyperplane): (carry name, projection of step i's (n, F)
    candidate), the state side then the input side."""
    def cones(table):
        geometry = [(int(a), int(b)) for a, b in table[:, :2].tolist()]
        return lambda i, z: apply_cones(z, geometry, table[:, 2])

    def planes(A, b, asq):
        return lambda i, z: apply_hyperplanes(z, list(zip(A, b, asq)))

    def tv(A, b, asq):
        return lambda i, z: apply_hyperplanes(z, list(zip(A[i], b[i],
                                                          asq[i])))

    make = (lambda: cones(t["xcones"]), lambda: cones(t["ucones"]),
            lambda: planes(t["Alin_x"], t["blin_x"], t["asq_x"]),
            lambda: planes(t["Alin_u"], t["blin_u"], t["asq_u"]),
            lambda: tv(t["tv_Alin_x"], t["tv_blin_x"], t["tv_asq_x"]),
            lambda: tv(t["tv_Alin_u"], t["tv_blin_u"], t["tv_asq_u"]))
    sides = ([], [])
    for k, (n, name) in enumerate(zip(fam, admm_fused._FAMILY_DUALS)):
        if n:
            sides[k % 2].append((name, make[k]()))
    return sides


def group_solve(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                tol_dua, carry=None, fam=admm_fused.NO_FAMILIES, adapt=None,
                cons=None, P=8, place=PLACE_SHARED, G=None):
    """The kernel of csrc/admm_group.cu (fixed rho, ``cons`` or ``adapt``;
    the families of ``fam``, at (12, 4) or (6, 3)) on every problem of x0
    (B, nx), P problems a block, a group of G threads a problem (the
    kernel's width at (nx, nu) by default: the step-parallel projection's
    stride); returns what the plain version returns, ``(Solution,
    residuals, carry' or None)``."""
    t = admm_fused._unpack_tables(tables, nx, nu, N, fam, adapt,
                                  cons is not None)
    B, rows = x0.shape[0], nx + nu
    G = G or admm_fused.GROUP_WIDTHS[(nx, nu)]
    warm = carry is not None
    rw = Rows(t, nx, nu, N, adapt, cons)
    st = rw.st
    xfam, ufam = _family_sides(t, fam, nx, nu, N)
    FA = FamilyArena(B, N, P, nx, nu, fam)
    # The arena of every problem: slack and dual (one copy) of each row
    # and step, the input rows' d; the saved column in the arena, or at
    # PLACE_SAVED_GLOBAL in a device-memory buffer (blocks, N, P * rows),
    # a block's slice each, read and written through problem indices.
    S = torch.zeros((B, N, rows))
    D = torch.zeros((B, N, rows))
    F = torch.zeros((B, N - 1, nu))
    every = torch.arange(B)
    if place == PLACE_SAVED_GLOBAL:
        Vg = torch.zeros((-(-B // P), N, P, rows))

        def get_v(idx):
            return Vg[idx // P, :, idx % P]

        def set_v(idx, val):
            Vg[idx // P, :, idx % P] = val
    else:
        Va = torch.zeros((B, N, rows))

        def get_v(idx):
            return Va[idx]

        def set_v(idx, val):
            Va[idx] = val
    if warm:
        S[:, :, :nx] = carry.vnew.permute(2, 0, 1)
        S[:, :N - 1, nx:] = carry.znew.permute(2, 0, 1)
        D[:, :, :nx] = carry.g.permute(2, 0, 1)
        D[:, :N - 1, nx:] = carry.y.permute(2, 0, 1)
        v0 = torch.zeros((B, N, rows))
        v0[:, :, :nx] = carry.v.permute(2, 0, 1)
        v0[:, :N - 1, nx:] = carry.z.permute(2, 0, 1)
        set_v(every, v0)
    x0r = x0.clone()
    # Family seeds: state slacks from x0 in row 0, then the carried x (zeros
    # cold); input slacks from the carried u; the duals from the carry.
    for side, fams_ in ((True, xfam), (False, ufam)):
        for f, (name, _) in enumerate(fams_):
            steps, F_ = (N, nx) if side else (N - 1, nu)
            seed = torch.zeros((B, steps, F_, 2))
            if warm:
                seed[..., 0] = (carry.x if side else carry.u).permute(2, 0,
                                                                      1)
                seed[..., 1] = getattr(carry, name).permute(2, 0, 1)
            if side:
                seed[:, 0, :, 0] = x0r
            FA.put(every, side, f, seed)
    dvgN = S[:, N - 1, :nx] - D[:, N - 1, :nx]
    # -Pinf^T Xref[N-1] (and its sensitivity), row by row from zero.
    xN = t["Xref"][N - 1][None, :].expand(1, nx)
    pnref = -dot(t["PinfT"], xN)[0]
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    res = torch.zeros((4, B))
    u0 = torch.zeros((B, nu))
    drho_last = torch.zeros(B)           # drho of each one's last iteration
    if adapt is not None:
        pdp = -dot(t["dPT"], xN)[0]
        rho_l = torch.full((B,), rho) if not warm else carry.rho[0].clone()
        rho_v = rho_l.clone()
    if cons is not None:
        G = cons.group
        cluster = admm_fused.group_cluster(G, P)
        nblk = -(-B // P)
        offers = torch.zeros((nblk, nu, P))
        zc = carry.u[0].T.clone() if warm else torch.zeros((B, nu))
        yc = carry.yc0.T.clone() if warm else torch.zeros((B, nu))
    # Blocks (clusters under consensus) still running.
    unit = P * (admm_fused.group_cluster(cons.group, P) if cons else 1)
    alive = torch.ones(-(-B // unit), dtype=torch.bool)

    for it in range(max_iter):
        if not bool(alive.any()):
            break
        checking = (it + 1) % ct == 0
        run = ~done & alive.repeat_interleave(unit)[:B]
        idx = run.nonzero()[:, 0]
        ok = torch.zeros(B, dtype=torch.bool)
        if idx.numel():
            s_, d_, v_, f_ = S[idx], D[idx], get_v(idx), F[idx]
            n = idx.numel()
            if adapt is None:
                rb = torch.full((n, 1), rho)
                dr = None
                pt = pnref[None, :] - rb * dvgN[idx]
            else:
                rb = rho_l[idx][:, None]
                dr = rb - rho
                pt = (pnref[None, :] + dr * pdp[None, :]) - rb * dvgN[idx]
                drho_last[idx] = dr[:, 0]
            fx_ = [FA.get(idx, True, f) for f in range(len(xfam))]
            fu_ = [FA.get(idx, False, f) for f in range(len(ufam))]
            for c in fx_:                  # the families' terminal terms
                pt = pt - rb * (c[:, N - 1, :, 0] - c[:, N - 1, :, 1])
            adapting = adapt is not None and it > 0 \
                and it % ADAPTIVE_RHO_PERIOD == 0
            # ---- backward: p through the x slot, r and w after it
            p = pt
            slot = Slot(n, nx, nu)
            for i in range(N - 2, -1, -1):
                p = slot.put(0, p)
                ref = rw.per_step("Xref", "Uref", i)
                lin = -(ref * rw.wt)[None, :] - rb * (s_[:, i] - d_[:, i])
                for cs_, lo_ in ((fx_, 0), (fu_, nx)):
                    for c in cs_:
                        hi_ = lo_ + c.shape[2]
                        lin = torch.cat([lin[:, :lo_], lin[:, lo_:hi_] - rb * (
                            c[:, i, :, 0] - c[:, i, :, 1]), lin[:, hi_:]], 1)
                if cons is not None and i == 0:
                    lin = torch.cat([lin[:, :nx], lin[:, nx:] - cons.rho_c
                                     * (zc[idx] - yc[idx])], 1)
                a1 = dot(rw.m1, p)
                if adapt is not None and adapt.apply_c:
                    a1 = torch.cat([a1[:, :nx] + dr * dot(rw.s12[:nx], p),
                                    a1[:, nx:]], 1)
                r_ = slot.put(slot.uo, lin[:, nx:])
                w = slot.put(slot.wo, a1[:, nx:] + lin[:, nx:] + rw.add[nx:])
                kr = dot(rw.m2[:nx], r_)
                q0 = rw.q0[nx:] if cons is not None and i == 0 \
                    else rw.m2[nx:]
                d = dot(q0, w)
                if adapt is not None:
                    kr = kr + dr * dot(rw.s4[:nx], r_)
                    if adapt.apply_c:
                        d = d + dr * dot(rw.s4[nx:], w)
                p = lin[:, :nx] + a1[:, :nx] - kr + rw.add[:nx]
                f_[:, i] = d
            # ---- forward: x and u through the slot, the rows projected
            xo = x0r[idx]
            ps = torch.zeros((n, rows))
            ds = torch.zeros((n, rows))
            m = [torch.zeros((n, rows)) for _ in range(4)]
            pa = torch.zeros((n, rows))
            pb, pc = pa.clone(), pa.clone()
            ad1 = torch.zeros((n, nx))
            ad2 = ad1.clone()
            stale = warm and it == 0
            vals = []                      # each step's x[i] / u[i]
            for i in range(N):
                last = i == N - 1
                if not last:
                    x = xo
                    f1 = rw.f1.clone()
                    if cons is not None and i == 0:
                        f1[nx:] = rw.k0[nx:]
                    a1 = dot(f1, x)
                    if adapt is not None:
                        a1 = torch.cat([a1[:, :nx], a1[:, nx:] + dr * dot(
                            rw.s12[nx:], x)], 1)
                    val = torch.cat([xo, -a1[:, nx:] - f_[:, i]], 1)
                else:
                    val = torch.cat([xo, torch.zeros((n, nu))], 1)
                cols = slice(0, rows) if not last else slice(0, nx)
                vals.append(val)
                du = d_[:, i, cols]
                old = s_[:, i, cols].clone()
                lo = rw.per_step("xmin", "umin", i)[cols]
                hi = rw.per_step("xmax", "umax", i)[cols]
                v = val[:, cols]
                sn = clamp_nan(v + du, lo, hi)
                dn = du + v - sn
                s_[:, i, cols] = sn
                d_[:, i, cols] = dn
                if checking:
                    prev = v_[:, i, cols] if (warm and stale) else old
                    if warm and not stale:
                        v_[:, i, cols] = old
                    ps[:, cols] = max_nan(ps[:, cols], (v - sn).abs())
                    ds[:, cols] = max_nan(ds[:, cols], (prev - sn).abs())
                if last:
                    dvgN[idx] = sn - dn
                    sl_, dl_, vl_ = sn, dn, v
                    break
                if i == 0:
                    u0n = val[:, nx:]
                sl, dl, vl = sn, dn, v
                # x+ = (A x + B u) + f; the dynamics row (A x + B u) - x+
                s = a1[:, :nx] + dot(rw.bm[:nx], val[:, nx:])
                xo = s + rw.fv[:nx]
                axd = s - xo
                if adapting:
                    if i >= 1:
                        m = _fold(rw, i - 1, dl[:, :nx], pa, pb, pc, ad2, m)
                    pa, pb, pc = vl.clone(), dl.clone(), sl.clone()
                    ad2, ad1 = ad1, axd
            if adapting:
                # g[N-1] in the g slot: row N-2's terms, then row N-1's
                # (the terminal Pinf telescoped by drho dPinf).
                m = _fold(rw, N - 2, dl_, pa, pb, pc, ad2, m)
                pp = dot(t["Pinf"], xo)
                dp = dot(t["dP"], xo)
                px = pp + dr * dp
                qx = rw.wt[:nx] * vl_
                aty = 0.0 - dl_
                pres, pnorm, dres, dnorm = m
                dres = torch.cat([maxabs(dres[:, :nx], px + qx + aty),
                                  dres[:, nx:]], 1)
                dnorm = torch.cat([maxabs(maxabs(maxabs(
                    dnorm[:, :nx], px), aty), qx), dnorm[:, nx:]], 1)
                pres = torch.cat([maxabs(pres[:, :nx], ad1 - sl_),
                                  pres[:, nx:]], 1)
                pnorm = torch.cat([maxabs(maxabs(pnorm[:, :nx], ad1), sl_),
                                   pnorm[:, nx:]], 1)
                mm = [group_reduce(a) for a in (pres, pnorm, dres, dnorm)]
                r_new, v_new = _rho_update(adapt, *mm, rho_l[idx],
                                           rho_v[idx])
                rho_l[idx], rho_v[idx] = r_new, v_new
            # The projections, step-parallel: thread g of the group projects
            # steps g, g + G, ..., each side's whole candidate from the kept
            # x[i] / u[i], family 0 last (its slack holds them).
            for side, fams_, cs_ in ((True, xfam, fx_), (False, ufam,
                                                          fu_)):
                if not fams_:
                    continue
                lo_, F_ = (0, nx) if side else (nx, nu)
                for i in range(N if side else N - 1):
                    cs_[0][:, i, :, 0] = vals[i][:, lo_:lo_ + F_]
                for g in range(G):
                    for i in range(g, N if side else N - 1, G):
                        v = cs_[0][:, i, :, 0].clone()
                        for f in range(len(fams_) - 1, -1, -1):
                            dual = cs_[f][:, i, :, 1].clone()
                            z = fams_[f][1](i, v + dual)
                            cs_[f][:, i, :, 0] = z
                            cs_[f][:, i, :, 1] = dual + v - z
                for f in range(len(fams_)):
                    FA.put(idx, side, f, cs_[f])
            S[idx], D[idx], F[idx] = s_, d_, f_
            set_v(idx, v_)
            u0[idx] = u0n
            iters[idx] = it + 1
            rho_now = rho_l[idx] if adapt is not None else rho
            if checking:
                rows4 = torch.stack([
                    group_reduce(ps[:, :nx]), group_reduce(ps[:, nx:]),
                    group_reduce(ds[:, :nx]) * rho_now,
                    group_reduce(ds[:, nx:]) * rho_now])
                res[:, idx] = rows4
                passed = ((rows4[0] < tol_pri) & (rows4[1] < tol_pri)
                          & (rows4[2] < tol_dua) & (rows4[3] < tol_dua))
                if cons is None:
                    done[idx] = passed
                else:
                    ok[idx] = passed
        if cons is not None:
            # The exchange: every running problem's offer into its block's
            # (nu, P) array, then each sums its group's G offers in lane
            # order from zero (its block, or the blocks of its cluster).
            blk, pos = idx // P, idx % P
            offers[blk, :, pos] = u0[idx] + yc[idx]
            first = (idx // G) * G
            total = torch.zeros((idx.numel(), nu))
            for j in range(G):
                member = first + j
                total = total + offers[member // P, :, member % P]
            z = total / G
            yc[idx] = yc[idx] + u0[idx] - z
            zc[idx] = z
            cres = group_reduce((u0[idx] - z).abs())
            ok[idx] = ok[idx] & (cres < tol_pri)
            done = done | ok
        if checking:
            # A block (a cluster) leaves once none of its problems runs.
            pad = torch.ones(alive.numel() * unit, dtype=torch.bool)
            pad[:B] = done
            alive &= ~pad.reshape(-1, unit).all(1)

    if adapt is not None:
        res = torch.cat([res, rho_l[None]])
    sol = Solution(iter=iters, solved=done.clone(),
                   x=S[:, :, :nx].permute(1, 0, 2).contiguous(),
                   u=S[:, :N - 1, nx:].permute(1, 0, 2).contiguous())
    if not warm:
        return sol, res, None
    lane = lambda a: a.permute(1, 2, 0).contiguous()
    sv = torch.where(done[:, None, None], get_v(every), S)
    out = dict(vnew=lane(S[:, :, :nx]), znew=lane(S[:, :N - 1, nx:]),
               g=lane(D[:, :, :nx]), y=lane(D[:, :N - 1, nx:]),
               v=lane(sv[:, :, :nx]), z=lane(sv[:, :N - 1, nx:]))
    if cons is not None or xfam or ufam:
        # The x/u of the last iteration each problem ran: its rollout
        # re-run from x0 with that iteration's d (Kinf0 at step 0 under
        # consensus; under adaptive rho + drho dKinf x, drho of that
        # iteration, the rho it started with).
        xs = torch.zeros((N, nx, B))
        us = torch.zeros((N - 1, nu, B))
        x = x0r
        for i in range(N):
            xs[i] = x.T
            if i == N - 1:
                break
            f1 = rw.f1.clone()
            if cons is not None and i == 0:
                f1[nx:] = rw.k0[nx:]
            a1 = dot(f1, x)
            ku = a1[:, nx:]
            if adapt is not None:
                ku = ku + drho_last[:, None] * dot(rw.s12[nx:], x)
            u = -ku - F[:, i]
            us[i] = u.T
            x = a1[:, :nx] + dot(rw.bm[:nx], u) + rw.fv[:nx]
        ran = iters > 0
        xin = torch.cat([x0r.T[None], carry.x[1:]])
        out.update(x=torch.where(ran, xs, xin), u=torch.where(ran, us,
                                                            carry.u))
    if cons is not None:
        out.update(zc0=zc.T.contiguous(), yc0=yc.T.contiguous())
    for side, fams_ in ((True, xfam), (False, ufam)):
        for f, (name, _) in enumerate(fams_):
            out[name] = FA.get(every, side, f)[..., 1].permute(
                1, 2, 0).contiguous()
    if adapt is not None:
        out.update(rho=rho_l[None].clone())
    return sol, res, FusedCarry(**out)


def _fold(rw, j, g_next, pa, pb, pc, ad2, m):
    """Row j's OSQP terms folded into each thread's maxima ``m`` (pres,
    pnorm, dres, dnorm; (B, rows) each), g[j+1] = ``g_next`` read from the
    g slot, pa / pb / pc row j's x or u, new dual and new slack, ad2 the
    dynamics row j-1."""
    nx = rw.nx
    pres, pnorm, dres, dnorm = m
    atg = dot(rw.t["AT"], g_next)
    btg = dot(rw.m1[nx:], g_next)
    acc = torch.cat([atg, btg], 1)
    st = rw.st[None, :]
    qx = rw.wt * pa                     # Q x (state) / R u (input)
    aty_s = acc - (pb if j >= 1 else torch.zeros_like(pb))
    aty_u = pb + acc
    aty = torch.where(st, aty_s, aty_u)
    dres = maxabs(dres, torch.where(st, qx + qx + aty, 2.0 * qx + aty))
    dnorm = torch.where(st, maxabs(maxabs(maxabs(dnorm, qx), aty), qx),
                        maxabs(maxabs(dnorm, qx), aty))
    ad = torch.cat([ad2, torch.zeros_like(pa[:, nx:])], 1)
    pr_s = ad - pc
    pr_u = pa - pc
    gate = st if j >= 1 else torch.zeros_like(st)
    pres = torch.where(st, torch.where(gate, maxabs(pres, pr_s), pres),
                       maxabs(pres, pr_u))
    pnorm = torch.where(st, torch.where(gate, maxabs(maxabs(pnorm, ad), pc),
                                        pnorm),
                        maxabs(maxabs(pnorm, pa), pc))
    return [pres, pnorm, dres, dnorm]


def _rho_update(adapt, pri_res, pri_norm, dual_res, dual_norm, rho, rho_v):
    """admm_adaptive.cuh's rho_update on each problem (its threads all
    form the same value)."""
    ratio = (pri_res / (pri_norm + RHO_EPS)) / (
        dual_res / (dual_norm + RHO_EPS) + RHO_EPS)
    factor = sqrt_rn(ratio)
    clip = (lambda v: clamp_nan(v, torch.tensor(adapt.rho_min),
                                torch.tensor(adapt.rho_max))) \
        if adapt.clip else (lambda v: v)
    if adapt.rho_tol > 1.0:
        nv = clip(rho_v * factor)
        commit = (nv >= adapt.rho_tol * rho) | (nv * adapt.rho_tol <= rho)
        return torch.where(commit, nv, rho), nv
    return clip(rho * factor), rho_v


# ------------------------------------------------------------ problems

N = 6
HOVER = np.tile(np.asarray([0, 0, 0.5] + [0.0] * 9, np.float32), (N, 1))


def quad(N=N, max_iter=25, ct=1, rho_c=100.0, consensus=True):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    p = tt.with_settings(p, max_iter=max_iter, check_termination=ct)
    return tt.with_consensus(p, rho_c=rho_c) if consensus else p


def x0s(ng, G, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    nominal = rng.uniform(-spread, spread, (ng, 1, 12))
    return torch.as_tensor(nominal + 0.05 * rng.uniform(-1, 1, (ng, G, 12)),
                           dtype=torch.float32)


def _flat(out):
    sol, res = out[0], out[1]
    d = {k: getattr(sol, k) for k in ("x", "u", "iter", "solved")}
    d["res"] = res
    if len(out) > 2 and out[2] is not None:
        for f in dataclasses.fields(out[2]):
            v = getattr(out[2], f.name)
            if v is not None:
                d["carry." + f.name] = v
    return d


def assert_bitwise(got, want):
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def emulate(prob, Xref, x0, carry=None, P=8, place=PLACE_SHARED):
    """The emulation on a problem's packed inputs, with the batch's
    (n_groups, G) shape restored as the plain version returns it."""
    tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
    spec = prob.spec
    if carry is not None:
        carry = admm_fused._carry_tensors(prob, carry, x0c.shape[0])
    out = group_solve(tables, x0c, spec.N, spec.nx, spec.nu, carry=carry,
                      P=P, place=place, **params)
    return admm_fused._grouped(out if carry is not None else out[:2],
                               params["cons"])


# ------------------------------------------------------------ bitwise

@pytest.mark.parametrize("G,ct,place", [
    (1, 1, PLACE_SHARED), (2, 5, PLACE_SAVED_GLOBAL),
    (8, 1, PLACE_SAVED_GLOBAL), (16, 2, PLACE_SHARED),
    (16, 1, PLACE_SAVED_GLOBAL)])
def test_emulation_is_bitwise_the_plain_solve(G, ct, place):
    """Cold, a warm solve of an external plant and a final=True solve:
    every output and carry field bitwise the plain version's, with the
    scenario group in one block (G <= 8) and across a cluster of two blocks
    (G = 16), the saved column in the arena and in device memory."""
    prob = quad(ct=ct)
    ng = 32 // G
    x = x0s(ng, G, seed=G)
    Xref = torch.as_tensor(HOVER)
    assert_bitwise(emulate(prob, Xref, x, place=place),
                   tt.kernels.solve_fused_reference(prob, Xref, None, x))
    c_e = c_p = init_carry(prob, ng * G)
    for step in range(2):
        got = emulate(prob, Xref, x, c_e, place=place)
        want = tt.kernels.solve_fused_warm_reference(
            prob, Xref, None, x, c_p, final=step == 1)
        assert_bitwise(got, want)
        c_e, c_p = got[2], want[2]
        xf = x.reshape(-1, 12)
        x = (xf @ prob.A.T + got[0].u[0].reshape(-1, 4) @ prob.B.T
             ).reshape(ng, G, 12)


def test_a_frozen_offer_stands_across_the_cluster():
    """Problems of one group converge at different iterations (2 groups of
    16 across clusters of 2 blocks, N=8, max_iter 100): the emulation keeps
    each converged problem's offer and stays bitwise the plain version,
    which freezes the same way; the counts differ inside a group."""
    prob = quad(N=8, max_iter=100, ct=1)
    Xref = torch.as_tensor(np.tile(HOVER[:1], (8, 1)))
    x = x0s(2, 16, seed=3, spread=0.4)
    got = emulate(prob, Xref, x)
    assert_bitwise(got, tt.kernels.solve_fused_reference(prob, Xref, None,
                                                         x))
    it = got[0].iter
    assert bool((it.amax(1) != it.amin(1)).any())


def test_emulation_matches_the_jax_kernel():
    """tests/test_torch_consensus_fused.py's cold case of one group of 8
    (rho_c the problem's; max_iter 30 here) and its warm sequence (2
    groups of 4, rho_c 50; two solves of max_iter 20 here): the emulation
    against the JAX fused kernel in interpret mode at that file's bar --
    cold x and u within 2e-4 and counts within 1; warm u within 5e-4 and
    counts within 2."""
    s = systems.quadrotor_20hz()
    Xr = np.tile(np.asarray([0, 0, 0.5] + [0.0] * 9, np.float32), (10, 1))

    def jp(max_iter, rho_c):
        p = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                     N=10, dtype=jnp.float32)
        p = tm.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
        return tm.with_consensus(tm.with_settings(p, max_iter=max_iter),
                                 rho_c=rho_c)

    port = lambda pj: problem_from_numpy(problem_to_numpy(pj), "cpu",
                                         torch.float32)
    pj = jp(30, None)
    x0 = np.random.default_rng(7).uniform(-0.3, 0.3, (1, 8, 12)) \
        .astype(np.float32)
    sol_j, _ = jax_solve_fused(pj, jnp.asarray(Xr), None, jnp.asarray(x0),
                               tile=8, interpret=True)
    sol_e = emulate(port(pj), torch.as_tensor(Xr), torch.as_tensor(x0))[0]
    np.testing.assert_allclose(sol_e.x.numpy(), np.asarray(sol_j.x),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(sol_e.u.numpy(), np.asarray(sol_j.u),
                               rtol=0, atol=2e-4)
    assert np.all(np.abs(sol_e.iter.numpy() - np.asarray(sol_j.iter)) <= 1)
    pj = jp(20, 50.0)
    pt = port(pj)
    x = np.random.default_rng(11).uniform(-0.3, 0.3, (2, 4, 12)) \
        .astype(np.float32)
    cj, ce = jax_init_carry(pj, 8), init_carry(pt, 8)
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    for _ in range(2):
        sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(Xr), None,
                                            jnp.asarray(x), cj, tile=8,
                                            interpret=True)
        sol_e, _, ce = emulate(pt, torch.as_tensor(Xr), torch.as_tensor(x),
                               ce)
        np.testing.assert_allclose(sol_e.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=5e-4)
        assert np.all(np.abs(sol_e.iter.numpy() - np.asarray(sol_j.iter))
                      <= 2)
        x = (x.reshape(8, 12) @ A.T + np.asarray(sol_j.u[0]).reshape(8, 4)
             @ Bm.T).astype(np.float32).reshape(2, 4, 12)


# ------------------------------------------------------------ geometry

def test_consensus_arena_and_route():
    """The consensus arena adds the offers (nu, P) and the cluster's vote
    (4 floats) to the box arena, and the table the step-0 gains. A group
    lies in one block up to P problems, else in a cluster of G / P blocks,
    at most 16: G=128 runs on the group kernel at N=10 (8 a block, a
    cluster of 16) but not warm at N=128 (P=4: 32 blocks), where
    csrc/admm_fused.cu takes it; so does a cluster the card cannot hold."""
    for N_, P, saved in ((10, 8, False), (20, 4, True), (700, 2, False)):
        assert group_arena_floats(N_, P, saved, kind="consensus") == \
            group_arena_floats(N_, P, saved) + 4 * P + 4
    P, place, smem = group_geometry(10, False, kind="consensus")
    table = admm_fused._table_floats(12, 4, 10, consensus=True)
    assert table == admm_fused._table_floats(12, 4, 10) + 4 * 12 + 4 * 4
    assert (P, place) == (8, PLACE_SHARED)
    assert smem == 4 * (-(-table // 4) * 4 + group_arena_floats(
        10, 8, False, kind="consensus"))
    fam = admm_fused.NO_FAMILIES
    route = lambda N_, G, warm, **k: group_route(
        N_, 12, 4, fam, None, Consensus(G, 100.0), warm, **k)
    assert route(10, 8, True) == ("consensus", 8, PLACE_SHARED, 1)
    assert route(10, 16, False) == ("consensus", 8, PLACE_SHARED, 2)
    assert route(10, 128, False) == ("consensus", 8, PLACE_SHARED, 16)
    assert route(128, 128, False) == ("consensus", 8, PLACE_SHARED, 16)
    assert route(128, 128, True) is None
    assert route(128, 16, True) == ("consensus", 4, PLACE_SHARED, 4)
    no = lambda N_, P, place, cluster: cluster < 16
    assert route(10, 128, False, fits=no) is None
    assert route(10, 8, False, fits=no) == ("consensus", 8, PLACE_SHARED, 1)
    # group 0 (consensus off, the families kernel), families, (6, 3)
    assert group_route(10, 12, 4, fam, None, Consensus(0, 0.0), False) \
        is None
    assert group_route(10, 12, 4, admm_fused.Families(nlx=1), None,
                       Consensus(8, 1.0), False) is None
    assert group_route(10, 6, 3, fam, None, Consensus(8, 1.0), False) \
        is None


def test_geometry_check_covers_the_new_arenas():
    """check_group_geometry holds each kind's arena (box, consensus,
    adaptive with and without apply_c) against a library's count: a count
    that is the wrapper's passes, one float more in the consensus arena
    past N=600 raises."""
    def count(N_, P, place, warm, kind, extra=0):
        save = warm and place != PLACE_SAVED_GLOBAL
        table = admm_fused._group_table(N_, 12, 4, kind)
        return 4 * ((-(-table // 4) * 4 if place == PLACE_SHARED else 0)
                    + group_arena_floats(N_, P, save, kind=kind) + extra)

    for kind in admm_fused.GROUP_KINDS:
        admm_fused.check_group_geometry(
            lambda N_, P, place, warm, kind=kind: count(N_, P, place, warm,
                                                        kind),
            group_kind=kind)
    with pytest.raises(RuntimeError, match="kind consensus"):
        admm_fused.check_group_geometry(
            lambda N_, P, place, warm: count(N_, P, place, warm, "consensus",
                                             extra=int(N_ > 600)),
            group_kind="consensus")


# ------------------------------------------------------------ launch glue

def _view(ptr, shape, ctype=ctypes.c_float):
    n = math.prod(shape)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * n).from_address(ptr))).reshape(shape)


class Entry:
    """A stand-in for tinympc_admm_group_consensus: its arguments checked
    and recorded, the emulation run through its pointers."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert len(args) == 25
        (warm, nx, nu, P, place, N_, B, max_iter, ct, rho, tol_pri,
         tol_dua, tables, x0, ox, ou, oi, osv, orr, carry, block_sys,
         stride, saved, cons, stream) = args
        c = cons._obj
        assert block_sys is None and (saved is None) == (
            place != PLACE_SAVED_GLOBAL)
        self.calls.append(dict(warm=warm, P=P, place=place, group=c.group,
                               cluster=c.cluster, rho_c=c.rho_c))
        x, u = (N_, nx, B), (N_ - 1, nu, B)
        ct_ = None
        if warm:
            cin = [_view(carry[k], s) for k, s in enumerate([x, u] * 3)]
            ct_ = FusedCarry(vnew=cin[0], znew=cin[1], g=cin[2], y=cin[3],
                             v=cin[4], z=cin[5], u=_view(c.u_in, u),
                             x=_view(c.x_in, x),
                             yc0=_view(c.yc0_in, (nu, B)))
        else:
            assert all(getattr(c, f) is None for f in (
                "u_in", "x_in", "yc0_in", "zc0_out", "yc0_out", "x_out",
                "u_out"))
        ntab = stride
        sol, res, out = group_solve(
            _view(tables, (ntab,)).clone(), _view(x0, (B, nx)).clone(), N_,
            nx, nu, max_iter=max_iter, ct=ct, rho=rho, tol_pri=tol_pri,
            tol_dua=tol_dua, carry=ct_, cons=Consensus(c.group, c.rho_c),
            P=P, place=place)
        _view(ox, (N_, B, nx))[:] = sol.x
        _view(ou, (N_ - 1, B, nu))[:] = sol.u
        _view(oi, (B,), ctypes.c_int32)[:] = sol.iter
        _view(osv, (B,), ctypes.c_bool)[:] = sol.solved
        _view(orr, (4, B))[:] = res
        if warm:
            for k, f in enumerate(("vnew", "znew", "v", "z", "g", "y")):
                _view(carry[6 + k], [x, u][k % 2] if k < 4 else
                      (x if f == "g" else u))[:] = getattr(out, f)
            for f, ptr, shape in (("zc0", c.zc0_out, (nu, B)),
                                  ("yc0", c.yc0_out, (nu, B)),
                                  ("x", c.x_out, x), ("u", c.u_out, u)):
                _view(ptr, shape)[:] = getattr(out, f)
        return 0


@pytest.fixture
def entries(monkeypatch):
    """The C entries stubbed: the group consensus entry runs the
    emulation; the one-thread entry and the box entry record their
    launch."""
    e = Entry()
    fused = []
    monkeypatch.setattr(admm_fused, "_group_policy_fn",
                        lambda kind: e if kind == "consensus" else None)
    monkeypatch.setattr(admm_fused, "_group_fn", lambda: None)
    monkeypatch.setattr(admm_fused, "_kernel_fn",
                        lambda multi=False: lambda *a: fused.append(
                            (a[0], a[26]._obj.group)) or 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(admm_fused, "entry_counts",
                        dict.fromkeys(admm_fused.entry_counts, 0))
    for k in ("consensus_launch_count", "consensus_warm_launch_count"):
        monkeypatch.setattr(admm_fused, k, 0)
    e.fused = fused
    return e


def test_box_consensus_takes_the_group_entry(entries):
    """A cold and two warm solves of the quadrotor's box with consensus,
    2 groups of 16 and 4 of 8, through the launch glue: each launch on
    tinympc_admm_group_consensus with its group, cluster (2 blocks for
    G=16, 1 for G=8), 8 problems a block in shared memory and rho_c;
    every output and carry field bitwise the plain version's; counted as
    consensus launches."""
    Xref = torch.as_tensor(HOVER)
    for ng, G in ((2, 16), (4, 8)):
        prob = quad(ct=2)
        x = x0s(ng, G, seed=5)
        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x)
        got = admm_fused._grouped(admm_fused._solve_kernel(
            tables, x0c, N, 12, 4, **params), params["cons"])
        assert_bitwise(got, tt.kernels.solve_fused_reference(prob, Xref,
                                                             None, x))
        c_k = c_p = init_carry(prob, ng * G)
        for _ in range(2):
            ck = admm_fused._carry_tensors(prob, c_k, ng * G)
            got = admm_fused._grouped(admm_fused._solve_kernel_warm(
                tables, x0c, ck, N, 12, 4, **params), params["cons"])
            want = tt.kernels.solve_fused_warm_reference(prob, Xref, None, x,
                                                         c_p)
            assert_bitwise(got, want)
            c_k, c_p = got[2], want[2]
    cl = {16: 2, 8: 1}
    assert [(c["warm"], c["group"], c["cluster"], c["P"], c["place"])
            for c in entries.calls] == [
        (w, G, cl[G], 8, PLACE_SHARED) for G in (16, 8) for w in (0, 1, 1)]
    assert all(c["rho_c"] == 100.0 for c in entries.calls)
    assert admm_fused.entry_counts["tinympc_admm_group_consensus"] == 6
    assert admm_fused.entry_counts["tinympc_admm_fused"] == 0
    assert admm_fused.consensus_launch_count == 2
    assert admm_fused.consensus_warm_launch_count == 4


def test_other_consensus_solves_keep_the_one_thread_entry(entries):
    """Consensus with a family (a state hyperplane), the rocket's cones at
    (6, 3), group 0 and a group of 128 warm at N=128 (its cluster would
    pass 16 blocks) launch tinympc_admm_fused, never the group entry."""
    lin = tt.with_linear_constraints(quad(consensus=False),
                                     np.eye(12)[2:3], [2.0])
    lin = tt.with_consensus(lin, rho_c=100.0)
    s = tt.systems.rocket_landing_20hz()
    rocket = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                      N=N, f=s["f"], device="cpu")
    rocket = tt.with_consensus(tt.with_cones(
        tt.with_bounds(rocket, u_min=-10.0, u_max=105.0),
        state_cones=[(0, 3, 0.25)]), rho_c=100.0)
    long = quad(N=128, max_iter=2)
    for prob, x, warm in ((lin, torch.zeros((2, 8, 12)), False),
                          (rocket, torch.zeros((2, 8, 6)), False),
                          (long, torch.zeros((1, 128, 12)), True)):
        spec = prob.spec
        tables, x0c, params = admm_fused._prepare(prob, None, None, x)
        if warm:
            c = admm_fused._carry_tensors(prob, init_carry(
                prob, x0c.shape[0]), x0c.shape[0])
            admm_fused._solve_kernel_warm(tables, x0c, c, spec.N, spec.nx,
                                          spec.nu, **params)
        else:
            admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx, spec.nu,
                                     **params)
    off = dict(params, cons=Consensus(0, 0.0))
    t2, x2, _ = admm_fused._prepare(quad(), None, None,
                                    torch.zeros((2, 8, 12)))
    admm_fused._launch(t2, x2, N, 12, 4, off["fam"], None, off["cons"], None,
                       2, 1, off["rho"], off["tol_pri"], off["tol_dua"])
    assert entries.calls == []
    assert entries.fused == [(0, 8), (0, 8), (1, 128), (0, 0)]
    assert admm_fused.entry_counts["tinympc_admm_fused"] == 4
