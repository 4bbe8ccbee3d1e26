"""Streamed fused solve for long horizons on the GPU (counterpart of
``tinympc_tpu.kernels.admm_stream``).

The resident kernel (:mod:`.admm_fused`) keeps its packed tables -- the
reference, the box bounds and the time-varying hyperplanes, all growing with
the horizon N -- in a block's shared memory, which caps N near 1190 at
(nx, nu) = (12, 4). :func:`solve_fused_streamed` and
:func:`solve_fused_streamed_warm` keep only the tables that do not grow with
N on chip and run each ADMM iteration as two launches of the hand-written
CUDA kernels in ``csrc/admm_stream.cu``: a backward sweep (the TPU kernel
``admm_stream._backward_kernel``) that writes the feedforward d, and a
forward sweep (``admm_stream._forward_kernel``, and its ``stale`` variant
for the first iteration of a warm solve) that rolls out, projects, updates
the duals, accumulates the residuals and keeps each lane's bookkeeping; a
box problem, at fixed or adaptive rho, and a problem with constraint
families, with scenario-tree consensus or both at fixed rho run both
launches on lane teams (``csrc/admm_stream_team.cuh``, a thread a row of
each lane; a consensus group exchanges its offers in a block's shared
memory or across a thread-block cluster). The
loop around the launches runs here, on the host; it reads one flag from the
card after each check iteration and stops once every lane has converged.

Scope: box, second-order cone, hyperplane and time-varying hyperplane
constraints in any mix, at fixed rho with or without scenario-tree
consensus on u[0] (x0s (n_groups, G, nx), G a power of two up to 128, as
the resident solve takes it), or with adaptive rho, at the (nx, nu) the
resident kernels are instantiated for (one thread a lane at
``admm_fused.THREAD_KERNEL_DIMS``, which have no lane teams); cold and
warm (the :class:`~.admm_fused.FusedCarry` of the resident solve, which
either solve may hand to the other). Consensus runs the kernels' consensus
instantiations: r[0]'s prox term and the Quu0_inv gain in the backward
launch, the Kinf0 gain and the group exchange at the end of the forward
launch; each lane's slack, dual and standing offer stay on the card between
launches. On lane teams a group of G lanes lies in one block when G is at
most the block's lanes, else it is a thread-block cluster of G / lanes
blocks; a cluster past :data:`TEAM_MAX_CLUSTER` blocks, or one the card
cannot hold, takes the one-thread consensus kernels by route. Adaptive rho runs their adaptive instantiations: each lane's rho
and the guard's virtual rho stay on the card between launches, the backward
launch telescopes the products the Taylor update moves, and the forward
launch adapts rho every 5th iteration of a running lane before its
termination check; the residuals gain the final rho as a 5th row and the
warm carry each lane's rho, as in the resident solve.

On CPU tensors the wrappers run the kernels' plain PyTorch versions,
:func:`stream_backward_reference` and :func:`stream_forward_reference`,
through the same host loop; on CUDA tensors they launch the kernels or
raise. The public layout and results are those of
:func:`~.admm_fused.solve_fused`: converged lanes freeze, so each lane's
result does not depend on the others, and the two solves agree bitwise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..types import ADAPTIVE_RHO_PERIOD, TinyProblem
from . import _build, admm_fused
from .admm_fused import (_FAMILY_DUALS, _PTR, _PTRS, NO_FAMILIES, Adaptive,
                         Consensus, FusedCarry, Families, _AdaptArgs,
                         _adapt_plain, _check_arg, _family_projectors,
                         _group_mean, _grouped, _outputs, _prepare_inputs,
                         _ptr_array, _table_layout, _unpack_tables)

KERNEL = "admm_stream"

# Launches in this process of each streamed kernel, by the name of its
# instantiation: the one-thread backward kernel, forward kernel and its
# stale variant (which only ``_KERNELS(..., team=False)`` runs at fixed rho
# without consensus), their consensus instantiations (``team=False``, and
# the groups whose cluster cannot be formed) and their adaptive ones
# (families with adaptive rho), and the kernels on lane teams: the
# backward, the forward and its stale launch of box problems, at fixed rho
# and at adaptive rho, of problems with families at fixed rho, and of
# consensus problems (with or without families); chip_smoke.py resets and
# reads them to show that the streamed path went through its kernels.
launch_counts = dict.fromkeys(
    ("backward", "forward", "forward_stale", "backward_consensus",
     "forward_consensus", "forward_consensus_stale", "backward_adaptive",
     "forward_adaptive", "forward_adaptive_stale", "backward_team",
     "forward_team", "forward_team_stale", "backward_team_adaptive",
     "forward_team_adaptive", "forward_team_adaptive_stale",
     "backward_team_families", "forward_team_families",
     "forward_team_families_stale", "backward_team_consensus",
     "forward_team_consensus", "forward_team_consensus_stale"), 0)

# Blocks a consensus group's thread-block cluster may span on the team
# launches (csrc/admm_stream_team.cuh kTeamMaxCluster; past 8 a
# non-portable size, which an H100 takes to 16).
TEAM_MAX_CLUSTER = 16


def team_lanes(nx: int) -> int:
    """The lanes a block of the team launches holds (``TeamShape::kLanes``
    of csrc/admm_stream_team.cuh): the fewest, 8 or more, for which the
    state rows fill whole warps."""
    return 8 if 8 * nx % 32 == 0 else 16 if 16 * nx % 32 == 0 else 32


def team_cluster(group: int, lanes: int) -> int:
    """Blocks of a consensus group's cluster on the team launches: 1 where
    the group lies in one block of ``lanes`` lanes, else group / lanes."""
    return 1 if group <= lanes else group // lanes


def team_consensus_route(group: int, nx: int, fits=None) -> Optional[int]:
    """The cluster a consensus group of ``group`` lanes takes on lane teams
    at ``nx`` (1: in one block), or None where it takes the one-thread
    consensus kernels: a cluster past :data:`TEAM_MAX_CLUSTER` blocks, or,
    where ``fits(cluster)`` is given (the loaded library's occupancy
    query), one the card cannot hold."""
    cluster = team_cluster(group, team_lanes(nx))
    if cluster > TEAM_MAX_CLUSTER or (
            cluster > 1 and fits is not None and not fits(cluster)):
        return None
    return cluster


def _check(prob: TinyProblem) -> None:
    """Raise ``ValueError`` for a problem the streamed kernels do not
    cover: those of the resident kernel, whatever its horizon."""
    admm_fused._check_problem(prob)


def stream_supported(prob: TinyProblem) -> bool:
    """True if :func:`solve_fused_streamed` handles this problem: box, SOC,
    hyperplane and time-varying hyperplane constraints in any mix, at fixed
    rho with or without consensus within the batch (its step-0 gains baked
    by ``with_consensus``), or with adaptive rho and its sensitivities
    attached, at any horizon N >= 2, ``matmul_precision="highest"``, no
    coarse schedule, and an (nx, nu) pair the kernels are instantiated
    for."""
    try:
        _check(prob)
    except ValueError:
        return False
    return True


def _prepare(prob: TinyProblem, Xref, Uref, x0s, carry=None, warm=False):
    """Check the problem, x0s and (warm) the carry; return the packed tables,
    x0, the carry and the solver parameters."""
    _check(prob)
    tables, x0, params = _prepare_inputs(prob, Xref, Uref, x0s)
    if warm:
        if carry is None:
            raise ValueError("solve_fused_streamed_warm needs a carry; start "
                             "from init_carry(prob, B)")
        carry = admm_fused._carry_tensors(prob, carry, x0.shape[0])
    return tables, x0, carry, params


# ------------------------------------------------------------ entry points

def solve_fused_streamed(prob: TinyProblem, Xref=None, Uref=None, x0s=None):
    """Long-horizon batched cold solve, two kernel launches an iteration.
    Returns ``(Solution, residuals (4, B))`` as :func:`solve_fused` does (a
    consensus problem in its (n_groups, G) layout; with adaptive rho the
    residuals are (5, B), the last row each lane's final rho).

    Raises ``ValueError`` for a problem outside :func:`stream_supported`.
    On CPU tensors it runs :func:`solve_fused_streamed_reference`."""
    tables, x0, _, params = _prepare(prob, Xref, Uref, x0s)
    return _grouped(_solve(prob, tables, x0, None, params)[:2],
                    params["cons"])


def solve_fused_streamed_warm(prob: TinyProblem, Xref=None, Uref=None,
                              x0s=None, carry: Optional[FusedCarry] = None):
    """Warm-started long-horizon solve: ``(Solution, residuals (4, B),
    carry')``, with the carry contract of :func:`solve_fused_warm` (start
    from :func:`init_carry`; a carry of either solve serves the other). The
    first iteration's dual residual reads the carried one-behind v/z (the
    stale forward kernel); converged lanes hand over their first-convergence
    iterate. A consensus solve re-seeds each lane's slack from the carried
    u[0], keeps the carried dual, and hands over zc0 / yc0 and x/u; an
    adaptive one starts each lane from its carried rho and hands over the
    final one. On CPU tensors it runs
    :func:`solve_fused_streamed_warm_reference`."""
    tables, x0, carry, params = _prepare(prob, Xref, Uref, x0s, carry, True)
    return _grouped(_solve(prob, tables, x0, carry, params), params["cons"])


def solve_fused_streamed_reference(prob: TinyProblem, Xref=None, Uref=None,
                                   x0s=None):
    """The streamed solve on the kernels' plain PyTorch versions, on the
    problem's device: the same host loop, arrays, freeze and exit rules as
    the kernels, so that a mismatch points into a kernel. Returns what
    :func:`solve_fused_streamed` returns."""
    tables, x0, _, params = _prepare(prob, Xref, Uref, x0s)
    return _grouped(_loop(tables, x0, None, prob.spec, _PLAIN, **params)[:2],
                    params["cons"])


def solve_fused_streamed_warm_reference(prob: TinyProblem, Xref=None,
                                        Uref=None, x0s=None,
                                        carry: Optional[FusedCarry] = None):
    """The warm streamed solve on the plain versions, on the problem's
    device. Returns what :func:`solve_fused_streamed_warm` returns."""
    tables, x0, carry, params = _prepare(prob, Xref, Uref, x0s, carry, True)
    return _grouped(_loop(tables, x0, carry, prob.spec, _PLAIN, **params),
                    params["cons"])


def _solve(prob, tables, x0, carry, params):
    if x0.device.type == "cpu":
        return _loop(tables, x0, carry, prob.spec, _PLAIN, **params)
    if x0.device.type == "cuda":
        return _loop(tables, x0, carry, prob.spec, _KERNELS, **params)
    raise ValueError(f"the streamed solve runs on cuda or cpu, not "
                     f"{x0.device}")


# ------------------------------------------------------------ the host loop

def _init(x0, N, nx, nu, carry, fam: Families,
          cons: Optional[Consensus] = None, rho: Optional[float] = None):
    """The working arrays of a solve, lane-last, on x0's device: vnew/znew
    as ping-pong halves (iteration it writes half it % 2; a warm solve's
    carried slack goes into half 1, which iteration 0 reads as previous),
    the duals, the feedforward d, the slack and dual of each family in the
    order of the kernels' family array (None for a family that is off),
    the carried x/u of a warm family or consensus solve, under consensus
    each lane's slack zc0, dual yc0 and standing offer, (nu, B) each, under
    adaptive rho (``rho``, the problem's rho) each lane's rho and virtual
    rho, (B,) each, and the bookkeeping: iters, done, res and the one-int
    flag ``active``.

    Family slacks are seeded as the resident kernel seeds them
    (admm_stream.py:1196-1214): the state side from x0 in row 0 and zeros
    (cold) or the carried x after it, the input side from zeros or the
    carried u; duals start at zero or from the carry. The consensus slack
    starts at the carried u[0] (zero cold), its dual at the carried yc0
    (:1231-1247), and no lane has offered yet. A lane's rho starts at the
    carried one (the problem's cold), and its virtual rho restarts from it,
    as in the resident solve."""
    B = x0.shape[0]
    kw = dict(dtype=torch.float32, device=x0.device)
    vnew = torch.zeros((2, N, nx, B), **kw)
    znew = torch.zeros((2, N - 1, nu, B), **kw)
    if carry is None:
        g, y = torch.zeros((N, nx, B), **kw), torch.zeros((N - 1, nu, B), **kw)
    else:
        vnew[1], znew[1] = carry.vnew, carry.znew
        g, y = carry.g.clone(), carry.y.clone()
    track = carry is not None and (any(fam) or cons is not None)
    x_seed = torch.cat([x0.T[None], carry.x[1:] if track
                        else torch.zeros((N - 1, nx, B), **kw)])
    u_seed = carry.u if track else torch.zeros((N - 1, nu, B), **kw)
    fams = []
    for k, (name, n) in enumerate(zip(_FAMILY_DUALS, fam)):
        seed = x_seed if k % 2 == 0 else u_seed
        if not n:
            fams += [None, None]
        elif carry is None:
            fams += [seed.clone(), torch.zeros_like(seed)]
        else:
            fams += [seed.clone(), getattr(carry, name).clone()]
    s = dict(vnew=vnew, znew=znew, g=g, y=y,
             d=torch.zeros((N - 1, nu, B), **kw), fams=fams,
             x=x_seed.clone() if track else None,
             u=u_seed.clone() if track else None,
             iters=torch.zeros(B, dtype=torch.int32, device=x0.device),
             done=torch.zeros(B, dtype=torch.bool, device=x0.device),
             res=torch.zeros((4, B), **kw),
             active=torch.zeros(1, dtype=torch.int32, device=x0.device),
             zc0=None, yc0=None, offer=None, rho=None, rho_v=None)
    if rho is not None:
        s["rho"] = torch.full((B,), rho, **kw) if carry is None \
            else carry.rho[0].clone()
        s["rho_v"] = s["rho"].clone()
    if cons is not None:
        s.update(zc0=u_seed[0].clone(),
                 yc0=torch.zeros((nu, B), **kw) if carry is None
                 else carry.yc0.clone(),
                 offer=torch.zeros((nu, B), **kw))
    return s


def _loop(tables, x0, carry, spec, launcher, *, max_iter, ct, rho, tol_pri,
          tol_dua, fam: Families, adapt: Optional[Adaptive] = None,
          cons: Optional[Consensus] = None):
    """The ADMM loop around the two launches of each iteration, on the
    kernels (``_KERNELS``) or their plain versions (``_PLAIN``): iteration
    ``it`` runs the backward launch on half 1 - it % 2, then the forward
    launch into half it % 2 -- stale on iteration 0 of a warm solve. After
    each check iteration the host reads the flag and stops once no lane is
    still running, so the iteration count never passes max_iter. Returns
    ``(Solution, residuals, carry' or None)`` in the lane layout."""
    N, nx, nu = spec.N, spec.nx, spec.nu
    s = _init(x0, N, nx, nu, carry, fam, cons,
              None if adapt is None else rho)
    run = launcher(tables, x0, s, carry, N, nx, nu, rho=rho, ct=ct,
                   tol_pri=tol_pri, tol_dua=tol_dua, fam=fam, adapt=adapt,
                   cons=cons)
    for it in range(max_iter):
        run.backward(1 - it % 2)
        run.forward(it, stale=carry is not None and it == 0)
        if (it + 1) % ct == 0 and int(s["active"].item()) == 0:
            break
    extra = {}
    if carry is not None:
        extra = {name: s["fams"][2 * k + 1]
                 for k, name in enumerate(_FAMILY_DUALS) if fam[k]}
        if s["x"] is not None:
            extra.update(x=s["x"], u=s["u"])
        if cons is not None:
            extra.update(zc0=s["zc0"], yc0=s["yc0"])
        if adapt is not None:
            extra.update(rho=s["rho"][None].clone())
    res = s["res"] if adapt is None else torch.cat([s["res"],
                                                     s["rho"][None]])
    return _outputs(s["vnew"], s["znew"], s["g"], s["y"], s["iters"],
                    s["done"], res, carry, extra)


# ------------------------------------------------------------ plain versions

def _sides(fams):
    """The (slack, dual) pairs of the state-side and of the input-side
    families that are on, each in the kernels' order (SOC, hyperplane,
    time-varying hyperplane)."""
    pairs = [(fams[2 * k], fams[2 * k + 1]) for k in range(6)]
    on = lambda side: [p for p in pairs[side::2] if p[0] is not None]
    return on(0), on(1)


def stream_backward_reference(tables, vprev, zprev, g, y, d, done, fams,
                              zc0=None, yc0=None, rho_lane=None, *, N, nx,
                              nu, rho, fam: Families = NO_FAMILIES,
                              adapt: Optional[Adaptive] = None,
                              cons: Optional[Consensus] = None):
    """The backward kernel's plain version: the feedforward d (N-1, nu, B)
    of every lane not ``done`` from its previous slacks ``vprev``
    (N, nx, B) / ``zprev`` (N-1, nu, B), duals ``g``/``y`` and the family
    slacks and duals ``fams`` (the kernel's 12-entry family array); ``d``
    stands for the lanes that are done. The linear cost is formed row by
    row inside the recursion (admm_stream.py:196-253), the family terms
    after the box's, in the arithmetic of
    :func:`~.admm_fused.solve_fused_reference`. With ``cons`` row 0's r
    gains -rho_c (zc0 - yc0) after the families' terms and d[0] takes the
    Quu0_inv gain (:229-239). With ``adapt`` each lane's ``rho_lane`` (B,)
    scales the linear cost, and with drho = rho_lane - rho the terminal
    reference term gains drho (-dPinf^T Xref[N-1]), Kinf^T r gains
    drho dKinf^T r, and under apply_c Quu_inv w and AmBKt p gain drho dC1 w
    and drho dC2 p (:121-191, :203-210). Returns the new d."""
    t = _unpack_tables(tables, nx, nu, N, fam, adapt, cons is not None)
    col = lambda v: v[:, None]
    xf, uf = _sides(fams)
    negxq = -(t["Xref"] * t["Qd"])
    negur = -(t["Uref"] * t["Rd"])
    # -Pinf^T Xref[N-1], summed as admm.update_linear_cost sums it.
    p = col(-(t["Xref"][N - 1] @ t["PinfT"].T.contiguous()))
    if adapt is None:
        rho_b, dr = rho, None
    else:
        rho_b, dr = rho_lane, rho_lane - rho
        p = p + dr * col(-(t["Xref"][N - 1] @ t["dPT"].T.contiguous()))
    p = p - rho_b * (vprev[N - 1] - g[N - 1])
    for slack, dual in xf:
        p = p - rho_b * (slack[N - 1] - dual[N - 1])
    dn = torch.empty_like(d)
    for i in range(N - 2, -1, -1):
        r = col(negur[i]) - rho_b * (zprev[i] - y[i])
        for slack, dual in uf:
            r = r - rho_b * (slack[i] - dual[i])
        first = cons is not None and i == 0
        if first:
            r = r - cons.rho_c * (zc0 - yc0)
        q = col(negxq[i]) - rho_b * (vprev[i] - g[i])
        for slack, dual in xf:
            q = q - rho_b * (slack[i] - dual[i])
        out = t["Mback"] @ p
        bp, ap = out[:nu], out[nu:]
        w = bp + r + col(t["BPf"])
        dn[i] = (t["Quu0"] if first else t["Quu"]) @ w
        kr = t["KinfT"] @ r
        if adapt is not None:
            kr = kr + dr * (t["dKT"] @ r)
            if adapt.apply_c:
                ap = ap + dr * (t["dC2"] @ p)
                dn[i] = dn[i] + dr * (t["dC1"] @ w)
        p = q + ap - kr + col(t["APf"])
    return torch.where(done, d, dn)


def stream_forward_reference(tables, x0, vprev, zprev, vcur, zcur, g, y, d,
                             iters, done, res, fams, x_out=None, u_out=None,
                             vstale=None, zstale=None, zc0=None, yc0=None,
                             offer=None, rho_lane=None, rho_v=None, *, it, N,
                             nx, nu, ct, rho, tol_pri, tol_dua,
                             fam: Families = NO_FAMILIES,
                             adapt: Optional[Adaptive] = None,
                             cons: Optional[Consensus] = None):
    """The forward kernel's plain version for iteration ``it``, on the lanes
    not ``done``: the rollout from x0 (B, nx) with the feedforward ``d``,
    the box projection and dual update from the pre-update duals, each
    family's projection and dual update, and on check iterations the four
    residuals (the dual rows against ``vprev``/``zprev``, or the carried
    ``vstale``/``zstale`` in the stale variant; scaled by rho) and
    convergence (admm_stream.py:474-641). ``x_out``/``u_out``, when given,
    receive the lanes' x/u trajectories. With ``cons`` row 0 rolls out
    with the Kinf0 gain (:496-499), and then every running lane offers
    u[0] + yc0 to its group, a done lane its standing ``offer``; zc0
    becomes the group mean of the offers (summed in lane order, divided by
    G), yc0 moves by u[0] - zc0, and max|u[0] - zc0| < tol_pri joins the
    convergence gate (:553-570), as in
    :func:`~.admm_fused.solve_fused_reference`. A lane that converges
    here stores its offer, which then stands; ``offer`` is written for no
    other lane, as the kernel writes it. With ``adapt`` the rollout gain is
    Kinf x + drho dKinf x (drho = rho_lane - rho), and on an adaptation
    iteration (every ADAPTIVE_RHO_PERIOD-th, it > 0) each running lane's
    ``rho_lane`` and virtual ``rho_v`` move by
    :func:`~.admm_fused._adapt_plain`'s OSQP residuals before the check,
    whose dual rows scale with the new rho (:400-472, :577-621). Returns
    what the kernel writes, as a dict: vcur, zcur, g, y, fams, x_out,
    u_out, iters, done, res, zc0, yc0, offer, rho, rho_v and ``active`` (1
    where a lane still runs after a check iteration, else 0)."""
    t = _unpack_tables(tables, nx, nu, N, fam, adapt, cons is not None)
    col = lambda v: v[:, None]
    active = ~done
    keep = lambda new, old: torch.where(active, new, old)
    if cons is not None:
        # [Kinf0; A], step 0's product, shaped as every other step's.
        Mfwd0 = torch.cat([t["Kinf0"], t["Mfwd"][nu:]])
    dr = None if adapt is None else rho_lane - rho
    x = x0.T
    xs, us, axd = [x], [], []
    for i in range(N - 1):
        out = (Mfwd0 if cons is not None and i == 0 else t["Mfwd"]) @ x
        kx = out[:nu]
        if adapt is not None:
            kx = kx + dr * (t["dK"] @ x)
        u = -kx - d[i]
        s = out[nu:] + t["Bm"] @ u
        x = s + col(t["f"])
        xs.append(x)
        us.append(u)
        if adapt is not None:
            axd.append(s - x)
    xs, us = torch.stack(xs), torch.stack(us)
    vn = torch.minimum(t["xmax"][:, :, None],
                       torch.maximum(t["xmin"][:, :, None], xs + g))
    zn = torch.minimum(t["umax"][:, :, None],
                       torch.maximum(t["umin"][:, :, None], us + y))
    gn, yn = g + xs - vn, y + us - zn
    new_fams = list(fams)
    for k, proj in enumerate(_family_projectors(t, fam)):
        if proj is not None:
            prim, slack, dual = (xs, us)[k % 2], fams[2 * k], fams[2 * k + 1]
            sn = proj(prim + dual)
            new_fams[2 * k] = keep(sn, slack)
            new_fams[2 * k + 1] = keep(dual + prim - sn, dual)
    rho_b = rho
    if adapt is not None:
        if it > 0 and it % ADAPTIVE_RHO_PERIOD == 0:
            rho_lane, rho_v = _adapt_plain(
                t, adapt, xs, us, torch.stack(axd), vn, zn, gn, yn, dr,
                rho_lane, rho_v, active)
        rho_b = rho_lane
    out = dict(vcur=keep(vn, vcur), zcur=keep(zn, zcur), g=keep(gn, g),
               y=keep(yn, y), fams=new_fams,
               x_out=None if x_out is None else keep(xs, x_out),
               u_out=None if u_out is None else keep(us, u_out),
               iters=keep(torch.full_like(iters, it + 1), iters), done=done,
               res=res, zc0=zc0, yc0=yc0, offer=offer, rho=rho_lane,
               rho_v=rho_v,
               active=torch.zeros(1, dtype=torch.int32, device=x0.device))
    if cons is not None:
        offers = keep(us[0] + yc0, offer)
        zc0n = _group_mean(offers, cons.group)
        cres = torch.amax(torch.abs(us[0] - zc0n), dim=0)
        out.update(zc0=keep(zc0n, zc0), yc0=keep(yc0 + us[0] - zc0n, yc0))
    if (it + 1) % ct == 0:
        vd, zd = (vprev, zprev) if vstale is None else (vstale, zstale)
        rows = torch.stack([
            torch.amax(torch.abs(xs - vn), dim=(0, 1)),
            torch.amax(torch.abs(us - zn), dim=(0, 1)),
            torch.amax(torch.abs(vd - vn), dim=(0, 1)) * rho_b,
            torch.amax(torch.abs(zd - zn), dim=(0, 1)) * rho_b])
        ok = ((rows[0] < tol_pri) & (rows[1] < tol_pri)
              & (rows[2] < tol_dua) & (rows[3] < tol_dua))
        if cons is not None:
            ok = ok & (cres < tol_pri)
        out.update(res=keep(rows, res), done=done | (ok & active),
                   active=(active & ~ok).any().to(torch.int32).reshape(1))
        if cons is not None:
            out.update(offer=torch.where(ok & active, offers, offer))
    return out


class _PLAIN:
    """Launches of the plain versions on the working arrays ``s`` of
    :func:`_init`, which they update as the kernels do."""

    def __init__(self, tables, x0, s, carry, N, nx, nu, **params):
        self.tables, self.x0, self.s, self.carry = tables, x0, s, carry
        self.dims = dict(N=N, nx=nx, nu=nu)
        self.params = params

    def backward(self, prev):
        s, p = self.s, self.params
        s["d"] = stream_backward_reference(
            self.tables, s["vnew"][prev], s["znew"][prev], s["g"], s["y"],
            s["d"], s["done"], s["fams"], s["zc0"], s["yc0"], s["rho"],
            rho=p["rho"], fam=p["fam"], adapt=p["adapt"], cons=p["cons"],
            **self.dims)

    def forward(self, it, stale):
        s, cur = self.s, it % 2
        stale_vz = (self.carry.v, self.carry.z) if stale else (None, None)
        out = stream_forward_reference(
            self.tables, self.x0, s["vnew"][1 - cur], s["znew"][1 - cur],
            s["vnew"][cur], s["znew"][cur], s["g"], s["y"], s["d"],
            s["iters"], s["done"], s["res"], s["fams"], s["x"], s["u"],
            *stale_vz, s["zc0"], s["yc0"], s["offer"], s["rho"],
            s["rho_v"], it=it, **self.dims, **self.params)
        s["vnew"][cur], s["znew"][cur] = out["vcur"], out["zcur"]
        for k in ("g", "y", "fams", "iters", "done", "res", "active", "zc0",
                  "yc0", "offer", "rho", "rho_v"):
            s[k] = out[k]
        s["x"], s["u"] = out["x_out"], out["u_out"]


# ------------------------------------------------------------ CUDA kernels

class _StreamConsensus(ctypes.Structure):
    """``StreamConsensus`` of csrc/admm_stream.cu: the group size and rho_c,
    and each lane's slack, dual and standing offer, (nu, B) each."""

    _fields_ = [("group", ctypes.c_int), ("rho_c", ctypes.c_float),
                ("zc0", _PTR), ("yc0", _PTR), ("offer", _PTR)]


def _kernel_fns():
    """The C entry points of csrc/admm_stream.cu, built and loaded on first
    use: (backward, forward)."""
    lib = _build.load(KERNEL)
    if lib.tinympc_stream_block() != admm_fused.BLOCK:
        raise RuntimeError("csrc/admm_stream.cu and admm_fused.BLOCK disagree "
                           "on the block size")
    bwd, fwd = lib.tinympc_stream_backward, lib.tinympc_stream_forward
    cons = ctypes.POINTER(_StreamConsensus)
    adapt = ctypes.POINTER(_AdaptArgs)
    # nx nu N B | counts | rho | tables vprev zprev g y d done active |
    # family array | consensus arguments | adaptive-rho arguments | the
    # stream
    bwd.argtypes = ([ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_float]
                    + [_PTR] * 8 + [_PTRS, cons, adapt, _PTR])
    # stale nx nu N B it ct | counts | rho tol_pri tol_dua | tables x0 |
    # prev array | vcur zcur g y d iters done res active | family array |
    # x_out u_out | consensus arguments | adaptive-rho arguments | the
    # stream
    fwd.argtypes = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
                    + [ctypes.c_float] * 3 + [_PTR] * 2 + [_PTRS]
                    + [_PTR] * 9 + [_PTRS] + [_PTR] * 2 + [cons, adapt, _PTR])
    bwd.restype = fwd.restype = ctypes.c_int
    return bwd, fwd


def _team_fns():
    """The C entries of the launches on lane teams (box problems at fixed
    or adaptive rho; csrc/admm_stream_team.cuh), built and loaded on first
    use: (backward, forward)."""
    lib = _build.load(KERNEL)
    bwd = lib.tinympc_stream_backward_team
    fwd = lib.tinympc_stream_forward_team
    adapt = ctypes.POINTER(_AdaptArgs)
    # nx nu N B | rho | tables vprev zprev g y d done active | adaptive-rho
    # arguments | the stream
    bwd.argtypes = [ctypes.c_int] * 4 + [ctypes.c_float] + [_PTR] * 8 + [
        adapt, _PTR]
    # nx nu N B it ct | rho tol_pri tol_dua | tables x0 vd zd vcur zcur g y
    # d iters done res active | adaptive-rho arguments | the stream
    fwd.argtypes = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [_PTR] * 13 \
        + [adapt, _PTR]
    bwd.restype = fwd.restype = ctypes.c_int
    return bwd, fwd


def _team_families_fns():
    """The C entries of the launches on lane teams of problems with
    families at fixed rho (csrc/admm_stream_team.cuh), built and loaded on
    first use: (backward, forward)."""
    lib = _build.load(KERNEL)
    bwd = lib.tinympc_stream_backward_team_families
    fwd = lib.tinympc_stream_forward_team_families
    # nx nu N B | counts | rho | tables vprev zprev g y d done active |
    # family array | the stream
    bwd.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int),
                                         ctypes.c_float] + [_PTR] * 8 + [
        _PTRS, _PTR]
    # nx nu N B it ct | counts | rho tol_pri tol_dua | tables x0 vd zd vcur
    # zcur g y d iters done res active | family array | x_out u_out | the
    # stream
    fwd.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_float] * 3 + [_PTR] * 13 + [_PTRS] + [_PTR] * 3
    bwd.restype = fwd.restype = ctypes.c_int
    return bwd, fwd


def _team_consensus_fns():
    """The C entries of the launches on lane teams of consensus problems at
    fixed rho, with or without families (csrc/admm_stream_team.cuh), built
    and loaded on first use: (backward, forward, fits), ``fits(nx, nu,
    counts, cluster)`` whether the card holds a cluster of that many blocks
    of the forward launch (raises on a failed query). The library's lanes
    and largest cluster are held against :func:`team_lanes` and
    :data:`TEAM_MAX_CLUSTER` when it is loaded."""
    lib = _build.load(KERNEL)
    if lib.tinympc_stream_team_max_cluster() != TEAM_MAX_CLUSTER or any(
            lib.tinympc_stream_team_lanes(nx, nu) != team_lanes(nx)
            for nx, nu in admm_fused.FAMILY_KERNEL_DIMS):
        raise RuntimeError("csrc/admm_stream.cu and kernels/admm_stream.py "
                           "disagree on the team lanes or clusters")
    bwd = lib.tinympc_stream_backward_team_consensus
    fwd = lib.tinympc_stream_forward_team_consensus
    occ = lib.tinympc_stream_team_cluster_occupancy
    cons = ctypes.POINTER(_StreamConsensus)
    # nx nu N B | counts | rho | tables vprev zprev g y d done active |
    # family array | consensus arguments | the stream
    bwd.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int),
                                         ctypes.c_float] + [_PTR] * 8 + [
        _PTRS, cons, _PTR]
    # nx nu N B it ct | counts | rho tol_pri tol_dua | tables x0 vd zd vcur
    # zcur g y d iters done res active | family array | x_out u_out |
    # consensus arguments | the stream
    fwd.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_float] * 3 + [_PTR] * 13 + [_PTRS] + [_PTR] * 2 + [cons,
                                                                   _PTR]
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int]
    bwd.restype = fwd.restype = occ.restype = ctypes.c_int

    def fits(nx, nu, counts, cluster):
        n = occ(nx, nu, counts, cluster)
        if n < 0:
            raise RuntimeError(f"admm_stream cluster occupancy query "
                               f"failed: CUDA error {-n}")
        return n > 0

    return bwd, fwd, fits


class _KERNELS:
    """Launches of csrc/admm_stream.cu on the working arrays ``s`` of
    :func:`_init`, on the current stream of x0's device; each adds one to
    its instantiation's entry of ``launch_counts``. A box problem (no
    family, no consensus), at fixed or adaptive rho, runs both launches on
    lane teams (``tinympc_stream_backward_team``,
    ``tinympc_stream_forward_team``), and so does a problem with families
    at fixed rho without consensus (``tinympc_stream_backward_team_families``,
    ``tinympc_stream_forward_team_families``, counted under the keys with
    ``_team_families``) and a consensus problem, with families or not
    (``tinympc_stream_backward_team_consensus``,
    ``tinympc_stream_forward_team_consensus``, counted under the keys with
    ``_team_consensus``; ``cluster`` the blocks of a group's cluster, 1 in
    a block) unless its group's cluster cannot be formed
    (:func:`team_consensus_route`); ``team`` holds the pair, ``kind`` says
    which (``"box"``, ``"families"``, ``"consensus"``). Families under
    adaptive rho, the consensus groups the route turns away, and every
    problem at ``admm_fused.THREAD_KERNEL_DIMS`` (which have no team
    entries) run the one-thread entries. ``team=False`` sends every
    problem's launches to the one-thread entries, on the same state: the
    in-process A/B of the two designs."""

    def __init__(self, tables, x0, s, carry, N, nx, nu, *, rho, ct, tol_pri,
                 tol_dua, fam, adapt=None, cons=None, team=True):
        dev, B = x0.device, x0.shape[0]
        _check_arg(x0, (B, nx), torch.float32, dev)
        ntab = sum(math.prod(shape) for _, shape in _table_layout(
            nx, nu, N, fam, adapt, cons is not None))
        _check_arg(tables, (ntab,), torch.float32, dev)
        self.tables, self.x0, self.s, self.carry = tables, x0, s, carry
        self.N, self.nx, self.nu, self.B = N, nx, nu, B
        self.rho, self.ct, self.tol_pri, self.tol_dua = rho, ct, tol_pri, \
            tol_dua
        self.counts = (ctypes.c_int * 6)(*fam)
        self.cons, self.adapt, self.suffix = None, None, ""
        if cons is not None:
            for k in ("zc0", "yc0", "offer"):
                _check_arg(s[k], (nu, B), torch.float32, dev)
            self.cons = ctypes.byref(_StreamConsensus(
                cons.group, cons.rho_c, s["zc0"].data_ptr(),
                s["yc0"].data_ptr(), s["offer"].data_ptr()))
            self.suffix = "_consensus"
        self.bwd, self.fwd = _kernel_fns()
        self.families = any(fam)
        self.team, self.kind, self.cluster = None, None, None
        team = team and (nx, nu) not in admm_fused.THREAD_KERNEL_DIMS
        if team and cons is not None:
            bwd, fwd, fits = _team_consensus_fns()
            self.cluster = team_consensus_route(
                cons.group, nx, lambda c: fits(nx, nu, self.counts, c))
            if self.cluster is not None:
                self.team, self.kind = (bwd, fwd), "consensus"
        elif team and not self.families:
            self.team, self.kind = _team_fns(), "box"
        elif team and adapt is None:
            self.team, self.kind = _team_families_fns(), "families"
        if adapt is not None:
            # Each lane's rho is read and written in place (rho_in and
            # rho_out the same array), beside its virtual rho; the scratch
            # holds the rows of an adaptation iteration for the one-thread
            # forward kernel, as in the resident kernel (the team kernels
            # fold the adaptation into their sweep and keep none).
            for k in ("rho", "rho_v"):
                _check_arg(s[k], (B,), torch.float32, dev)
            kw = dict(dtype=torch.float32, device=dev)
            self.scratch = [] if self.team is not None else [
                torch.empty(shape, **kw) for shape in (
                    (N, nx, B), (N - 1, nu, B), (N - 1, nx, B))]
            self.adapt = ctypes.byref(_AdaptArgs(
                int(adapt.apply_c), int(adapt.clip), adapt.rho_min,
                adapt.rho_max, adapt.rho_tol, s["rho"].data_ptr(),
                s["rho"].data_ptr(),
                *([a.data_ptr() for a in self.scratch] or [None] * 3),
                s["rho_v"].data_ptr()))
            self.suffix = "_adaptive"
        with torch.cuda.device(dev):
            self.stream = torch.cuda.current_stream(dev).cuda_stream

    def backward(self, prev):
        s = self.s
        if self.kind == "consensus":
            err = self.team[0](self.nx, self.nu, self.N, self.B, self.counts,
                               self.rho, self.tables.data_ptr(),
                               s["vnew"][prev].data_ptr(),
                               s["znew"][prev].data_ptr(),
                               *(s[k].data_ptr() for k in (
                                   "g", "y", "d", "done", "active")),
                               _ptr_array(s["fams"]), self.cons, self.stream)
            if err != 0:
                raise RuntimeError(f"admm_stream team consensus backward "
                                   f"launch failed: CUDA error {err}")
            launch_counts["backward_team_consensus"] += 1
            return
        if self.kind == "families":
            err = self.team[0](self.nx, self.nu, self.N, self.B, self.counts,
                               self.rho, self.tables.data_ptr(),
                               s["vnew"][prev].data_ptr(),
                               s["znew"][prev].data_ptr(),
                               *(s[k].data_ptr() for k in (
                                   "g", "y", "d", "done", "active")),
                               _ptr_array(s["fams"]), self.stream)
            if err != 0:
                raise RuntimeError(f"admm_stream team backward launch "
                                   f"failed: CUDA error {err}")
            launch_counts["backward_team_families"] += 1
            return
        if self.team is not None:
            err = self.team[0](self.nx, self.nu, self.N, self.B, self.rho,
                               self.tables.data_ptr(),
                               s["vnew"][prev].data_ptr(),
                               s["znew"][prev].data_ptr(),
                               *(s[k].data_ptr() for k in (
                                   "g", "y", "d", "done", "active")),
                               self.adapt, self.stream)
            if err != 0:
                raise RuntimeError(f"admm_stream team backward launch "
                                   f"failed: CUDA error {err}")
            launch_counts["backward_team" + self.suffix] += 1
            return
        err = self.bwd(self.nx, self.nu, self.N, self.B, self.counts,
                       self.rho, self.tables.data_ptr(),
                       s["vnew"][prev].data_ptr(), s["znew"][prev].data_ptr(),
                       s["g"].data_ptr(), s["y"].data_ptr(),
                       s["d"].data_ptr(), s["done"].data_ptr(),
                       s["active"].data_ptr(), _ptr_array(s["fams"]),
                       self.cons, self.adapt, self.stream)
        if err != 0:
            raise RuntimeError(f"admm_stream backward launch failed: CUDA "
                               f"error {err}")
        launch_counts["backward" + self.suffix] += 1

    def forward(self, it, stale):
        if self.team is not None:
            return self._forward_team(it, stale)
        s, cur = self.s, it % 2
        prev = [s["vnew"][1 - cur], s["znew"][1 - cur]]
        prev += [self.carry.v, self.carry.z] if stale else [None, None]
        err = self.fwd(int(stale), self.nx, self.nu, self.N, self.B, it,
                       self.ct, self.counts, self.rho, self.tol_pri,
                       self.tol_dua, self.tables.data_ptr(),
                       self.x0.data_ptr(), _ptr_array(prev),
                       s["vnew"][cur].data_ptr(), s["znew"][cur].data_ptr(),
                       *(s[k].data_ptr() for k in ("g", "y", "d", "iters",
                                                   "done", "res", "active")),
                       _ptr_array(s["fams"]),
                       None if s["x"] is None else s["x"].data_ptr(),
                       None if s["u"] is None else s["u"].data_ptr(),
                       self.cons, self.adapt, self.stream)
        if err != 0:
            raise RuntimeError(f"admm_stream forward launch failed: CUDA "
                               f"error {err}")
        launch_counts["forward" + self.suffix + ("_stale" if stale else "")] \
            += 1

    def _forward_team(self, it, stale):
        s, cur = self.s, it % 2
        vd, zd = (self.carry.v, self.carry.z) if stale else \
            (s["vnew"][1 - cur], s["znew"][1 - cur])
        if self.kind == "consensus":
            err = self.team[1](self.nx, self.nu, self.N, self.B, it, self.ct,
                               self.counts, self.rho, self.tol_pri,
                               self.tol_dua, self.tables.data_ptr(),
                               self.x0.data_ptr(), vd.data_ptr(),
                               zd.data_ptr(), s["vnew"][cur].data_ptr(),
                               s["znew"][cur].data_ptr(),
                               *(s[k].data_ptr() for k in (
                                   "g", "y", "d", "iters", "done", "res",
                                   "active")),
                               _ptr_array(s["fams"]),
                               None if s["x"] is None else s["x"].data_ptr(),
                               None if s["u"] is None else s["u"].data_ptr(),
                               self.cons, self.stream)
            if err != 0:
                raise RuntimeError(f"admm_stream team consensus forward "
                                   f"launch failed: CUDA error {err}")
            launch_counts["forward_team_consensus"
                          + ("_stale" if stale else "")] += 1
            return
        if self.kind == "families":
            err = self.team[1](self.nx, self.nu, self.N, self.B, it, self.ct,
                               self.counts, self.rho, self.tol_pri,
                               self.tol_dua, self.tables.data_ptr(),
                               self.x0.data_ptr(), vd.data_ptr(),
                               zd.data_ptr(), s["vnew"][cur].data_ptr(),
                               s["znew"][cur].data_ptr(),
                               *(s[k].data_ptr() for k in (
                                   "g", "y", "d", "iters", "done", "res",
                                   "active")),
                               _ptr_array(s["fams"]),
                               None if s["x"] is None else s["x"].data_ptr(),
                               None if s["u"] is None else s["u"].data_ptr(),
                               self.stream)
            if err != 0:
                raise RuntimeError(f"admm_stream team forward launch "
                                   f"failed: CUDA error {err}")
            launch_counts["forward_team_families"
                          + ("_stale" if stale else "")] += 1
            return
        err = self.team[1](self.nx, self.nu, self.N, self.B, it, self.ct,
                           self.rho, self.tol_pri, self.tol_dua,
                           self.tables.data_ptr(), self.x0.data_ptr(),
                           vd.data_ptr(), zd.data_ptr(),
                           s["vnew"][cur].data_ptr(),
                           s["znew"][cur].data_ptr(),
                           *(s[k].data_ptr() for k in (
                               "g", "y", "d", "iters", "done", "res",
                               "active")),
                           self.adapt, self.stream)
        if err != 0:
            raise RuntimeError(f"admm_stream team forward launch failed: "
                               f"CUDA error {err}")
        launch_counts["forward_team" + self.suffix
                      + ("_stale" if stale else "")] += 1
