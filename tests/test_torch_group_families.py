"""The constraint families beyond the box, at fixed and adaptive rho, and
every problem at (6, 3), on the thread-group kernel (csrc/admm_group.cu's
families kinds with admm_group.cuh's GroupFamilies), emulated on the CPU
in its own layout, and its launch glue.

The emulation is tests/test_torch_group_consensus.py's ``group_solve``
with families: each problem's exchange slot padded to whole float4s (at
(6, 3): x in 8 floats, r and w in 4 each), a row a thread of a group of
16 (of 8 at (6, 3), thread 0 owning rows 0 and 8, whose projections take
steps g, g + 8, ...); each family that is on a (slack, dual) column pair
a row of its side and step in the block's family arena, after the
feedforward (``FamilyArena``), seeded from x0, the carried x/u and duals;
each row's linear cost less its families' rho (slack - dual) after the
box's, the terminal state row's too; the forward sweep leaves x[i] / u[i]
in the slack of its side's first family, and thread g of the group then
projects steps g, g + G, ...: each side's whole candidate x + dual, family
0 last; a warm solve hands back the duals and the x/u of the last
iteration each problem ran, its rollout re-run with that iteration's d
(and drho dKinf x under adaptive rho).

It is held bitwise against the kernel's plain version
(``solve_fused_reference`` / ``solve_fused_warm_reference``), cold and
warm, at PLACE_SHARED and PLACE_SAVED_GLOBAL: the rocket's cones at
(6, 3), the quadrotor's static and time-varying hyperplanes at (12, 4),
every family on both sides, the rocket's box alone (a box problem at
(6, 3)) at fixed and adaptive rho, adaptive rho with apply_c and the guard
from rho 1000; against the JAX package's fused kernel in interpret mode at
the bars of tests/test_torch_families_fused.py and
tests/test_torch_adaptive_families.py; the launch glue against a stand-in
for tinympc_admm_group_families that runs the emulation through its
pointers; the route rule for each family mix at both (nx, nu): the
horizon cutoff, and what stays on csrc/admm_fused.cu; and the horizons at
which a loaded library's counts of the families arenas are held. The CUDA kernel runs
on the card only (chip_smoke.py phases 9-12, 33-34, 41; chip_compare.py).
"""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from tinympc_tpu.kernels import solve_fused as jax_solve_fused

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.kernels import admm_fused, init_carry
from tinympc_tpu_torch.kernels.admm_fused import (
    PLACE_SAVED_GLOBAL, PLACE_SHARED, PLACE_TABLE_GLOBAL, Adaptive,
    Consensus, Families, FusedCarry, group_arena_floats, group_geometry,
    group_route)
from test_torch_group_consensus import (Slot, _view, assert_bitwise,
                                        group_solve)
from test_torch_stream_team import sqrt_rn
from test_torch_stream_team_families import _inputs, _problem
import test_torch_adaptive_families as taf
import test_torch_families_fused as tff

torch.set_num_threads(1)

N = 6


@pytest.fixture(autouse=True)
def _rounded_sqrt(monkeypatch):
    """The plain version's float32 root correctly rounded, as the card's
    sqrt_rn is (torch's vectorised CPU root is not always)."""
    raw = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: sqrt_rn(x)
                        if x.dtype == torch.float32 else raw(x, *a, **k))


def emulate(prob, Xref, Uref, x0, carry=None, P=8, place=PLACE_SHARED):
    """The emulation on a problem's packed inputs."""
    tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x0)
    spec = prob.spec
    if carry is not None:
        carry = admm_fused._carry_tensors(prob, carry, x0c.shape[0])
    out = group_solve(tables, x0c, spec.N, spec.nx, spec.nu, carry=carry,
                      P=P, place=place, **params)
    return out if carry is not None else out[:2]


def _sequence(prob, Xref, Uref, x, place, steps=2):
    """A cold solve, then ``steps`` warm solves of an external plant (the
    last with final=True): each bitwise the plain version's."""
    assert_bitwise(emulate(prob, Xref, Uref, x, place=place),
                   tt.kernels.solve_fused_reference(prob, Xref, Uref, x))
    c_e = c_p = init_carry(prob, x.shape[0])
    for step in range(steps):
        got = emulate(prob, Xref, Uref, x, c_e, place=place)
        want = tt.kernels.solve_fused_warm_reference(
            prob, Xref, Uref, x, c_p, final=step == steps - 1)
        assert_bitwise(got, want)
        c_e, c_p = got[2], want[2]
        x = x @ prob.A.T + got[0].u[0] @ prob.B.T + prob.f
    return got


# ------------------------------------------------------------ bitwise

@pytest.mark.parametrize("case,place", [
    ("soc", PLACE_SHARED), ("linear", PLACE_SHARED),
    ("tv", PLACE_SAVED_GLOBAL), ("mixed", PLACE_SAVED_GLOBAL)])
def test_emulation_is_bitwise_the_plain_solve(case, place):
    """The rocket's cones (6, 3), the quadrotor's static and time-varying
    planes under low ceilings and every family on both sides (12, 4), B=13
    (a ragged second block), ct 1: a cold solve and two warm solves of an
    external plant, every output and carry field (each family's dual, x/u)
    bitwise the plain version's."""
    prob = _problem(case, N, max_iter=25)
    x, Xref, Uref = _inputs(case, N, 13, seed=2)
    got = _sequence(prob, Xref, Uref, x, place)
    assert got[2].x is not None and got[2].u is not None


@pytest.mark.parametrize("case,place", [
    ("soc_apply_c", PLACE_SAVED_GLOBAL), ("tv_guard", PLACE_SHARED),
    ("box63", PLACE_SHARED)])
def test_adaptive_emulation_is_bitwise_the_plain_solve(case, place):
    """tests/test_torch_adaptive_families.py's rocket cones with apply_c,
    time-varying planes under the guard from rho 1000 and the rocket's box
    alone (a box problem at (6, 3)) at adaptive rho, B=13 (a ragged second
    block), max_iter 15 (adaptations at iterations 5 and 10): cold and a
    warm solve (final=True), rho riding the carry, bitwise the plain
    version's (the final rho row and the carried rho too); and the box at
    fixed rho."""
    prob = taf._port(taf._jax_problem(case, max_iter=15))
    x0, Xref, Uref = (None if a is None else torch.as_tensor(a)
                      for a in taf._inputs(case, seed=4))
    x = torch.cat([x0, x0[:5] * 1.01])
    got = _sequence(prob, Xref, Uref, x, place, steps=1)
    assert torch.equal(got[2].rho[0], got[1][4])
    if case == "box63":
        fixed = tt.with_settings(prob, adaptive_rho=False)
        _sequence(fixed, Xref, Uref, x, place, steps=1)


# ------------------------------------------------------------ JAX

@pytest.mark.parametrize("case", ["soc"])
def test_emulation_matches_the_jax_kernel(case):
    """tests/test_torch_families_fused.py's cold case of the rocket's cones
    (B=8, max_iter 20): the emulation against the JAX fused kernel in
    interpret mode at that file's bar -- atol 2e-4 on x, u and the
    residuals, counts within 1, equal solved flags."""
    pj = tff._jax_problem(case, 20)
    x0, Xref, Uref = tff._inputs(case, 8, seed=1)
    sol_j, res_j = jax_solve_fused(pj, tff._j(Xref), tff._j(Uref),
                                   tff._j(x0), tile=8, interpret=True)
    sol_e, res_e = emulate(tff._port(pj), tff._t(Xref), tff._t(Uref),
                           tff._t(x0))
    atol = tff.BAR[case]
    for got, want in ((sol_e.x, sol_j.x), (sol_e.u, sol_j.u),
                      (res_e, res_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    assert np.all(np.abs(sol_e.iter.numpy() - np.asarray(sol_j.iter)) <= 1)
    np.testing.assert_array_equal(sol_e.solved.numpy(),
                                  np.asarray(sol_j.solved))


def test_adaptive_emulation_matches_the_jax_kernel():
    """tests/test_torch_adaptive_families.py's rocket cones with apply_c
    (B=8, max_iter 20): the emulation against the JAX fused kernel in
    interpret mode at that file's bar -- atol 5e-4 (rtol 5e-6) on x and u,
    final rho rtol 1e-3, counts within 2; rho has moved."""
    pj = taf._jax_problem("soc_apply_c")
    pt = taf._port(pj)
    x0, Xref, Uref = taf._inputs("soc_apply_c", seed=1)
    sol_j, res_j = jax_solve_fused(pj, taf._j(Xref), taf._j(Uref),
                                   taf._j(x0), tile=taf.B, interpret=True)
    sol_e, res_e = emulate(pt, taf._t(Xref), taf._t(Uref), taf._t(x0))
    for got, want in ((sol_e.x, sol_j.x), (sol_e.u, sol_j.u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-6,
                                   atol=5e-4)
    np.testing.assert_allclose(res_e[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_e.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    assert np.any(np.abs(res_e[4].numpy() - float(pt.cache.rho)) > 1e-3)


# ------------------------------------------------------------ geometry

def test_family_arena_and_slots():
    """The slot pads x, r / u and w to whole float4s (20 floats at
    (12, 4), as before; 16 at (6, 3), 24 with the g slot); the families
    kinds' arena adds, from a 16-byte boundary, a (slack, dual) pair a row
    of each family that is on, and their table the family tables; a
    box-only problem at (6, 3) adds none."""
    for nx, nu, want in ((12, 4, 20), (6, 3, 16)):
        slot = Slot(1, nx, nu)
        assert (slot.uo, slot.wo, slot.buf.shape[1]) == (
            -(-nx // 4) * 4, -(-nx // 4) * 4 + -(-nu // 4) * 4, want)
        for kind, extra in (("families", 0), ("families_adaptive_c",
                                               -(-nx // 4) * 4)):
            base = group_arena_floats(10, 8, True, nx, nu, kind)
            assert base == 8 * (want + extra) + 3 * 10 * 8 * (nx + nu) \
                + 9 * 8 * nu
    fam = Families(ncx=2, ncu=1, nlx=1, ntu=2)
    for N_, P, saved in ((10, 8, False), (21, 3, True)):
        base = group_arena_floats(N_, P, saved, 6, 3, "families")
        assert group_arena_floats(N_, P, saved, 6, 3, "families", fam) == \
            -(-base // 4) * 4 + 2 * P * (N_ * 6 * 2 + (N_ - 1) * 3 * 2)
        assert group_arena_floats(N_, P, saved, 6, 3, "box", fam) == base
    assert admm_fused._group_table(10, 6, 3, "families", fam) == \
        admm_fused._table_floats(6, 3, 10, fam)
    assert admm_fused._group_table(10, 6, 3, "families_adaptive", fam) == \
        admm_fused._table_floats(6, 3, 10, fam, Adaptive(
            False, False, 0.0, 0.0, 1.0))

    def count(N_, P, place, warm, kind, fam, extra=0):
        save = warm and place != PLACE_SAVED_GLOBAL
        table = admm_fused._group_table(N_, 12, 4, kind, fam)
        return 4 * ((-(-table // 4) * 4 if place == PLACE_SHARED else 0)
                    + group_arena_floats(N_, P, save, 12, 4, kind, fam)
                    + extra)

    six = Families(1, 1, 1, 1, 1, 1)
    admm_fused.check_group_geometry(
        lambda N_, P, place, warm: count(N_, P, place, warm, "families",
                                         six),
        group_kind="families", fam=six, horizons=range(2, 460, 7))
    with pytest.raises(RuntimeError, match="kind families"):
        admm_fused.check_group_geometry(
            lambda N_, P, place, warm: count(N_, P, place, warm, "families",
                                             six, extra=int(N_ > 300)),
            group_kind="families", fam=six, horizons=range(2, 460, 7))


@pytest.mark.parametrize("nx,nu", [(12, 4), (6, 3)])
def test_family_horizons_hold_every_change_of_geometry(nx, nu):
    """The horizons at which the library's counts of a families launch are
    held at load: every horizon where the launch's P or place changes,
    cold or warm, the one before it, the last horizon with a group launch
    and the next, and the first and last horizons the one-thread kernel
    takes; a count one float off past N=300 is caught there."""
    adapt = Adaptive(True, False, 0.0, 0.0, 1.0)
    for kind, fam in (("families", Families(1, 1, 1, 1, 1, 1)),
                      ("families_adaptive_c", Families(ncx=1, ncu=1))):
        got = set(admm_fused.family_horizons(nx, nu, kind, fam))
        top = max(N for N in range(2, 3000) if admm_fused.smem_bytes(
            nx, nu, N, fam, adapt if "adaptive" in kind else None)
            <= admm_fused.SMEM_LIMIT)
        assert {2, top} <= got and max(got) == top
        for save in (False, True):
            def place(N_):
                try:
                    return group_geometry(N_, save, None, nx, nu, kind,
                                          fam=fam)[:2]
                except ValueError:
                    return None
            seen = [place(N_) for N_ in range(2, top + 1)]
            changes = [N_ for N_ in range(3, top + 1)
                       if seen[N_ - 2] != seen[N_ - 3]]
            assert changes and {N_ - d for N_ in changes for d in (0, 1)} \
                <= got
            if None in seen:
                cut = seen.index(None) + 1
                assert {cut, cut + 1} <= got
        table = lambda N_: admm_fused._group_table(N_, nx, nu, kind, fam)
        count = lambda N_, P, place, warm, extra=0: 4 * (
            (-(-table(N_) // 4) * 4 if place == PLACE_SHARED else 0)
            + group_arena_floats(N_, P, warm and place != PLACE_SAVED_GLOBAL,
                                 nx, nu, kind, fam) + extra)
        horizons = sorted(got)
        admm_fused.check_group_geometry(count, nx=nx, nu=nu, group_kind=kind,
                                        fam=fam, horizons=horizons)
        with pytest.raises(RuntimeError, match=f"kind {kind}"):
            admm_fused.check_group_geometry(
                lambda N_, P, place, warm: count(N_, P, place, warm,
                                                 int(N_ > 300)),
                nx=nx, nu=nu, group_kind=kind, fam=fam, horizons=horizons)


FAMILY_MIXES = [Families(ncx=1), Families(ncu=1), Families(nlx=2),
                Families(nlu=1), Families(ntx=1), Families(ntu=1),
                Families(ncx=1, ncu=1), Families(1, 1, 1, 1, 1, 1)]


@pytest.mark.parametrize("nx,nu", [(12, 4), (6, 3)])
def test_route_takes_every_family_mix(nx, nu):
    """Each family alone, the rocket's pair of cones and all six, at fixed
    rho, adaptive rho and apply_c, cold and warm: the families kinds at
    N=10, a block of 128 threads' problems (8 at (12, 4), 16 at (6, 3))
    in shared memory; a box-only problem takes
    them at (6, 3) and the box kinds at (12, 4). Consensus with a family
    or at (6, 3), and a multi-system launch with a family or at (6, 3),
    keep csrc/admm_fused.cu."""
    ad = Adaptive(False, True, 0.05, 100.0, 1.0)
    for fam in FAMILY_MIXES + [admm_fused.NO_FAMILIES]:
        for adapt, kind in ((None, "families"), (ad, "families_adaptive"),
                            (ad._replace(apply_c=True),
                             "families_adaptive_c")):
            box = not any(fam) and (nx, nu) == (12, 4)
            want = kind.replace("families_", "").replace("families", "box") \
                if box else kind
            for warm in (False, True):
                assert group_route(10, nx, nu, fam, adapt, None, warm) == (
                    want, 128 // admm_fused.GROUP_WIDTHS[(nx, nu)],
                    PLACE_SHARED, 1)
            if not box:
                assert group_route(10, nx, nu, fam, adapt, None, False,
                                   multi=True) is None
        cons = Consensus(8, 100.0)
        assert (group_route(10, nx, nu, fam, None, cons, False) is None) \
            == (any(fam) or (nx, nu) == (6, 3))


@pytest.mark.parametrize("nx,nu,fam,last", [
    (12, 4, Families(ncx=1), 968), (12, 4, Families(ncx=2, ncu=1), 854),
    (12, 4, Families(1, 1, 1, 1, 1, 1), 440),
    (12, 4, Families(ncx=2, ncu=1, nlx=1, nlu=1, ntx=2, ntu=1), 440),
    (6, 3, Families(1, 1, 1, 1, 1, 1), 774)])
def test_route_cutoff(nx, nu, fam, last):
    """The last horizon at which one problem's family columns fit a
    block's shared memory (table, and warm the saved columns, in device
    memory, P = 1), cold and warm alike: past it the solve runs
    csrc/admm_fused.cu, which takes every horizon fused_supported takes
    (it refuses none below it)."""
    for warm in (False, True):
        kind, P, place, _ = group_route(last, nx, nu, fam, None, None, warm)
        assert (kind, P) == ("families", 1)
        assert place == (PLACE_SAVED_GLOBAL if warm and nx == 12
                         else PLACE_TABLE_GLOBAL) or nx == 6
        assert group_route(last + 1, nx, nu, fam, None, None, warm) is None
        _, _, smem = group_geometry(last, warm, None, nx, nu, "families",
                                    fam=fam)
        assert smem <= admm_fused.SMEM_LIMIT
    with pytest.raises(ValueError):
        group_geometry(last + 1, False, None, nx, nu, "families", fam=fam)


# ------------------------------------------------------------ launch glue

class Entry:
    """A stand-in for tinympc_admm_group_families: its arguments checked
    and recorded, the emulation run through its pointers."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        assert len(args) == 26
        (warm, nx, nu, P, place, N_, B, max_iter, ct, rho, tol_pri,
         tol_dua, tables, x0, ox, ou, oi, osv, orr, carry, block_sys,
         stride, saved, fam, adapt, stream) = args
        a = fam._obj
        counts = Families(*(getattr(a, n) for n in Families._fields))
        ad = None
        if adapt is not None:
            d = adapt._obj
            ad = Adaptive(bool(d.apply_c), bool(d.clip), d.rho_min,
                          d.rho_max, d.rho_tol)
        assert block_sys is None and (saved is None) == (
            place != PLACE_SAVED_GLOBAL)
        self.calls.append(dict(warm=warm, nx=nx, P=P, place=place,
                               fam=counts, adapt=ad is not None))
        x, u = (N_, nx, B), (N_ - 1, nu, B)
        shape = lambda name: x if name.startswith("g") else u
        c = None
        if warm:
            cin = [_view(carry[k], s) for k, s in enumerate([x, u] * 3)]
            extra = {d_: _view(getattr(a, d_ + "_in"), shape(d_))
                     for d_, n in zip(admm_fused._FAMILY_DUALS, counts) if n}
            if any(counts):
                extra.update(x=_view(a.x_in, x), u=_view(a.u_in, u))
            if ad is not None:
                extra["rho"] = _view(adapt._obj.rho_in, (1, B)).clone()
            c = FusedCarry(vnew=cin[0], znew=cin[1], g=cin[2], y=cin[3],
                           v=cin[4], z=cin[5], **extra)
        sol, res, out = group_solve(
            _view(tables, (stride,)).clone(), _view(x0, (B, nx)).clone(),
            N_, nx, nu, max_iter=max_iter, ct=ct, rho=rho, tol_pri=tol_pri,
            tol_dua=tol_dua, carry=c, fam=counts, adapt=ad, P=P, place=place)
        _view(ox, (N_, B, nx))[:] = sol.x
        _view(ou, (N_ - 1, B, nu))[:] = sol.u
        _view(oi, (B,), ctypes.c_int32)[:] = sol.iter
        _view(osv, (B,), ctypes.c_bool)[:] = sol.solved
        _view(orr, (res.shape[0], B))[:] = res
        if warm:
            for k, f in enumerate(("vnew", "znew", "v", "z", "g", "y")):
                _view(carry[6 + k], x if f in ("vnew", "v", "g")
                      else u)[:] = getattr(out, f)
            for d_, n in zip(admm_fused._FAMILY_DUALS, counts):
                if n:
                    _view(getattr(a, d_ + "_out"), shape(d_))[:] = \
                        getattr(out, d_)
            if any(counts):
                _view(a.x_out, x)[:] = out.x
                _view(a.u_out, u)[:] = out.u
        return 0


@pytest.fixture
def entry(monkeypatch):
    e = Entry()
    monkeypatch.setattr(admm_fused, "_group_policy_fn",
                        lambda kind: e if kind in admm_fused.FAMILY_KINDS
                        else None)
    monkeypatch.setattr(admm_fused, "_group_fn", lambda: None)

    def fused(*a):
        raise AssertionError("a launch reached csrc/admm_fused.cu")

    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda multi=False: fused)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(admm_fused, "entry_counts",
                        dict.fromkeys(admm_fused.entry_counts, 0))
    for k in ("families_launch_count", "families_warm_launch_count",
              "adaptive_families_launch_count",
              "adaptive_families_warm_launch_count"):
        monkeypatch.setattr(admm_fused, k, 0)
    return e


def _through_glue(prob, Xref, Uref, x, steps=2):
    """A cold solve and ``steps`` warm solves through the launch glue, each
    bitwise the plain version's."""
    spec = prob.spec
    tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x)
    got = admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx, spec.nu,
                                   **params)
    assert_bitwise(got, tt.kernels.solve_fused_reference(prob, Xref, Uref,
                                                         x))
    c_k = c_p = init_carry(prob, x.shape[0])
    for _ in range(steps):
        ck = admm_fused._carry_tensors(prob, c_k, x.shape[0])
        got = admm_fused._solve_kernel_warm(tables, x0c, ck, spec.N,
                                            spec.nx, spec.nu, **params)
        want = tt.kernels.solve_fused_warm_reference(prob, Xref, Uref, x,
                                                     c_p)
        assert_bitwise(got, want)
        c_k, c_p = got[2], want[2]


def test_families_take_the_group_entry(entry):
    """Every family on both sides at (12, 4) and the rocket's cones at
    adaptive rho with apply_c at (6, 3): a cold and a warm solve each
    through the launch glue on tinympc_admm_group_families, with the
    counts, 8 problems a block at (12, 4) and 16 at (6, 3) in shared
    memory; every output and carry
    field bitwise the plain version's; counted as families launches."""
    prob = _problem("mixed", N, max_iter=12)
    x, Xref, Uref = _inputs("mixed", N, 9, seed=6)
    _through_glue(prob, Xref, Uref, x, steps=1)
    rocket = taf._port(taf._jax_problem("soc_apply_c", max_iter=12))
    x0, Xr, Ur = (None if a is None else torch.as_tensor(a)
                  for a in taf._inputs("soc_apply_c", seed=5))
    _through_glue(rocket, Xr, Ur, x0, steps=1)
    mixed = admm_fused._families(prob.spec)
    assert [(c["warm"], c["nx"], c["P"], c["place"], c["fam"], c["adapt"])
            for c in entry.calls] == [
        (w, 12, 8, PLACE_SHARED, mixed, False) for w in (0, 1)] + [
        (w, 6, 16, PLACE_SHARED, Families(ncx=1, ncu=1), True)
        for w in (0, 1)]
    assert admm_fused.entry_counts["tinympc_admm_group_families"] == 4
    assert (admm_fused.families_launch_count,
            admm_fused.families_warm_launch_count,
            admm_fused.adaptive_families_launch_count,
            admm_fused.adaptive_families_warm_launch_count) == (1, 1, 1, 1)


def test_long_horizons_take_the_device_memory_places(entry, monkeypatch):
    """The place the route picks past a block's shared memory reaches the
    entry, with its saved-column buffer where the warm solve keeps them in
    device memory: the time-varying planes at (12, 4) pinned to P=1 at
    each place, bitwise the plain version's."""
    prob = _problem("tv", N, max_iter=15)
    x, Xref, Uref = _inputs("tv", N, 5, seed=7)
    route = admm_fused.group_route
    for place in (PLACE_TABLE_GLOBAL, PLACE_SAVED_GLOBAL):
        def pinned(*a, place=place, **k):
            r = route(*a, **k)
            warm = a[6]
            return (r[0], 1, place if warm else PLACE_TABLE_GLOBAL, 1)

        monkeypatch.setattr(admm_fused, "group_route", pinned)
        _through_glue(prob, Xref, Uref, x, steps=1)
    assert [(c["warm"], c["P"], c["place"]) for c in entry.calls] == [
        (0, 1, PLACE_TABLE_GLOBAL), (1, 1, PLACE_TABLE_GLOBAL),
        (0, 1, PLACE_TABLE_GLOBAL), (1, 1, PLACE_SAVED_GLOBAL)]
