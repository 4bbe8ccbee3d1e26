#!/usr/bin/env python3
"""Outputs of the port's fixed-rho kernels on fixed inputs, saved and
compared bitwise: a check that a change left a kernel's results as they
were, across two checkouts on one card.

    python3 chip_compare.py save OUT.pt      # in each checkout, on the GPU
    python3 chip_compare.py diff A.pt B.pt   # anywhere

``save`` runs, at B=1024 with inputs from numpy's default_rng(0), the box
kernel cold and warm (the quadrotor at 20 Hz, N=20), a fleet of two
quadrotor variants cold and over two warm solves (N=10, random
assignments; the multi-system launch), the families kernel
cold and warm (the rocket's cones at N=10; the quadrotor's static and
time-varying hyperplanes under low z ceilings; every family on both sides
at N=16, and at N=420 on 64 lanes, where the group kernel keeps its table
and a warm solve's saved columns in device memory; the rocket's cones at
N=700 on 64 lanes), the families adaptive kernel (the rocket's cones at
N=10 with and without apply_c, adaptive_rho_min 0.05), a box problem at
(6, 3) (the rocket's box alone at N=10, fixed and adaptive rho; all of
these cold and two warm solves), the families kernel with
consensus (128 groups of 8), the resident box consensus kernel (the
quadrotor at N=10, rho_c 100, groups of 1, 2, 8, 16 and 128: cold, two
warm solves and a final=True solve), the resident box adaptive kernel
(N=20, the Crazyflie tables, with and without apply_c, and the guard from
rho 1000 with its own sensitivities; cold and two warm solves; and a
two-system adaptive fleet at N=10, cold and two warm solves), the fused
closed loop (T=10), the streamed
kernels cold and warm (box at N=64, and at N=256 on 256 lanes and N=1300,
past the resident kernel's wall, on 64; the rocket's box alone at N=32, a
box problem at (6, 3); the rocket's cones at N=32 and, 20 iterations, at
N=256 (phase 19's descent); the quadrotor's static and time-varying
hyperplanes under low z ceilings at N=10 (phase 21's), and every family on
both sides at N=16 (``_mixed``); consensus at N=10, and -- cold and two
warm solves -- in groups of 1, 2, 8, 16 and 128 at N=10, of 16 at N=256
on 256 lanes, and the rocket's cones in groups of 8 at N=32; and
with adaptive rho the box at N=64 -- the Crazyflie tables, with and
without apply_c, and the guard at rho 1000 with its own sensitivities --
at N=256 on 256 lanes, at N=1300 on 64, and the rocket's box alone at
N=32), and, at B=64, the long horizons where the thread-group kernels
keep their table and saved columns in device memory (box cold at N=700,
two warm solves at N=1100 and at N=1150, closed loops at N=700 and
N=1150 with T=2), the one-thread kernels' own pairs (cartpole (4, 1) at
N=10 -- box, adaptive rho with apply_c, consensus in groups of 8, a state
hyperplane, a fleet of two variants --, cold and two warm solves, and
streamed at N=64; the degenerate (2, 2), (2, 1), (3, 3), (1, 1) at N=10,
cold and warm), the closed loop on one thread a plant at T=20 (the
rocket's sliding loop with its box alone, cartpole with shift_warm, (2, 1)
with reset_duals), and writes every output and carry field. ``diff`` prints,
for each entry both files hold, whether they hold the same bits, and
names the entries only one holds (a newer checkout's additions); it exits
non-zero when a common entry differs. Two packages cannot share a
process: run ``save`` once per checkout.

    python3 chip_compare.py build OUT.json   # in each checkout, on the GPU
    python3 chip_compare.py diff A.json B.json

``build`` compiles the resident solve's and the closed loop's sources
afresh (csrc/admm_group.cu where the checkout has it -- with its families
kinds, "admm_group families[ adaptive[ apply_c]] cold|warm (nx, nu)[
place]", where the checkout has them --, csrc/admm_fused.cu,
csrc/closed_loop_fused.cu, and csrc/closed_loop_thread.cu where the
checkout has it) and writes, for each of their kernels by
chip_smoke.py's label, the ptxas registers, stack and spills
and a hash of its SASS (cuobjdump -sass, addresses and encodings
dropped; the instructions themselves in OUT.json.sass); ``diff`` of two
such files says, for each label both have, whether the ptxas figures and
the instructions are the same, and exits non-zero when any differs.

    python3 chip_compare.py race             # on the GPU

``race`` runs small streamed solves on lane teams (box problems, and
problems with families or consensus at fixed rho, the consensus groups in
a block and across thread-block clusters) bitwise against the one-thread
kernels, small box consensus solves whose scenario groups
span thread-block clusters bitwise against the one-thread consensus
kernel, and small resident solves with families (and at (6, 3)) on the
thread-group kernel bitwise against csrc/admm_fused.cu (see ``race``);
run it under ``compute-sanitizer --tool racecheck`` to have the team and
group kernels' shared memory checked.

    python3 chip_compare.py time [cold=B,B,...] [warm=B,B,...]
                                 [loop=B,B,...] [stream=B,B,...] [dot]
                                 [cons[=tree,g16]] [adapt[=hard,warm]]
                                 [tloop=B,B,...]
                                 [fam[=soc,soc_warm,linear,tv,adaptive,
                                      adaptive_warm]] [profile]

``time`` times the main path's kernel (bench.py's batch: the quadrotor at
20 Hz, N=20, box +-5 / +-0.5, hover, x0 ~ U[-0.5, 0.5] from
default_rng(0), max_iter 100, check_termination 25) at each batch of
``cold`` (default 32768), the warm solve of the same problem from a zero
carry (``init_carry``) at each batch of ``warm`` (default none), and the
fused closed loop (bench_all.py:569-596:
N=10, hover z=1, x0 ~ U[-0.3, 0.3], T=50, max_iter 100, ct 5) at each
batch of ``loop`` (default none), and the streamed solve's forward
launch (examples/long_horizon.py's size: the quadrotor at N=512, box
+-5 / +-0.5, hover z=1, x0 ~ U[-0.3, 0.3] from default_rng(0), ct 1; and
the rocket with its box alone at N=512, a box problem at (6, 3), x0 the
descent's start times U[0.9, 1.2]; the launch of iteration 0 on a fresh
state after its backward launch, every lane running) with the backward
launch beside it, at each batch of
``stream`` (default none), and the same of the problems with families:
phase 19's rocket with its cones at N=256 (x0 the descent's start times
U[0.9, 1.1]; also the stale forward launch of a warm solve from the carry
of a 20-iteration warm solve from a zero carry) at each batch of
``stream``, and phase 21's static and time-varying planes under low
ceilings at N=10, B=16384 (x0 = [-2, -2, 1, 0...] + 0.1 U[-1, 1]^12, the
demo's step-0 reference window), and consensus at rho_c 100 (the
quadrotor at N=512 as above in groups of 8, 16 and 128 at each batch of
``stream``, and bench_all.py:224-250's G=16 batch at N=10, B=32768, with
its stale launch); each launch in turns with the one-thread
launch on its own fresh state (``_KERNELS(..., team=False)``); with
``stream`` also phase 36's adaptive point (the quadrotor at N=2048 with the Crazyflie
tables, B=1024, x0 ~ U[-0.3, 0.3]): the backward and the forward launch
of iteration 0 and the forward of an adaptation iteration (5), on teams
and on one thread a lane in turns; and with ``dot`` the roofline tool's
independent bf16 dot probe (L=95 dots on the TPU probe's inputs, one rep:
depth 36 on 32768 lanes, depth 96 on 16384) beside one ``torch.matmul`` of
the same sum on float32 and on bf16 operands; with ``cons`` the consensus
solves of chip_smoke.py: ``tree``, the warm solve after the scenario-tree
loop of examples/scenario_tree_mpc.py (256 trees x 8, N=10, max_iter 500,
ct 1, rho_c 100, T=20 steps of the nominal plant re-branched from a
seeded generator; the 21st solve timed), and ``g16``, bench_all.py:224-
250's G=16 batch (2048 x 16, z 0.5, the same settings); with ``adapt``
the adaptive solves: ``hard``, bench_all.py:401-447's hard batch (N=20,
rho0 5, B=32768, x0 ~ U[-0.5, 0.5], z 1, max_iter 500, ct 1, the
sensitivities from compute_sensitivities), and ``warm``, the sixth solve
of phase 16's adaptive external-plant sequence (N=10, B=16384, hover +
U[-0.3, 0.3], max_iter 100, ct 1, five solves before it); with ``fam``
the resident launches of the families of chip_smoke.py phases 10-12 and
34 (B=16384, N=10, max_iter 100, ct 1): ``soc``, the rocket's cones cold;
``soc_warm``, its sixth solve of the external-plant sequence; ``linear``
and ``tv``, the hyperplane demos cold; ``adaptive``, the rocket's cones at
adaptive rho cold, and ``adaptive_warm``, its sixth solve (each with its
torch.profiler device time); with ``tloop`` the closed loop on one thread
a plant at each batch: chip_smoke.py phase 47's rocket loop (T=90, ct 1),
phase 48's cartpole loop (T=50, ct 5) and the (12, 4) instance on the
serving loop of ``loop`` (the A/B of the two designs): ``TIME_REPS``
launches on CUDA events after one to warm up. It prints one JSON line a
configuration with every time, the median, the mean iterations, the time
a lane-iteration (the kernel's time over the iterations its lanes ran,
summed), the card's name
and power limit and its SM clock sampled just after. ``profile`` adds the
device time torch.profiler records for one main-path call at each cold
batch, by kernel, and for each streamed launch (``device_ms``: the
kernel's own time; the events also hold the host's launch path). Run it in alternation (parent, change, change, parent)
to compare two checkouts on one card; for the parent, unpack the parent
commit's tree before the first edit into the ignored ``_checkout/parent``
(``git archive HEAD | tar -x -C _checkout/parent``, the directory emptied
first, since an older parent may lie there) and copy this file into it.
"""
import dataclasses
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

B = 1024
DEVICE = "cuda"
TIME_B, TIME_REPS = 32768, 20
STREAM_ADAPT_B, STREAM_ADAPT_N = 1024, 2048   # phase 36's adaptive point
CONS_GROUPS = (1, 2, 8, 16, 128)              # save's box consensus groups


def _quad(tt, torch, N, max_iter=100, ct=1, rho=None):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho or s["rho"],
                 N=N, dtype=torch.float32, device=DEVICE)
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct)


def _rocket(tt, torch, N, cones=True):
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device=DEVICE)
    p = tt.with_bounds(
        p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    if cones:
        p = tt.with_cones(p, state_cones=[(0, 3, 0.25)],
                          input_cones=[(0, 3, 0.5)])
    return tt.with_settings(p, max_iter=100, check_termination=1,
                            abs_pri_tol=2e-3)


def _planes(tt, torch, tv, N=10):
    s = tt.systems.quadrotor_50hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device=DEVICE)
    if tv:
        Ax = np.zeros((N, 1, 12))
        Ax[:, 0, 2] = 1.0
        p = tt.with_tv_linear_constraints(
            p, Ax, (1.07 + 0.02 * np.arange(N)).reshape(N, 1),
            np.ones((N - 1, 1, 4)), np.full((N - 1, 1), 6.0))
    else:
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        p = tt.with_linear_constraints(p, Ax, [1.24], np.ones((1, 4)), [6.0])
    p = tt.with_bounds(p, enable=False)
    return tt.with_settings(p, max_iter=100, check_termination=1,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)


def _mixed(tt, torch, N):
    """Every family on both sides of the quadrotor (12, 4), with its box:
    two state cones and an input cone, the static z ceiling and thrust-sum
    plane, two time-varying state planes and one input plane."""
    p = _planes(tt, torch, False, N)
    Ax = np.zeros((N, 2, 12))
    Ax[:, 0, 2] = 1.0
    Ax[:, 1, :2] = 0.5
    Au = np.ones((N - 1, 1, 4))
    Au[:, 0, 3] = 2.0
    p = tt.with_tv_linear_constraints(
        p, Ax, np.stack([1.07 + 0.02 * np.arange(N), np.full(N, -1.5)], 1),
        Au, np.full((N - 1, 1), 6.0))
    p = tt.with_cones(p, state_cones=[(3, 3, 0.5), (6, 4, 2.0)],
                      input_cones=[(0, 2, 0.3)])
    return tt.with_settings(tt.with_bounds(p, x_min=-5.0, x_max=5.0,
                                           u_min=-0.5, u_max=3.0),
                            max_iter=30)


def _cartpole(tt, torch, N, A=None):
    """bench_all.py:128-131's cartpole, box +-5 / +-0.5, max_iter 100, ct
    1; ``A`` replaces the system's."""
    s = tt.systems.cartpole()
    prob = tt.setup(s["A"] if A is None else A, s["B"], s["Qdiag"],
                    s["Rdiag"], rho=s["rho"], N=N, f=s["f"],
                    dtype=torch.float32, device=DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=100, check_termination=1)


def _degenerate(tt, torch, nx, nu, N=10):
    """tests/test_degenerate_dims.py:29-41's random stable system (seed
    nx * 100 + nu), box x in [-3, 3] and u in [-2, 2], max_iter 50."""
    g = np.random.default_rng(nx * 100 + nu)
    A = g.uniform(-1.0, 1.0, (nx, nx))
    A *= 0.9 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-9)
    Bm = g.uniform(-1.0, 1.0, (nx, nu))
    prob = tt.setup(A, Bm, g.uniform(1.0, 5.0, nx), g.uniform(0.1, 1.0, nu),
                    rho=1.0, N=N, dtype=torch.float32, device=DEVICE)
    prob = tt.with_bounds(prob, x_min=-3.0, x_max=3.0, u_min=-2.0,
                          u_max=2.0)
    return tt.with_settings(prob, max_iter=50)


def _thread_loops(tt, torch, rng, x_r, B_=B, T=20):
    """The one-thread closed loops of ``save``: (name, problem, reference,
    x0, Uref, options) of the rocket (x0 ``x_r``), cartpole and (2, 1)."""
    kw = dict(dtype=torch.float32, device=DEVICE)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    k = np.arange(T + 9)[:, None]
    xtot = torch.as_tensor(xinit + (0.0 - xinit) * k / 99.0, **kw)
    U = torch.zeros((9, 3), **kw)
    U[:, 2] = 10.0
    Xc = torch.zeros((10, 4), **kw)
    Xc[:, 0] = 1.0
    x_c = torch.as_tensor(np.asarray([0.5, 0.0, 0.0, 0.0])
                          + rng.uniform(-0.3, 0.3, (B_, 4)), **kw)
    x_d = torch.as_tensor(rng.uniform(-0.5, 0.5, (B_, 2)), **kw)
    return [("rocket", _rocket(tt, torch, 10, cones=False), xtot, x_r, U, {}),
            ("cartpole", tt.with_settings(_cartpole(tt, torch, 10),
                                          check_termination=5), Xc, x_c,
             None, dict(shift_warm=True)),
            ("dims21", _degenerate(tt, torch, 2, 1), torch.zeros((10, 2), **kw),
             x_d, None, dict(reset_duals=True))]


def _plane_inputs(torch, B_, N, rng):
    """Phase 21's x0 and the demo's step-0 reference window."""
    kw = dict(dtype=torch.float32, device=DEVICE)
    start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
    goal = np.asarray([2.0, 2.0, 4.0] + [0.0] * 9)
    alpha = np.arange(N)[:, None] / 49.0
    return (torch.as_tensor(start + 0.1 * rng.uniform(-1, 1, (B_, 12)), **kw),
            torch.as_tensor((1 - alpha) * start + alpha * goal, **kw))


def _flat(prefix, out):
    """Every tensor of a solve's (Solution, residuals[, carry]) output."""
    sol, res = out[0], out[1]
    d = {f"{prefix}.{k}": getattr(sol, k) for k in ("x", "u", "iter",
                                                   "solved")}
    d[f"{prefix}.res"] = res
    if len(out) > 2 and out[2] is not None:
        for f in dataclasses.fields(out[2]):
            v = getattr(out[2], f.name)
            if v is not None:
                d[f"{prefix}.carry.{f.name}"] = v
    return d


def save(path):
    import torch
    import tinympc_tpu_torch as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    kern = tt.kernels
    rng = np.random.default_rng(0)
    kw = dict(dtype=torch.float32, device=DEVICE)
    x_q = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)), **kw)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x_r = torch.as_tensor(xinit * rng.uniform(0.9, 1.2, (B, 1)), **kw)
    x_p = torch.as_tensor(np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
                          + 0.1 * rng.uniform(-1, 1, (B, 12)), **kw)

    def hover(N, z=1.0):
        X = torch.zeros((N, 12), **kw)
        X[:, 2] = z
        return X

    def descent(N):
        U = torch.zeros((N - 1, 3), **kw)
        U[:, 2] = 10.0
        return torch.as_tensor(np.linspace(xinit, np.zeros(6), N), **kw), U

    out = {}
    cases = [("box", _quad(tt, torch, 20), x_q, hover(20), None),
             ("rocket_soc", _rocket(tt, torch, 10), x_r, *descent(10)),
             ("linear", _planes(tt, torch, False), x_p, hover(10), None),
             ("tv", _planes(tt, torch, True), x_p, hover(10), None)]
    tree = tt.with_consensus(_quad(tt, torch, 10), rho_c=100.0)
    for name, prob, x0, Xref, Uref in cases:
        out.update(_flat(f"{name}.cold",
                         kern.solve_fused(prob, Xref, Uref, x0)))
        c = tt.init_carry(prob, B)
        for step in range(2):
            w = kern.solve_fused_warm(prob, Xref, Uref, x0, c)
            out.update(_flat(f"{name}.warm{step}", w))
            c = w[2]
    # The families (and a box problem at (6, 3)) on the resident kernel:
    # every family at N=16 and, on 64 lanes, at N=420 (table and a warm
    # solve's saved columns in device memory) and the rocket's cones at
    # N=700; the rocket's cones and box alone at adaptive rho, the box at
    # fixed rho; cold and two warm solves each.
    rt = tt.with_settings(_rocket(tt, torch, 10), adaptive_rho=True)
    rtab = (rt.cache.dKinf_drho, rt.cache.dPinf_drho, rt.cache.dC1_drho,
            rt.cache.dC2_drho)
    rocket_ad = lambda cones, **k: tt.with_settings(
        tt.with_sensitivities(_rocket(tt, torch, 10, cones=cones), rtab),
        adaptive_rho=True, adaptive_rho_min=0.05, **k)
    resident = [
        ("mixed", _mixed(tt, torch, 16), x_p, hover(16), None),
        ("mixed420", tt.with_settings(_mixed(tt, torch, 420), max_iter=12,
                                      check_termination=3),
         x_p[:64].contiguous(), hover(420), None),
        ("rocket_soc700", tt.with_settings(_rocket(tt, torch, 700),
                                           max_iter=12, check_termination=3),
         x_r[:64].contiguous(), *descent(700)),
        ("adaptive_rocket_soc", rocket_ad(True), x_r, *descent(10)),
        ("adaptive_rocket_soc_apply_c", rocket_ad(
            True, adaptive_rho_apply_c=True), x_r, *descent(10)),
        ("rocket_box", _rocket(tt, torch, 10, cones=False), x_r,
         *descent(10)),
        ("adaptive_rocket_box", rocket_ad(False), x_r, *descent(10))]
    for name, prob, x0, Xref, Uref in resident:
        out.update(_flat(f"{name}.cold",
                         kern.solve_fused(prob, Xref, Uref, x0)))
        c = tt.init_carry(prob, x0.shape[0])
        for step in range(2):
            w = kern.solve_fused_warm(prob, Xref, Uref, x0, c)
            out.update(_flat(f"{name}.warm{step}", w))
            c = w[2]
    x_g = x_q.reshape(B // 8, 8, 12)
    out.update(_flat("consensus.cold",
                     kern.solve_fused(tree, hover(10), None, x_g)))
    c = tt.init_carry(tree, B)
    out.update(_flat("consensus.warm",
                     kern.solve_fused_warm(tree, hover(10), None, x_g, c)))
    # The resident box consensus kernel at each group size: cold, two warm
    # solves, and the warm solve of compaction (final=True).
    for G in CONS_GROUPS:
        cp = tt.with_consensus(_quad(tt, torch, 10, max_iter=200),
                               rho_c=100.0)
        xg = x_q.reshape(B // G, G, 12)
        out.update(_flat(f"consensus_g{G}.cold", kern.solve_fused(
            cp, hover(10, 0.5), None, xg)))
        c = tt.init_carry(cp, B)
        for step in range(2):
            w = kern.solve_fused_warm(cp, hover(10, 0.5), None, xg, c)
            out.update(_flat(f"consensus_g{G}.warm{step}", w))
            c = w[2]
        out.update(_flat(f"consensus_g{G}.final", kern.solve_fused_warm(
            cp, hover(10, 0.5), None, xg, c, final=True)))
    # The resident box adaptive kernel: cold and two warm solves, rho
    # riding the carry; and a two-system adaptive fleet.
    cf = tt.systems.crazyflie_sensitivity_tables()
    ad = lambda p, **k: tt.with_settings(p, adaptive_rho=True, **k)
    for name, prob in (
            ("adaptive", ad(tt.with_sensitivities(_quad(tt, torch, 20),
                                                  cf))),
            ("adaptive_apply_c", ad(tt.with_sensitivities(
                _quad(tt, torch, 20), cf), adaptive_rho_apply_c=True)),
            ("adaptive_guard", ad(_quad(tt, torch, 20, max_iter=300,
                                        rho=1000.0),
                                  adaptive_rho_tolerance=3.0))):
        out.update(_flat(f"{name}.cold", kern.solve_fused(
            prob, hover(20), None, x_q)))
        c = tt.init_carry(prob, B)
        for step in range(2):
            w = kern.solve_fused_warm(prob, hover(20), None, x_q, c)
            out.update(_flat(f"{name}.warm{step}", w))
            c = w[2]
    fleet = []
    for i in range(2):
        p = _quad(tt, torch, 10, ct=25)
        A = p.A.clone()
        A[~torch.eye(12, dtype=torch.bool, device=A.device)] *= 1 + 0.004 * i
        s = tt.systems.quadrotor_20hz()
        q = tt.setup(A, s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=10,
                     dtype=torch.float32, device=DEVICE)
        q = tt.with_bounds(q, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
        fleet.append(tt.with_settings(q, max_iter=100, check_termination=25))
    assign = rng.integers(0, 2, B)
    out.update(_flat("fleet.cold", kern.make_fleet_solver(fleet)(
        assign, x_q, Xref=hover(10))))
    c = tt.init_carry(fleet[0], B)
    warm_fleet = kern.make_fleet_solver(fleet, warm=True)
    for step in range(2):
        w = warm_fleet(assign, x_q, c, Xref=hover(10))
        out.update(_flat(f"fleet.warm{step}", w))
        c = w[2]
    afleet = [ad(tt.with_sensitivities(p, cf)) for p in fleet]
    out.update(_flat("adaptive_fleet.cold", kern.make_fleet_solver(afleet)(
        assign, x_q, Xref=hover(10))))
    c = tt.init_carry(afleet[0], B)
    warm_afleet = kern.make_fleet_solver(afleet, warm=True)
    for step in range(2):
        w = warm_afleet(assign, x_q, c, Xref=hover(10))
        out.update(_flat(f"adaptive_fleet.warm{step}", w))
        c = w[2]
    loop = kern.closed_loop_fused(_quad(tt, torch, 10, ct=5),
                                  hover(10 + 9), x_q, 10)
    out.update({f"closed_loop.{k}": v for k, v in zip(
        ("xs", "us", "iters", "solved"), loop)})
    x_l = x_q[:64].contiguous()
    for N in (700, 1100, 1150):
        prob = _quad(tt, torch, N, max_iter=12, ct=3)
        if N == 700:
            out.update(_flat(f"long{N}.cold",
                             kern.solve_fused(prob, hover(N), None, x_l)))
        c = tt.init_carry(prob, 64)
        for step in range(2):
            w = kern.solve_fused_warm(prob, hover(N), None, x_l, c)
            out.update(_flat(f"long{N}.warm{step}", w))
            c = w[2]
    for N in (700, 1150):
        loop = kern.closed_loop_fused(_quad(tt, torch, N, max_iter=12, ct=3),
                                      hover(N), x_l, 2, shift_warm=True)
        out.update({f"long{N}.closed_loop.{k}": v for k, v in zip(
            ("xs", "us", "iters", "solved"), loop)})
    streamed = [("box", _quad(tt, torch, 64, 20), x_q, hover(64), None),
                ("box256", _quad(tt, torch, 256, 20), x_q[:256].contiguous(),
                 hover(256), None),
                ("box1300", _quad(tt, torch, 1300, 12, 3), x_l, hover(1300),
                 None),
                ("rocket_box", _rocket(tt, torch, 32, cones=False), x_r,
                 *descent(32)),
                ("rocket_soc", _rocket(tt, torch, 32), x_r, *descent(32)),
                ("rocket_soc256", tt.with_settings(_rocket(tt, torch, 256),
                                                   max_iter=20), x_r,
                 *descent(256)),
                ("linear", _planes(tt, torch, False), x_p, hover(10), None),
                ("tv", _planes(tt, torch, True), x_p, hover(10), None),
                ("mixed", _mixed(tt, torch, 16), x_p, hover(16), None),
                ("consensus", tree, x_g, hover(10), None)]
    tables = cf
    adaptive = ad
    rb = _rocket(tt, torch, 32, cones=False)
    streamed += [
        ("adaptive_box", adaptive(tt.with_sensitivities(
            _quad(tt, torch, 64, 20), tables)), x_q, hover(64), None),
        ("adaptive_box_apply_c", adaptive(tt.with_sensitivities(
            _quad(tt, torch, 64, 20), tables), adaptive_rho_apply_c=True),
         x_q, hover(64), None),
        ("adaptive_guard", adaptive(
            _quad(tt, torch, 64, 20, rho=1000.0),
            adaptive_rho_tolerance=3.0), x_q, hover(64), None),
        ("adaptive_box256", adaptive(tt.with_sensitivities(
            _quad(tt, torch, 256, 20), tables)), x_q[:256].contiguous(),
         hover(256), None),
        ("adaptive_box1300", adaptive(tt.with_sensitivities(
            _quad(tt, torch, 1300, 12, 3), tables)), x_l, hover(1300), None),
        ("adaptive_rocket_box", adaptive(
            tt.with_settings(rb, max_iter=20), adaptive_rho_min=0.05), x_r,
         *descent(32))]
    for name, prob, x0, Xref, Uref in streamed:
        out.update(_flat(f"streamed.{name}.cold", kern.solve_fused_streamed(
            prob, Xref, Uref, x0)))
        c = tt.init_carry(prob, x0.shape[0] * (
            x0.shape[1] if x0.dim() == 3 else 1))
        out.update(_flat(f"streamed.{name}.warm",
                         kern.solve_fused_streamed_warm(prob, Xref, Uref,
                                                        x0, c)))
    # The streamed consensus launches at each group size (N=10), G=16 at
    # N=256 on 256 lanes, and the rocket's cones in groups of 8 at N=32:
    # cold and two warm solves, each warm solve's first launch stale.
    scons = [(f"consensus_g{G}", tt.with_consensus(
        _quad(tt, torch, 10, max_iter=200), rho_c=100.0),
        x_q.reshape(B // G, G, 12), hover(10, 0.5), None)
        for G in CONS_GROUPS]
    scons += [("consensus256_g16", tt.with_consensus(
        _quad(tt, torch, 256, max_iter=60), rho_c=100.0),
        x_q[:256].reshape(16, 16, 12), hover(256, 0.5), None),
        ("rocket_soc_consensus", tt.with_consensus(
            _rocket(tt, torch, 32), rho_c=100.0), x_r.reshape(B // 8, 8, 6),
         *descent(32))]
    for name, prob, x0, Xref, Uref in scons:
        out.update(_flat(f"streamed.{name}.cold", kern.solve_fused_streamed(
            prob, Xref, Uref, x0)))
        c = tt.init_carry(prob, x0.shape[0] * x0.shape[1])
        for step in range(2):
            w = kern.solve_fused_streamed_warm(prob, Xref, Uref, x0, c)
            out.update(_flat(f"streamed.{name}.warm{step}", w))
            c = w[2]
    # The one-thread kernels' own pairs: cartpole (4, 1) at N=10 -- box,
    # adaptive rho (apply_c, adaptive_rho_min 0.05), consensus in groups of
    # 8, a state hyperplane, a fleet of two variants -- resident, cold and
    # two warm solves, and streamed at N=64, cold and warm; the degenerate
    # (2, 2), (2, 1), (3, 3), (1, 1) resident at N=10, cold and warm.
    cart = _cartpole(tt, torch, 10)
    x_c = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 4)), **kw)
    Xc = torch.zeros((10, 4), **kw)
    Xc[:, 2] = 1.0
    one_thread = [
        ("cartpole", cart, x_c),
        ("cartpole_adaptive", tt.with_settings(
            cart, adaptive_rho=True, adaptive_rho_min=0.05,
            adaptive_rho_apply_c=True), x_c),
        ("cartpole_consensus", tt.with_consensus(cart, rho_c=20.0),
         x_c.reshape(B // 8, 8, 4)),
        ("cartpole_plane", tt.with_linear_constraints(
            cart, [[1.0, 0.0, 0.0, 0.0]], [0.2]), x_c)]
    for name, prob, x0 in one_thread:
        out.update(_flat(f"{name}.cold", kern.solve_fused(prob, Xc, None,
                                                          x0)))
        c = tt.init_carry(prob, B)
        for step in range(2):
            w = kern.solve_fused_warm(prob, Xc, None, x0, c)
            out.update(_flat(f"{name}.warm{step}", w))
            c = w[2]
    s_c = tt.systems.cartpole()
    cfleet = [_cartpole(tt, torch, 10, A=s_c["A"] * (1 + 0.004 * i))
              for i in range(2)]
    out.update(_flat("cartpole_fleet.cold", kern.make_fleet_solver(cfleet)(
        assign, x_c, Xref=Xc)))
    c = tt.init_carry(cfleet[0], B)
    for step in range(2):
        w = kern.make_fleet_solver(cfleet, warm=True)(assign, x_c, c,
                                                       Xref=Xc)
        out.update(_flat(f"cartpole_fleet.warm{step}", w))
        c = w[2]
    Xs = torch.zeros((64, 4), **kw)
    Xs[:, 2] = 1.0
    cs = _cartpole(tt, torch, 64)
    out.update(_flat("streamed.cartpole.cold", kern.solve_fused_streamed(
        cs, Xs, None, x_c)))
    out.update(_flat("streamed.cartpole.warm", kern.solve_fused_streamed_warm(
        cs, Xs, None, x_c, tt.init_carry(cs, B))))
    for nx, nu in ((2, 2), (2, 1), (3, 3), (1, 1)):
        prob = _degenerate(tt, torch, nx, nu)
        x0 = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, nx)), **kw)
        out.update(_flat(f"dims{nx}{nu}.cold", kern.solve_fused(
            prob, None, None, x0)))
        out.update(_flat(f"dims{nx}{nu}.warm", kern.solve_fused_warm(
            prob, None, None, x0, tt.init_carry(prob, B))))
    # The closed loop on one thread a plant (csrc/closed_loop_thread.cu),
    # T=20: the rocket's sliding loop (its box alone, ct 1, Uref[:, 2] =
    # 10), cartpole's regulation to x = 1 with shift_warm (ct 5) and (2, 1)
    # with reset_duals (ct 1).
    for name, prob, xtot, x0, U, opts in _thread_loops(tt, torch, rng, x_r):
        loop = kern.closed_loop_fused(prob, xtot, x0, 20, U, **opts)
        out.update({f"closed_loop_thread.{name}.{k}": v for k, v in zip(
            ("xs", "us", "iters", "solved"), loop)})
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"chip_compare: {len(out)} tensors saved to {path}; card "
          f"{torch.cuda.get_device_name(0)}")


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def _timed(torch, run, reps):
    """Median and every time of ``reps`` calls of ``run`` on CUDA events,
    after one to warm up."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _device_times(torch, run):
    """Device time of one call of ``run`` by kernel name, from
    torch.profiler (None where the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key[:120]] = us / 1e3
    return out or None


def _timed_record(torch, kind, run, iters_of, B_, card, **extra):
    """One JSON line: ``run`` timed (``_timed``), its mean iterations
    (``iters_of`` of its output) and time a lane-iteration."""
    lane_iters = int(iters_of(run()).sum().item())
    ms, times = _timed(torch, run, TIME_REPS)
    print(json.dumps(dict({
        "kind": kind, "B": B_, "ms": ms, "times_ms": times,
        "mean_iters": lane_iters / B_,
        "us_per_lane_iter": 1e3 * ms / lane_iters, "card": card,
        "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}, **extra)),
        flush=True)


def time_resident(torch, tt, cons=(), adapt=()):
    """The consensus (``tree``, ``g16``) and adaptive (``hard``, ``warm``)
    solves of the module docstring, each launch timed on its own inputs
    through admm_fused's kernel entry (the call the wrapper makes)."""
    from tinympc_tpu_torch.kernels import admm_fused as af
    card = _smi("name,power.limit")
    kw = dict(dtype=torch.float32, device=DEVICE)
    s = tt.systems.quadrotor_20hz()

    def quad(N, max_iter, ct, rho=None):
        return _quad(tt, torch, N, max_iter=max_iter, ct=ct, rho=rho)

    def trees(ng, G, z):
        rng = np.random.default_rng(0)
        nominal = rng.uniform(-0.3, 0.3, (ng, 1, 12))
        x0 = nominal + 0.05 * rng.uniform(-1, 1, (ng, G, 12))
        Xref = torch.zeros((10, 12), **kw)
        Xref[:, 2] = z
        return torch.as_tensor(x0, **kw), Xref

    iters = lambda out: out[0].iter
    zero = lambda: af.entry_counts.update(dict.fromkeys(af.entry_counts, 0))
    for name in cons:
        zero()
        prob = tt.with_consensus(quad(10, 500, 1), rho_c=100.0)
        if name == "tree":
            ng, G = 256, 8
            x, Xref = trees(ng, G, 1.0)
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            c = tt.init_carry(prob, ng * G)
            for _ in range(20):
                sol, _, c = tt.kernels.solve_fused_warm(prob, Xref, None, x,
                                                        c)
                u0 = sol.u[0].mean(dim=1, keepdim=True)
                x_nom = x.mean(dim=1, keepdim=True)
                branch = 0.05 * (2 * torch.rand((ng, G, 12), generator=gen,
                                                device=DEVICE) - 1)
                x = x_nom @ prob.A.T + u0 @ prob.B.T + branch
            tables, xc, params = af._prepare(prob, Xref, None, x)
            carry = af._carry_tensors(prob, c, ng * G)
            run = lambda: af._solve_kernel_warm(tables, xc, carry, 10, 12, 4,
                                                **params)
        else:
            ng, G = 2048, 16
            x, Xref = trees(ng, G, 0.5)
            tables, xc, params = af._prepare(prob, Xref, None, x)
            run = lambda: af._solve_kernel(tables, xc, 10, 12, 4, **params)
        _timed_record(torch, f"consensus_{name}", run, iters, ng * G, card,
                      entry_counts={k: v for k, v in af.entry_counts.items()
                                    if v})
    t5 = None
    for name in adapt:
        zero()
        if t5 is None:
            p5 = tt.with_settings(quad(20, 500, 1), adaptive_rho=True)
            t5 = (p5.cache.dKinf_drho, p5.cache.dPinf_drho,
                  p5.cache.dC1_drho, p5.cache.dC2_drho)
        if name == "hard":
            B_ = 32768
            x0 = torch.as_tensor(np.random.default_rng(0).uniform(
                -0.5, 0.5, (B_, 12)), **kw)
            Xref = torch.zeros((20, 12), **kw)
            Xref[:, 2] = 1.0
            tables, xc, params = af._prepare(p5, Xref, None, x0)
            run = lambda: af._solve_kernel(tables, xc, 20, 12, 4, **params)
        else:
            B_ = 16384
            prob = tt.with_settings(tt.with_sensitivities(quad(10, 100, 1),
                                                          t5),
                                    adaptive_rho=True)
            hover = torch.zeros(12, **kw)
            hover[2] = 1.0
            Xref = hover.expand(10, 12).contiguous()
            x = hover + torch.as_tensor(np.random.default_rng(0).uniform(
                -0.3, 0.3, (B_, 12)), **kw)
            c = tt.init_carry(prob, B_)
            for _ in range(5):
                sol, _, c = tt.kernels.solve_fused_warm(prob, Xref, None, x,
                                                        c)
                x = x @ prob.A.T + sol.u[0] @ prob.B.T + prob.f
            tables, xc, params = af._prepare(prob, Xref, None, x)
            carry = af._carry_tensors(prob, c, B_)
            run = lambda: af._solve_kernel_warm(tables, xc, carry, 10, 12, 4,
                                                **params)
        _timed_record(torch, f"adaptive_{name}", run, iters, B_, card,
                      entry_counts={k: v for k, v in af.entry_counts.items()
                                    if v})


FAM_TIMES = ("soc", "soc_warm", "linear", "tv", "adaptive", "adaptive_warm")


def time_families(torch, tt, names, profile=False):
    """The resident launches of the families of chip_smoke.py phases 10-12
    and 34 (its problems and inputs; ``FAM_TIMES`` of the module
    docstring), each timed on its own inputs through admm_fused's kernel
    entry, with the C entries it took and, with ``profile``, its
    torch.profiler device time."""
    import types
    import chip_smoke as cs
    from tinympc_tpu_torch.kernels import admm_fused as af
    cs.DEVICE = DEVICE
    card = _smi("name,power.limit")
    B_, N = cs.FAM_B, cs.FAM_N
    ctx = types.SimpleNamespace(tt=tt, torch=torch)
    sens = None
    for name in names:
        if name in ("linear", "tv"):
            prob = cs.quad_plane_problem(tt, torch, name == "tv", 100, 1)
            x0, Xref, Uref = cs.quad_plane_inputs(torch, B_)
        else:
            x0, Xref, Uref = cs.rocket_inputs(torch, B_)
            prob = cs.rocket_problem(tt, torch, 100, 1)
            if name.startswith("adaptive"):
                if sens is None:
                    sens = cs.sensitivity_tables(tt.with_settings(
                        prob, adaptive_rho=True))
                prob = cs.adaptive_rocket(ctx, 100, 1, sens)
        spec = prob.spec
        x, carry = x0, None
        if name.endswith("warm"):
            # The sixth solve of phase 11's (phase 34's) external plant.
            c = tt.init_carry(prob, B_)
            for _ in range(5):
                sol, _, c = tt.kernels.solve_fused_warm(prob, Xref, Uref, x,
                                                        c)
                x = x @ prob.A.T + sol.u[0] @ prob.B.T + prob.f
            carry = af._carry_tensors(prob, c, B_)
        tables, xc, params = af._prepare(prob, Xref, Uref, x)
        if carry is None:
            run = lambda: af._solve_kernel(tables, xc, N, spec.nx, spec.nu,
                                           **params)
        else:
            run = lambda: af._solve_kernel_warm(tables, xc, carry, N,
                                                spec.nx, spec.nu, **params)
        af.entry_counts.update(dict.fromkeys(af.entry_counts, 0))
        run()
        torch.cuda.synchronize()
        extra = dict(entry_counts={k: v for k, v in af.entry_counts.items()
                                   if v})
        if profile:
            extra["profiler_device_ms"] = _device_times(torch, run)
        _timed_record(torch, f"families_{name}", run, lambda o: o[0].iter,
                      B_, card, **extra)


def time_thread_loops(torch, tt, batches, card):
    """The one-thread closed loop (csrc/closed_loop_thread.cu) at each
    batch of ``tloop``: chip_smoke.py phase 47's rocket loop (T=90,
    ct 1), phase 48's cartpole loop (T=50, ct 5), and the pinned (12, 4)
    instance on the serving loop of ``loop``."""
    from tinympc_tpu_torch.kernels import closed_loop_kernel as cl
    kw = dict(dtype=torch.float32, device=DEVICE)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    for B_ in batches:
        rng = np.random.default_rng(0)
        k = np.arange(90 + 9)[:, None]
        U = torch.zeros((9, 3), **kw)
        U[:, 2] = 10.0
        Xc = torch.zeros((10, 4), **kw)
        Xc[:, 0] = 1.0
        Xq = torch.zeros((10, 12), **kw)
        Xq[:, 2] = 1.0
        loops = [
            ("rocket", _rocket(tt, torch, 10, cones=False),
             torch.as_tensor(xinit + (0.0 - xinit) * k / 99.0, **kw),
             torch.as_tensor(xinit * rng.uniform(0.9, 1.2, (B_, 1)), **kw),
             U, 90),
            ("cartpole", tt.with_settings(_cartpole(tt, torch, 10),
                                          check_termination=5), Xc,
             torch.as_tensor(np.asarray([0.5, 0.0, 0.0, 0.0]) + np.random
                             .default_rng(0).uniform(-0.3, 0.3, (B_, 4)),
                             **kw), None, 50),
            ("quadrotor", _quad(tt, torch, 10, ct=5), Xq,
             torch.as_tensor(np.random.default_rng(0).uniform(
                 -0.3, 0.3, (B_, 12)), **kw), None, 50)]
        for system, prob, xref, x0, Uref, T in loops:
            tables, xtot, x0c, T, params = cl._prepare_loop(prob, xref, x0, T,
                                                            Uref)
            spec = prob.spec
            run = lambda: cl._loop_thread_kernel(
                tables, xtot, x0c, T, spec.N, spec.nx, spec.nu,
                reset_duals=False, shift_warm=False, **params)
            lane_iters = int(run()[2].sum().item())
            ms, times = _timed(torch, run, TIME_REPS)
            print(json.dumps({
                "kind": "closed_loop_thread", "system": system, "B": B_,
                "T": T, "ms": ms, "times_ms": times,
                "mean_iters": lane_iters / (B_ * T),
                "us_per_lane_iter": 1e3 * ms / lane_iters, "card": card,
                "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}),
                flush=True)


def time_kernels(cold=(TIME_B,), loop=(), profile=False, warm=(),
                 stream=(), dot=False, cons=(), adapt=(), fam=(),
                 tloop=()):
    import torch
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import admm_fused, admm_stream, \
        closed_loop_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dtype=torch.float32, device=DEVICE)
    card = _smi("name,power.limit")
    time_resident(torch, tt, cons, adapt)
    time_families(torch, tt, fam, profile)
    time_thread_loops(torch, tt, tloop, card)
    for B_ in cold:
        prob = _quad(tt, torch, 20, ct=25)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -0.5, 0.5, (B_, 12)), **kw)
        Xref = torch.zeros((20, 12), **kw)
        Xref[:, 2] = 1.0
        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(tables, x0c, 20, 12, 4,
                                               **params)
        lane_iters = int(run()[0].iter.sum().item())
        ms, times = _timed(torch, run, TIME_REPS)
        rec = {"kind": "cold", "B": B_, "ms": ms, "times_ms": times,
               "mean_iters": lane_iters / B_,
               "us_per_lane_iter": 1e3 * ms / lane_iters,
               "card": card, "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}
        if B_ == TIME_B:
            rec["main_path_ms"] = ms
        if profile:
            rec["profiler_device_ms"] = _device_times(torch, run)
        print(json.dumps(rec), flush=True)
    for B_ in warm:
        prob = _quad(tt, torch, 20, ct=25)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -0.5, 0.5, (B_, 12)), **kw)
        Xref = torch.zeros((20, 12), **kw)
        Xref[:, 2] = 1.0
        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        carry = admm_fused._carry_tensors(prob, tt.init_carry(prob, B_), B_)
        run = lambda: admm_fused._solve_kernel_warm(tables, x0c, carry, 20,
                                                    12, 4, **params)
        lane_iters = int(run()[0].iter.sum().item())
        ms, times = _timed(torch, run, TIME_REPS)
        print(json.dumps({
            "kind": "warm", "B": B_, "ms": ms, "times_ms": times,
            "mean_iters": lane_iters / B_,
            "us_per_lane_iter": 1e3 * ms / lane_iters, "card": card,
            "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}), flush=True)
    for B_ in loop:
        prob = _quad(tt, torch, 10, ct=5)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -0.3, 0.3, (B_, 12)), **kw)
        Xref = torch.zeros((10, 12), **kw)
        Xref[:, 2] = 1.0
        tables, xtot, x0c, T, params = closed_loop_kernel._prepare_loop(
            prob, Xref, x0, 50, None)
        run = lambda: closed_loop_kernel._loop_kernel(
            tables, xtot, x0c, T, 10, 12, 4, reset_duals=False,
            shift_warm=False, **params)
        lane_iters = int(run()[2].sum().item())
        ms, times = _timed(torch, run, TIME_REPS)
        print(json.dumps({
            "kind": "closed_loop", "B": B_, "T": T, "ms": ms,
            "times_ms": times, "mean_iters": lane_iters / (B_ * T),
            "us_per_lane_iter": 1e3 * ms / lane_iters, "card": card,
            "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}), flush=True)
    N = 512
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    points = [(b, sy) for b in stream for sy in ("quadrotor", "rocket_box")]
    points += [(STREAM_ADAPT_B, "quadrotor_adaptive")] if stream else []
    points += [(b, "rocket_soc") for b in stream]
    points += [(16384, sy) for sy in ("linear", "tv")] if stream else []
    points += [(b, f"consensus_g{G}") for b in stream for G in (8, 16, 128)]
    points += [(32768, "consensus_g16_n10")] if stream else []
    for B_, system in points:
        rng = np.random.default_rng(0)
        Uref, n_, carry = None, N, None
        if system == "rocket_soc":
            n_ = 256
            prob = tt.with_settings(_rocket(tt, torch, n_), max_iter=20)
            x0 = torch.as_tensor(xinit * rng.uniform(0.9, 1.1, (B_, 1)), **kw)
            Xref = torch.as_tensor(np.linspace(xinit, np.zeros(6), n_), **kw)
            Uref = torch.zeros((n_ - 1, 3), **kw)
            Uref[:, 2] = 10.0
            carry = tt.kernels.solve_fused_streamed_warm(
                prob, Xref, Uref, x0, tt.init_carry(prob, B_))[2]
        elif system in ("linear", "tv"):
            n_ = 10
            prob = _planes(tt, torch, system == "tv", n_)
            x0, Xref = _plane_inputs(torch, B_, n_, rng)
        elif system.startswith("consensus"):
            # N=512 in groups of 8, 16 or 128 (in a block, and clusters of
            # 2 and 16 blocks on lane teams); and bench_all.py:224-250's
            # G=16 batch at N=10
            # (nominal U[-0.3, 0.3] a group plus 0.05 U[-1, 1] a lane, z
            # 0.5), with the stale launch from the carry of a 100-iteration
            # warm solve from a zero carry
            G = int(system.split("_g")[1].split("_")[0])
            short = system.endswith("_n10")
            n_ = 10 if short else N
            prob = tt.with_consensus(_quad(tt, torch, n_, max_iter=20),
                                     rho_c=100.0)
            Xref = torch.zeros((n_, 12), **kw)
            Xref[:, 2] = 0.5 if short else 1.0
            if short:
                x0 = torch.as_tensor(
                    rng.uniform(-0.3, 0.3, (B_ // G, 1, 12))
                    + 0.05 * rng.uniform(-1, 1, (B_ // G, G, 12)), **kw)
                carry = tt.kernels.solve_fused_streamed_warm(
                    tt.with_settings(prob, max_iter=100), Xref, None, x0,
                    tt.init_carry(prob, B_))[2]
            else:
                x0 = torch.as_tensor(rng.uniform(-0.3, 0.3, (B_, 12)),
                                     **kw).reshape(B_ // G, G, 12)
        elif system.startswith("quadrotor"):
            n_ = STREAM_ADAPT_N if system == "quadrotor_adaptive" else N
            prob = _quad(tt, torch, n_, max_iter=20, ct=1)
            if system == "quadrotor_adaptive":
                prob = tt.with_settings(tt.with_sensitivities(
                    prob, tt.systems.crazyflie_sensitivity_tables()),
                    adaptive_rho=True)
            x0 = torch.as_tensor(rng.uniform(-0.3, 0.3, (B_, 12)), **kw)
            Xref = torch.zeros((n_, 12), **kw)
            Xref[:, 2] = 1.0
        else:
            prob = tt.with_settings(_rocket(tt, torch, N, cones=False),
                                    max_iter=20)
            x0 = torch.as_tensor(xinit * rng.uniform(0.9, 1.2, (B_, 1)), **kw)
            Xref = torch.as_tensor(np.linspace(xinit, np.zeros(6), N), **kw)
            Uref = torch.zeros((N - 1, 3), **kw)
            Uref[:, 2] = 10.0
        nx, nu = prob.spec.nx, prob.spec.nu
        tables, x0c, _, params = admm_stream._prepare(prob, Xref, Uref, x0)
        kw_ = {k: v for k, v in params.items() if k != "max_iter"}
        rho0 = params["rho"] if params["adapt"] is not None else None
        its = (0, 5) if rho0 is not None else (0,)
        c_t = None if carry is None else admm_stream._prepare(
            prob, Xref, Uref, x0, carry, True)[2]
        # Each launch on a fresh state (iteration `it`, every lane
        # running), on lane teams and, in turns, on one thread a lane;
        # with a carry also the stale forward launch of a warm state.
        names = ["backward"] + [f"forward{it or ''}" for it in its]
        names += ["forward_stale"] if c_t is not None else []
        times = {f"{name}{'' if design else '_one_thread'}": []
                 for design in (True, False) for name in names}

        def fresh(design):
            """The launches of ``names`` on fresh states of one design."""
            s = admm_stream._init(x0c, n_, nx, nu, None, params["fam"],
                                  params["cons"], rho0)
            run = admm_stream._KERNELS(tables, x0c, s, None, n_, nx, nu,
                                       **kw_, team=design)
            launches = [("backward", lambda: run.backward(1))]
            launches += [(f"forward{it or ''}", lambda it=it:
                          run.forward(it, False)) for it in its]
            if c_t is not None:
                sw = admm_stream._init(x0c, n_, nx, nu, c_t, params["fam"],
                                       params["cons"])
                warm = admm_stream._KERNELS(tables, x0c, sw, c_t, n_, nx, nu,
                                            **kw_, team=design)
                warm.backward(1)
                launches += [("forward_stale", lambda: warm.forward(0, True))]
            return launches

        for rep in range(TIME_REPS + 1):
            for design in (True, False):
                sfx = "" if design else "_one_thread"
                for name, fn in fresh(design):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    torch.cuda.synchronize()
                    if rep:     # the first launch of each warms up
                        times[name + sfx].append(start.elapsed_time(end))
        device = {}
        for design in (True, False) if profile else ():
            # The kernel's own device time (torch.profiler), without the
            # host's launch path, which the events above also hold.
            for name, fn in fresh(design):
                d = _device_times(torch, fn)
                device[name + ("" if design else "_one_thread")] = \
                    None if d is None else sum(
                        v for k, v in d.items() if "kernel" in k)
        rec = {"kind": "stream", "system": system, "N": n_, "B": B_,
               "ms": statistics.median(times["forward"]),
               "backward_ms": statistics.median(times["backward"])}
        rec.update({f"{k}_ms": statistics.median(v) for k, v in times.items()
                    if k not in ("forward", "backward")})
        if profile:
            rec["device_ms"] = device
        rec.update({"times_ms": times, "launch_counts": {
            k: v for k, v in admm_stream.launch_counts.items() if v},
            "card": card, "sm_clock_after": _smi("clocks.sm,clocks.max.sm")})
        print(json.dumps(rec), flush=True)
    for depth, lanes in ((36, 32768), (96, 16384)) if dot else ():
        from tinympc_tpu_torch.kernels import roofline as rf
        L = 95
        M, Ms, v = rf.dot_inputs(L, depth, lanes, "bf16", DEVICE)
        ms, times = _timed(torch, lambda: rf.run_dot(M, Ms, v, False, 1),
                           TIME_REPS)
        mcat = Ms.float().permute(1, 0, 2).reshape(depth, L * depth)
        ys = v.to(torch.bfloat16).float().repeat(L, 1)
        lib = _timed(torch, lambda: torch.matmul(mcat, ys), TIME_REPS)[0]
        mb, yb = mcat.to(torch.bfloat16), ys.to(torch.bfloat16)
        lib_b = _timed(torch, lambda: torch.matmul(mb, yb), TIME_REPS)[0]
        print(json.dumps({
            "kind": "dot_independent_bf16", "L": L, "depth": depth,
            "lanes": lanes, "ms": ms, "times_ms": times,
            "matmul_f32_ms": lib, "matmul_bf16_ms": lib_b, "card": card,
            "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}), flush=True)
        del M, Ms, v, mcat, ys, mb, yb


def race_consensus():
    """Small box consensus solves on the thread-group kernel whose scenario
    groups span thread-block clusters -- 4 groups of 16 (2 blocks), 2 of 32
    (4), 1 of 128 (16) and, in one block, 8 of 8 -- at N=12, max_iter 60,
    ct 1, rho_c 100, cold and then two warm solves, each bitwise against
    the same solve on the one-thread consensus kernel (csrc/admm_fused.cu,
    taken by giving the route rule no group launch). Returns the number of
    solves that differ."""
    import contextlib
    import torch
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import admm_fused as af
    N = 12
    kw = dict(dtype=torch.float32, device=DEVICE)
    Xref = torch.zeros((N, 12), **kw)
    Xref[:, 2] = 0.5
    prob = tt.with_consensus(_quad(tt, torch, N, max_iter=60), rho_c=100.0)

    @contextlib.contextmanager
    def one_thread():
        route = af.group_route
        af.group_route = lambda *a, **k: None
        try:
            yield
        finally:
            af.group_route = route

    bad = 0
    for ng, G in ((4, 16), (2, 32), (1, 128), (8, 8)):
        rng = np.random.default_rng(G)
        x = torch.as_tensor(rng.uniform(-0.3, 0.3, (ng, 1, 12))
                            + 0.05 * rng.uniform(-1, 1, (ng, G, 12)), **kw)
        c_g = c_o = None
        for step in range(3):
            af.entry_counts.update(dict.fromkeys(af.entry_counts, 0))
            if step == 0:
                a = tt.kernels.solve_fused(prob, Xref, None, x)
                with one_thread():
                    b = tt.kernels.solve_fused(prob, Xref, None, x)
            else:
                c_g = c_g or tt.init_carry(prob, ng * G)
                c_o = c_o or tt.init_carry(prob, ng * G)
                a = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_g)
                with one_thread():
                    b = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_o)
                c_g, c_o = a[2], b[2]
            fa, fb = _flat("t", a), _flat("t", b)
            same = fa.keys() == fb.keys() and all(
                torch.equal(fa[k], fb[k]) for k in fa)
            bad += not same
            print(f"race: consensus {ng} x {G} "
                  f"{'cold' if step == 0 else f'warm {step}'}: entries "
                  f"{ {k: v for k, v in af.entry_counts.items() if v} }, "
                  f"{'bitwise the one-thread solve' if same else 'DIFFERS'}"
                  f", iterations {int(a[0].iter.max())}", flush=True)
    return bad


def race_families():
    """Small resident solves on the thread-group kernel's families kinds --
    the rocket's cones, its box alone at fixed and adaptive rho (a box
    problem at (6, 3)), its cones at adaptive rho with apply_c, the
    quadrotor's static and time-varying planes under low ceilings and
    every family on both sides -- at N=12, B=20 (a partial last block),
    max_iter 20, ct 1, cold and then two warm solves, each bitwise against
    the same solve on csrc/admm_fused.cu (taken by giving the route rule
    no group launch). Returns the number of solves that differ."""
    import contextlib
    import torch
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import admm_fused as af
    N, B_ = 12, 20
    rng = np.random.default_rng(2)
    kw = dict(dtype=torch.float32, device=DEVICE)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x_r = torch.as_tensor(xinit * rng.uniform(0.9, 1.2, (B_, 1)), **kw)
    U_r = torch.zeros((N - 1, 3), **kw)
    U_r[:, 2] = 10.0
    X_r = torch.as_tensor(np.linspace(xinit, np.zeros(6), N), **kw)
    x_p, X_p = _plane_inputs(torch, B_, N, rng)
    rocket = lambda cones=True: tt.with_settings(
        _rocket(tt, torch, N, cones=cones), max_iter=20)
    r = tt.with_settings(rocket(), adaptive_rho=True)
    tabs = (r.cache.dKinf_drho, r.cache.dPinf_drho, r.cache.dC1_drho,
            r.cache.dC2_drho)
    adaptive = lambda p, **k: tt.with_settings(
        tt.with_sensitivities(p, tabs), adaptive_rho=True,
        adaptive_rho_min=0.05, **k)
    cases = [("rocket SOC", rocket(), x_r, X_r, U_r),
             ("rocket box", rocket(False), x_r, X_r, U_r),
             ("rocket box adaptive", adaptive(rocket(False)), x_r, X_r, U_r),
             ("rocket SOC adaptive apply_c", adaptive(
                 rocket(), adaptive_rho_apply_c=True), x_r, X_r, U_r)]
    cases += [(f"planes {k}", tt.with_settings(
        _planes(tt, torch, k == "tv", N), max_iter=20), x_p, X_p, None)
        for k in ("linear", "tv")]
    cases += [("mixed families", tt.with_settings(_mixed(tt, torch, N),
                                                  max_iter=20),
               x_p, X_p, None)]

    @contextlib.contextmanager
    def one_thread():
        route = af.group_route
        af.group_route = lambda *a, **k: None
        try:
            yield
        finally:
            af.group_route = route

    bad = 0
    for name, prob, x0, Xref, Uref in cases:
        c_g = c_o = None
        for step in range(3):
            af.entry_counts.update(dict.fromkeys(af.entry_counts, 0))
            if step == 0:
                a = tt.kernels.solve_fused(prob, Xref, Uref, x0)
                with one_thread():
                    b = tt.kernels.solve_fused(prob, Xref, Uref, x0)
            else:
                c_g = c_g or tt.init_carry(prob, B_)
                c_o = c_o or tt.init_carry(prob, B_)
                a = tt.kernels.solve_fused_warm(prob, Xref, Uref, x0, c_g)
                with one_thread():
                    b = tt.kernels.solve_fused_warm(prob, Xref, Uref, x0,
                                                    c_o)
                c_g, c_o = a[2], b[2]
            fa, fb = _flat("t", a), _flat("t", b)
            same = fa.keys() == fb.keys() and all(
                torch.equal(fa[k], fb[k]) for k in fa)
            entries = {k: v for k, v in af.entry_counts.items() if v}
            same = same and entries == {"tinympc_admm_group_families": 1,
                                        "tinympc_admm_fused": 1}
            bad += not same
            print(f"race: {name} {'cold' if step == 0 else f'warm {step}'}"
                  f": entries {entries}, "
                  f"{'bitwise the one-thread solve' if same else 'DIFFERS'}"
                  f", iterations {int(a[0].iter.max())}", flush=True)
    return bad


def race():
    """Small streamed solves whose launches run on lane teams, each
    bitwise against the same solve on one thread a lane: the quadrotor at
    fixed rho and, with the Crazyflie tables, at adaptive rho with and
    without apply_c, and the rocket's box alone at adaptive rho (a box
    problem at (6, 3)); and at fixed rho the rocket with its cones, the
    quadrotor's static and time-varying planes under low ceilings and
    every family on both sides (``_mixed``); N=16, B=20 (a partial last
    team block), max_iter 20, ct 1, so that iterations 5, 10 and 15 adapt
    rho; and consensus at rho_c 100 on the quadrotor in 8 groups of 8 (a
    block), 4 of 16, 2 of 32 and 1 of 128 (clusters of 2, 4 and 16
    blocks), and on the rocket's cones in 2 groups of 32 (a cluster of 2);
    cold, then warm
    from the carry of a warm solve from a zero carry. Prints one line a solve and exits
    non-zero when any differs. Small enough to run under
    ``compute-sanitizer --tool racecheck``, which reports the kernels'
    shared-memory hazards."""
    import functools
    import torch
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import admm_stream
    torch.backends.cuda.matmul.allow_tf32 = False
    N, B_ = 16, 20
    rng = np.random.default_rng(0)
    kw = dict(dtype=torch.float32, device=DEVICE)
    x_q = torch.as_tensor(rng.uniform(-0.3, 0.3, (B_, 12)), **kw)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x_r = torch.as_tensor(xinit * rng.uniform(0.9, 1.2, (B_, 1)), **kw)
    hover = torch.zeros((N, 12), **kw)
    hover[:, 2] = 1.0
    U_r = torch.zeros((N - 1, 3), **kw)
    U_r[:, 2] = 10.0
    X_r = torch.as_tensor(np.linspace(xinit, np.zeros(6), N), **kw)
    cf = tt.systems.crazyflie_sensitivity_tables()
    adaptive = lambda p, **k: tt.with_settings(p, adaptive_rho=True, **k)
    quad = lambda: _quad(tt, torch, N, 20)
    cases = [
        ("box", quad(), x_q, hover, None),
        ("box adaptive", adaptive(tt.with_sensitivities(quad(), cf)), x_q,
         hover, None),
        ("box adaptive apply_c", adaptive(tt.with_sensitivities(quad(), cf),
                                          adaptive_rho_apply_c=True),
         x_q, hover, None),
        ("rocket box adaptive", adaptive(tt.with_settings(
            _rocket(tt, torch, N, cones=False), max_iter=20),
            adaptive_rho_min=0.05), x_r, X_r, U_r),
        ("rocket SOC", tt.with_settings(_rocket(tt, torch, N), max_iter=20),
         x_r, X_r, U_r)]
    x_p, X_p = _plane_inputs(torch, B_, N, rng)
    cases += [(f"planes {k}", tt.with_settings(
        _planes(tt, torch, k == "tv", N), max_iter=20), x_p, X_p, None)
        for k in ("linear", "tv")]
    cases += [("mixed families", tt.with_settings(_mixed(tt, torch, N),
                                                  max_iter=20),
               x_p, X_p, None)]
    rng_c = np.random.default_rng(1)
    x_c = torch.as_tensor(rng_c.uniform(-0.3, 0.3, (128, 12)), **kw)
    x_rc = torch.as_tensor(xinit * rng_c.uniform(0.9, 1.2, (64, 1)), **kw)
    cases += [(f"consensus {128 // G} x {G}", tt.with_consensus(
        quad(), rho_c=100.0), x_c.reshape(128 // G, G, 12), hover, None)
        for G in (8, 16, 32, 128)]
    cases += [("rocket SOC consensus 2 x 32", tt.with_consensus(
        tt.with_settings(_rocket(tt, torch, N), max_iter=20), rho_c=100.0),
        x_rc.reshape(2, 32, 6), X_r, U_r)]
    one_thread = functools.partial(admm_stream._KERNELS, team=False)
    bad = race_consensus() + race_families()
    for name, prob, x0, Xref, Uref in cases:
        carry = None
        for kind in ("cold", "warm"):
            warm = kind == "warm"
            tables, x0c, c_t, params = admm_stream._prepare(
                prob, Xref, Uref, x0, carry, warm)
            admm_stream.launch_counts.update(
                dict.fromkeys(admm_stream.launch_counts, 0))
            team = admm_stream._loop(tables, x0c, c_t, prob.spec,
                                     admm_stream._KERNELS, **params)
            counts = {k: v for k, v in admm_stream.launch_counts.items()
                      if v}
            one = admm_stream._loop(tables, x0c, c_t, prob.spec,
                                    one_thread, **params)
            a, b = _flat("t", team), _flat("t", one)
            same = a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
            bad += not same
            print(f"race: {name} {kind}: team launches {counts}, "
                  f"{'bitwise the one-thread solve' if same else 'DIFFERS'}"
                  f", iterations {int(team[0].iter.max())}")
            carry = tt.kernels.solve_fused_streamed_warm(
                prob, Xref, Uref, x0, tt.init_carry(prob, x0.shape[0] * (
                    x0.shape[1] if x0.dim() == 3 else 1)))[2]
    return 1 if bad else 0


def build_report(path):
    import chip_smoke
    from tinympc_tpu_torch.kernels import _build
    names = [n for n in ("admm_group", "admm_fused", "closed_loop_fused",
                         "closed_loop_thread")
             if (_build.CSRC_DIR / f"{n}.cu").exists()]
    for n in names:
        if _build.library_path(n).exists():
            _build.library_path(n).unlink()
    logs = _build.build(names)
    log = "\n".join(logs[n] for n in names)
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = "\n".join(subprocess.run(
        [exe, "-sass", str(_build.library_path(n))], capture_output=True,
        text=True, timeout=600, check=True).stdout for n in names)
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                     line).strip()
        if cur is not None and ins:
            funcs[cur].append(ins)
    out, text = {}, []
    for fn, e in sorted(chip_smoke.ptxas_entries(log).items()):
        label = chip_smoke.kernel_label(fn)
        ins = funcs.get(fn)
        out[label] = dict(e, sass=None if ins is None else hashlib.sha256(
            "\n".join(ins).encode()).hexdigest())
        text += [f"== {label}"] + (ins or [])
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    # The instructions themselves, beside the report, for a textual diff.
    with open(path + ".sass", "w") as f:
        f.write("\n".join(text) + "\n")
    print(f"chip_compare: {len(out)} kernels of {', '.join(names)} written "
          f"to {path} (SASS text in {path}.sass)")


def diff_reports(a_path, b_path):
    a, b = (json.load(open(p)) for p in (a_path, b_path))
    bad = 0
    for k in sorted(set(a) & set(b)):
        regs = {f: (a[k].get(f), b[k].get(f)) for f in
                ("regs", "stack", "spill_st", "spill_ld")}
        same_ptxas = all(x == y for x, y in regs.values())
        same_sass = a[k]["sass"] is not None and a[k]["sass"] == b[k]["sass"]
        bad += not (same_ptxas and same_sass)
        print(f"{k}: ptxas {'same' if same_ptxas else regs}, SASS "
              f"{'same' if same_sass else 'DIFFERS'}")
    for k in sorted(set(a) ^ set(b)):
        print(f"{k}: only in {a_path if k in a else b_path}")
    print(f"chip_compare: {len(set(a) & set(b)) - bad} of "
          f"{len(set(a) & set(b))} common kernels the same")
    return 1 if bad else 0


def diff(a_path, b_path):
    if a_path.endswith(".json"):
        return diff_reports(a_path, b_path)
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    bad = 0
    for k in sorted(set(a) & set(b)):
        same = a[k].shape == b[k].shape and torch.equal(a[k], b[k])
        bad += not same
        print(f"{k}: {'same bits' if same else 'DIFFERS'}")
    for k in sorted(set(a) ^ set(b)):
        print(f"{k}: only in {a_path if k in a else b_path}")
    print(f"chip_compare: {len(set(a) & set(b)) - bad} of "
          f"{len(set(a) & set(b))} common entries bitwise equal, {bad} "
          f"differ, {len(set(a) ^ set(b))} in one file only")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "build":
        build_report(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) >= 2 and sys.argv[1] == "time":
        opts = dict(a.split("=", 1) if "=" in a else (a, "1")
                    for a in sys.argv[2:])
        batches = lambda key, dflt: tuple(
            int(b) for b in opts[key].split(",")) if key in opts else dflt
        # cold defaults to the main path's batch unless only another
        # kind is asked for
        only = any(k in opts for k in ("warm", "loop", "stream", "dot",
                                       "cons", "adapt", "fam", "tloop"))
        names = lambda key, every: () if key not in opts else every \
            if opts[key] == "1" else tuple(opts[key].split(","))
        time_kernels(batches("cold", () if only else (TIME_B,)),
                     batches("loop", ()),
                     "profile" in opts, batches("warm", ()),
                     batches("stream", ()), "dot" in opts,
                     names("cons", ("tree", "g16")),
                     names("adapt", ("hard", "warm")),
                     names("fam", FAM_TIMES), batches("tloop", ()))
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "race":
        sys.exit(race())
    if len(sys.argv) == 4 and sys.argv[1] == "diff":
        sys.exit(diff(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
