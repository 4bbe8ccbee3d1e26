#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card, each through the entry points a user
calls, and holds every kernel against its plain PyTorch version:

* the cold main path -- the headline workload of bench.py:build():
  Crazyflie quadrotor at 20 Hz (nx=12, nu=4), horizon N=20, box bounds +-5
  on x and +-0.5 on u, hover reference, cold start, fixed rho, B=32768
  problems with x0 ~ U[-0.5, 0.5]^12 from numpy's default_rng(0),
  max_iter=100, check_termination=25, through setup -> with_bounds ->
  with_settings -> kernels.solve_fused (csrc/admm_fused.cu, cold);
* the serving loop -- the closed-loop workload of bench_all.py:569-596: the
  same quadrotor at N=10, hover reference z=1, B=16384 plants with
  x0 ~ U[-0.3, 0.3]^12 from default_rng(0), T=50 MPC steps, max_iter=100,
  check_termination=5, through kernels.closed_loop_fused
  (csrc/closed_loop_fused.cu); then bench_all.py:601-610's max_iter=500
  regime with shift_warm off and on;
* the external-plant loop of examples/serving_fleet.py:62-77 at B=16384
  (x0 = hover + U[-0.3, 0.3]^12, max_iter=100, check_termination=1):
  5 warm solves through kernels.solve_fused_warm (csrc/admm_fused.cu,
  warm), the plant stepped with the applied input plus 0.01 N(0,1)
  actuator noise from the seeded generator;
* the constraint families on the families kernel (csrc/admm_fused.cu with
  csrc/admm_families.cuh): bench_all.py:199-222's "rocket SOC cold solve
  (fused)" -- rocket_landing_20hz (nx=6, nu=3), N=10, box x in
  [-5,-5,-0.5,-10,-10,-20]..[5,5,100,10,10,20] and u in [-10, 105], state
  cone (0, 3, mu 0.25) and input cone (0, 3, mu 0.5), max_iter 100, ct 1,
  abs_pri_tol 2e-3, B=16384 with x0 = xinit U[0.9, 1.2] (default_rng(0)),
  Xref = linspace(xinit, 0, 10), Uref[:, 2] = 10 -- through setup ->
  with_bounds -> with_cones -> with_settings -> kernels.solve_fused; the
  same problem as an external-plant sequence of 5 warm solves
  (x+ = A x + B u0 + f); and the hyperplane demos of
  examples/scenarios.py:121-170 as a cold batch: quadrotor_50hz, N=10, box
  off, z <= 3 and sum(u) <= 6 (tv: z below the demo's first window of
  z_lim_total), max_iter 100, ct 1, B=16384, x0 = [-2, -2, 1, 0...] +
  0.1 U[-1, 1]^12 (default_rng(0)), Xref the demo's step-0 window;
* adaptive rho on the adaptive instantiation of csrc/admm_fused.cu (with
  csrc/admm_adaptive.cuh): bench_all.py:401-446's "to-convergence 500it
  hard batch (adaptive rho)" -- the quadrotor at N=20, rho0=5, box +-5 /
  +-0.5, z reference 1, B=32768 with x0 ~ U[-0.5, 0.5]^12
  (default_rng(0)), max_iter 500, check_termination 1, the sensitivities
  from compute_sensitivities -- through setup -> with_bounds ->
  with_settings(adaptive_rho=True) -> kernels.solve_fused, with fixed rho
  on the same inputs beside it; bench_all.py:458-487's mis-tuned rho0=85
  (fixed / adaptive / guarded tol 3), and rho0=1000, where float32 at
  "highest" finds fixed rho mis-tuned; and phase 8's external-plant
  sequence with adaptive rho (5 warm solves, rho riding the carry).

Phases, each of which raises on failure:

1. card: name and power limit (nvidia-smi); TF32 off;
2. build: compile both csrc/*.cu for sm_90a, together (timed, set-up),
   with each kernel's ptxas register and spill lines;
3. cold kernel against its plain version at B=1000 (ragged) and 1024,
   check_termination 25 and 1; and against the port's admm.solve at B=256;
4. cold main path at B=32768 and bench.py's two other regimes;
5. warm kernel against its plain version, small: B=1000, an external-plant
   sequence of 6 solves at check_termination 1 and 5;
6. closed-loop kernel against its plain version, small: B=1000, T=20, at
   ct 5; ct 1 with reset_duals; ct 5 with shift_warm; ct 5 and ct 1 with
   reset_duals on a moving reference, the last with rounding witnesses;
7. serving path at full width (B=16384, T=50, ct 5): launch count, kernel
   against plain version, kernel time, MPC steps/s and its bound; then the
   max_iter=500 regimes;
8. the external-plant loop at B=16384, ct 1;
9. families kernels against their plain versions, small: cold and warm,
   (nx, nu) = (6, 3) (the rocket's cones) and (12, 4) (the quadrotor's
   hyperplanes, with z ceilings low enough that the state planes bite),
   B=1000, ct 1 and 5; warm as sequences of 4 solves;
10. the rocket SOC cold batch at B=16384;
11. the rocket SOC external-plant sequence at B=16384, 5 warm solves;
12. the hyperplane demos as cold batches at B=16384, static and tv; then
   the same under phase 9's low ceilings;
13. adaptive kernel against its plain versions, small: B=1000, N=20, ct 1,
   cold at rho_tol 1, at rho_tol 3 from rho0=85 (max_iter 500), with
   apply_c; warm, 6 solves of an external plant (N=10);
14. the adaptive hard batch at B=32768, and fixed rho on the same inputs;
15. the mis-tuned rho0=85 and rho0=1000 batches at B=32768: fixed,
   adaptive, guarded;
16. the adaptive external-plant sequence at B=16384, 5 warm solves;
17. the kernels line, then the device line last.

Every comparison prints its numbers; a missed bar fails the run at its end.
Bar of kernel against plain version (float32; the kernels sum each matrix
product as an FMA chain in column order, the plain versions through cuBLAS,
whose order depends on the shape): max|dx|, max|du| <= 1e-4, identical
solved fraction, >= 99% identical iteration counts. Where a lane that
crosses the tolerance one check earlier on one side ends on another
iterate, the values are held on the lanes whose counts agree (at every
step so far, in the warm sequences and closed loops). Closed loops hold
the solved fraction over (step, lane) within 0.001; the full-width
external-plant loop holds it within 2 lanes of 16384. Cold max_iter 500
holds its agreed lanes to 1e-3, as do the adaptive batches
of max_iter 500; adaptive solves also hold each lane's final rho to
within 1e-3 (relative) on the lanes whose counts agree, and the small
adaptive batches are held, against the plain version on the card and on
the CPU, to the plain version's own spread between the two. A closed loop at
check_termination 1 on a moving reference puts many (step, lane) counts
on a float32 tie, so two summation orders disagree on more than 1% of
them whichever two they are: there the count bar is the plain version's
own agreement between the GPU and the CPU (another order for every
product) less 0.005, where that is below 99%, and the kernel must be as
close as the plain version to the port's closed_loop in float64, to
0.005. The small families batches sit on such ties too: there the kernel
is held to the bar against the plain version on the CPU (on the lanes
whose counts agree), and against the plain version on the card to that
version's own spread from the CPU. Each phase's start prints the seconds
since the script began. Exits non-zero, printing no result, without a CUDA
device or outside a checkout of the repository.
"""
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N_HORIZON = 20
BATCH = 32768
HOVER = [0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
BAR_ATOL = 1e-4
BAR_ITER_SHARE = 0.99
BAR_LOOP_SOLVED = 1e-3
WITNESS_SLACK = 0.005
REPS = 7
DEVICE = "cuda"
# Comparisons that missed their bar; the run fails at its end if any did,
# after every phase has printed its numbers.
FAILURES = []
# The serving loop of bench_all.py:569-596.
SERVE_N, SERVE_B, SERVE_T = 10, 16384, 50
# The constraint-family paths: batch of the full-width runs, and of the
# small comparisons.
FAM_N, FAM_B = 10, 16384
FAM_SMALL_B = 1000
# z ceilings of the quadrotor hyperplane problems low enough that the state
# planes bite on part of the lanes while most still converge.
LOW_CEILING = dict(linear=np.full(FAM_N, 1.24),
                   tv=1.07 + 0.02 * np.arange(FAM_N))
ROCKET_XINIT = [4.0, 2.0, 20.0, -3.0, 2.0, -4.5]
QUAD_START = [-2.0, -2.0, 1.0] + [0.0] * 9
QUAD_GOAL = [2.0, 2.0, 4.0] + [0.0] * 9
# Adaptive rho: the hard batch of bench_all.py:401-405 (N=20, B=32768,
# max_iter 500, check_termination 1, z reference 1), its mis-tuned rho0
# (:458-487), and the small comparisons; the adaptive external-plant
# sequence runs at SERVE_B, N=SERVE_N.
ADAPT_B, ADAPT_ITER, ADAPT_SMALL_B = 32768, 500, 1000
MISTUNED_RHO = 85.0
# A rho0 that float32 at matmul_precision "highest" finds mis-tuned on the
# hard batch. At 85 fixed rho solves most lanes in float32: so does the JAX
# package's XLA path on the CPU (tests/test_torch_mistuned.py, run as a
# script, sweeps rho0 there), and bench_all.py's direction for 85, taken on
# a TPU at "high", shows in float32 only from rho0 ~500 up.
DETUNED_RHO = 1000.0
RHO_RTOL = 1e-3

# Published dense peaks (NVIDIA data sheets): FP32 on the CUDA cores, and
# device-memory bandwidth. The SXM part is the default.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12))


def log(msg):
    print(msg, flush=True)


START = time.perf_counter()


def phase(msg):
    """Log the start of a phase with the seconds since the script began."""
    log(f"{msg} [{time.perf_counter() - START:.1f} s]")


def on_cpu(obj):
    """A copy of a Solution or FusedCarry with every tensor on the CPU."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no published peak rates for {name!r}")


def problem(tt, torch, max_iter, ct, N=N_HORIZON, device=None, dtype=None):
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype or torch.float32,
                    device=device or DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct)


def inputs(torch, B, N=N_HORIZON, spread=0.5):
    x0 = np.random.default_rng(0).uniform(-spread, spread, (B, 12))
    Xref = np.tile(HOVER, (N, 1))
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def rocket_problem(tt, torch, max_iter, ct, dtype=None):
    """bench_all.py:199-222's rocket landing with its cones, through the
    user's entry points."""
    s = tt.systems.rocket_landing_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=FAM_N, f=s["f"], dtype=dtype or torch.float32,
                    device=DEVICE)
    prob = tt.with_bounds(
        prob, x_min=np.tile([-5.0, -5.0, -0.5, -10.0, -10.0, -20.0],
                            (FAM_N, 1)),
        x_max=np.tile([5.0, 5.0, 100.0, 10.0, 10.0, 20.0], (FAM_N, 1)),
        u_min=-10.0, u_max=105.0)
    prob = tt.with_cones(prob, state_cones=[(0, 3, 0.25)],
                         input_cones=[(0, 3, 0.5)])
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=2e-3)


def rocket_inputs(torch, B):
    """x0 = xinit U[0.9, 1.2] per lane (default_rng(0)), Xref =
    linspace(xinit, 0, N), Uref[:, 2] = 10."""
    xinit = np.asarray(ROCKET_XINIT)
    x0 = xinit * np.random.default_rng(0).uniform(0.9, 1.2, (B, 1))
    Xref = np.linspace(xinit, np.zeros(6), FAM_N)
    Uref = np.zeros((FAM_N - 1, 3))
    Uref[:, 2] = 10.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return tuple(torch.as_tensor(a, **kw) for a in (x0, Xref, Uref))


def quad_plane_problem(tt, torch, tv, max_iter, ct, zmax=None, dtype=None):
    """The hyperplane demos of examples/scenarios.py:121-170: quadrotor at
    50 Hz, box off, z <= 3 (tv: z under the demo's first window of
    z_lim_total) and sum(u) <= 6. ``zmax`` (an (N,) ceiling) replaces the
    demo's z ceiling."""
    s = tt.systems.quadrotor_50hz()
    N = FAM_N
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype or torch.float32, device=DEVICE)
    if zmax is None:
        z_lim_total = 1.1 + (3.0 - 1.1) * np.arange(50) / (50 - N - 1)
        zmax = z_lim_total[:N] if tv else np.full(N, 3.0)
    if tv:
        Ax = np.zeros((N, 1, 12))
        Ax[:, 0, 2] = 1.0
        prob = tt.with_tv_linear_constraints(
            prob, Ax, np.asarray(zmax).reshape(N, 1), np.ones((N - 1, 1, 4)),
            np.full((N - 1, 1), 6.0))
    else:
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        prob = tt.with_linear_constraints(prob, Ax, [float(zmax[0])],
                                          np.ones((1, 4)), [6.0])
    prob = tt.with_bounds(prob, enable=False)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)


def quad_plane_inputs(torch, B):
    """x0 = [-2, -2, 1, 0...] + 0.1 U[-1, 1]^12 (default_rng(0)), Xref the
    demo's step-0 window from the start toward the goal."""
    start, goal = np.asarray(QUAD_START), np.asarray(QUAD_GOAL)
    x0 = start + 0.1 * np.random.default_rng(0).uniform(-1, 1, (B, 12))
    alpha = np.arange(FAM_N)[:, None] / 49.0
    Xref = (1 - alpha) * start + alpha * goal
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw), None


def fail(label, ok, msg):
    """Record a missed bar (printed now, failing the run at its end)."""
    if not ok:
        FAILURES.append(f"{label}: {msg}")
        log(f"  FAIL {label}: {msg}")


def compare(torch, label, sol_k, sol_p, res_k=None, res_p=None,
            atol=BAR_ATOL, lanes="all", solved_tol=0.0,
            share=BAR_ITER_SHARE, among=None):
    """Kernel against plain version. ``lanes="all"`` holds every lane to
    ``atol`` (the bar); ``lanes="same_iters"`` holds only the lanes whose
    iteration counts agree, for the long regimes where a lane that crosses
    the tolerance one check earlier on one side ends on another iterate; a
    bool tensor names the lanes held. Solved fractions must be identical,
    or within ``solved_tol``. Returns the max abs difference over x and u
    of the lanes held. ``among`` (bool lanes) counts identical iteration
    counts among those lanes only, default all."""
    B = sol_k.iter.shape[0]
    same = sol_k.iter == sol_p.iter
    if isinstance(lanes, str):
        held = torch.ones_like(same) if lanes == "all" else same
    else:
        held, lanes = lanes, "given"
    dx_all = (sol_k.x - sol_p.x).abs().amax(dim=(0, 2))
    du_all = (sol_k.u - sol_p.u).abs().amax(dim=(0, 2))
    dx = dx_all[held].max().item()
    du = du_all[held].max().item()
    same_iter = (same if among is None else same[among]).float().mean() \
        .item()
    sf_k = sol_k.solved.float().mean().item()
    sf_p = sol_p.solved.float().mean().item()
    finite = bool(torch.isfinite(sol_k.x).all() and torch.isfinite(sol_k.u)
                  .all())
    dres = None if res_k is None else (res_k - res_p).abs().max().item()
    bitwise = bool(torch.equal(sol_k.x, sol_p.x) and torch.equal(
        sol_k.u, sol_p.u) and torch.equal(sol_k.iter, sol_p.iter))
    log(f"  {label}: B={B} bitwise={bitwise} lanes held={lanes} "
        f"({held.float().mean().item():.5f}) max|dx|={dx:.3e} "
        f"max|du|={du:.3e} (all lanes {dx_all.max().item():.3e} "
        f"{du_all.max().item():.3e}) max|dres|={dres} "
        f"same_iters={same_iter:.5f} solved_frac kernel={sf_k:.5f} "
        f"plain={sf_p:.5f}")
    fail(label, finite, "kernel output is not finite")
    fail(label, dx <= atol and du <= atol, f"kernel differs from plain "
         f"version by {max(dx, du):.3e} > {atol}")
    fail(label, abs(sf_k - sf_p) <= solved_tol,
         f"solved fraction {sf_k} vs {sf_p}")
    fail(label, same_iter >= share, f"only {same_iter:.4f} of lanes have "
         f"identical iteration counts (bar {share:.4f})")
    return max(dx, du)


def compare_carry(torch, label, c_k, c_p, held, atol=BAR_ATOL):
    """The warm carries' vnew, v, g and y (lane-last) on the held lanes, and
    the family duals and x/u where the carry has them."""
    errs = {}
    names = ("vnew", "v", "g", "y") + tuple(
        k for k in ("gc", "yc", "gl", "yl", "gtv", "ytv", "x", "u")
        if getattr(c_k, k) is not None)
    for name in names:
        d = (getattr(c_k, name) - getattr(c_p, name)).abs().amax(dim=(0, 1))
        errs[name] = d[held].max().item()
        fail(label, bool(torch.isfinite(getattr(c_k, name)).all()),
             f"carry.{name} is not finite")
    log(f"  {label} carry: " + " ".join(f"max|d{k}|={v:.3e}"
                                        for k, v in errs.items()))
    fail(label, max(errs.values()) <= atol, f"carry differs from plain "
         f"version by {max(errs.values()):.3e} > {atol}")
    return max(errs.values())


def compare_loop(torch, label, out_k, out_p, share=BAR_ITER_SHARE):
    """Closed loop, kernel against plain version: at least ``share`` (99%)
    identical (step, lane) iteration counts, solved fractions within 0.001,
    and xs/us to 1e-4 on the lanes whose counts agree at every step.
    Returns the max abs difference of the lanes held."""
    xs_k, us_k, it_k, sv_k = out_k
    xs_p, us_p, it_p, sv_p = out_p
    same = it_k == it_p
    held = same.all(dim=0)
    dxs = (xs_k - xs_p).abs().amax(dim=(0, 2))
    dus = (us_k - us_p).abs().amax(dim=(0, 2))
    dx = dxs[held].max().item() if held.any() else float("inf")
    du = dus[held].max().item() if held.any() else float("inf")
    same_iter = same.float().mean().item()
    sf_k = sv_k.float().mean().item()
    sf_p = sv_p.float().mean().item()
    finite = bool(torch.isfinite(xs_k).all() and torch.isfinite(us_k).all())
    log(f"  {label}: T={it_k.shape[0]} B={it_k.shape[1]} lanes held "
        f"{held.float().mean().item():.5f} max|dxs|={dx:.3e} "
        f"max|dus|={du:.3e} (all lanes {dxs.max().item():.3e} "
        f"{dus.max().item():.3e}) same (step, lane) iters={same_iter:.5f} "
        f"solved_frac kernel={sf_k:.5f} plain={sf_p:.5f} mean iters/step "
        f"kernel={it_k.float().mean().item():.4f} "
        f"plain={it_p.float().mean().item():.4f}")
    deltas, counts = torch.unique((it_k - it_p)[~same], return_counts=True)
    log(f"    lanes with other counts, by step: "
        f"{(~same).sum(dim=1).tolist()}; count differences "
        f"{dict(zip(deltas.tolist(), counts.tolist()))}")
    fail(label, finite, "kernel output is not finite")
    fail(label, dx <= BAR_ATOL and du <= BAR_ATOL, f"kernel differs from "
         f"plain version by {max(dx, du):.3e} > {BAR_ATOL}")
    fail(label, abs(sf_k - sf_p) <= BAR_LOOP_SOLVED,
         f"solved fraction {sf_k} vs {sf_p}")
    fail(label, same_iter >= share, f"only {same_iter:.4f} of (step, lane) "
         f"pairs have identical iteration counts (bar {share:.4f})")
    return max(dx, du)


def rounding_floor(torch, tt, label, max_iter, ct, xref, x0, T, opts, out_k,
                   out_p):
    """Witnesses for a closed loop whose iteration counts sit on float32
    ties: the same plain version on the CPU (every matrix product summed in
    another order) and the port's closed_loop (admm.solve) in float64 on
    the card. Records a failure unless the kernel agrees with the float64
    loop on as many (step, lane) counts as the plain version does, less
    WITNESS_SLACK. Returns the count bar of the kernel against the plain
    version: 99%, or the plain version's agreement with itself across the
    two orders less WITNESS_SLACK where that is lower."""
    prob_c = problem(tt, torch, max_iter, ct, N=SERVE_N, device="cpu")
    out_c = tt.kernels.closed_loop_fused_reference(
        prob_c, xref.cpu(), x0.cpu(), T, **opts)
    prob64 = problem(tt, torch, max_iter, ct, N=SERVE_N,
                     dtype=torch.float64)
    out_64 = tt.closed_loop(prob64, tt.init_state(prob64, (x0.shape[0],)),
                            x0.double(), xref.double(), T, **opts)
    it_k, it_p, it_c, it_64 = (o[2].cpu() for o in (out_k, out_p, out_c,
                                                     out_64))
    same = lambda a, b: (a == b).float().mean().item()
    s_cp, s_k64, s_p64 = same(it_c, it_p), same(it_k, it_64), same(it_p, it_64)
    log(f"  {label} witnesses: identical (step, lane) counts plain(cpu) vs "
        f"plain(gpu) {s_cp:.5f}, kernel vs closed_loop float64 {s_k64:.5f}, "
        f"plain(gpu) vs float64 {s_p64:.5f}, plain(cpu) vs float64 "
        f"{same(it_c, it_64):.5f}, kernel vs plain(cpu) "
        f"{same(it_k, it_c):.5f}")
    fail(label, s_k64 >= s_p64 - WITNESS_SLACK, f"kernel agrees with the "
         f"float64 loop on {s_k64:.4f} of counts, the plain version on "
         f"{s_p64:.4f}")
    return min(BAR_ITER_SHARE, s_cp - WITNESS_SLACK)


def plain_spread(torch, sol_p, sol_c, among, c_p=None, c_c=None):
    """How far the plain version is from itself when every product is
    summed in another order: its run on the card (``sol_p``, carry
    ``c_p``) against its run on the CPU (``sol_c``, ``c_c``). Returns the
    share of identical counts among the ``among`` lanes, the difference of
    the solved fractions, the largest difference of x, u and the carry's
    fields on the lanes whose counts agree, and those lanes."""
    it_p, it_c = sol_p.iter.cpu(), sol_c.iter.cpu()
    same = it_p == it_c
    held = same & among
    share = same[among].float().mean().item()
    dsf = abs(sol_p.solved.float().mean().item()
              - sol_c.solved.float().mean().item())
    pairs = [(sol_p.x.cpu(), sol_c.x, 1), (sol_p.u.cpu(), sol_c.u, 1)]
    if c_p is not None:     # carry fields are lane-last
        pairs += [(getattr(c_p, f.name).cpu(), getattr(c_c, f.name),
                   getattr(c_p, f.name).ndim - 1)
                  for f in dataclasses.fields(c_p)
                  if getattr(c_p, f.name) is not None]
    dval = 0.0
    for a, b, lane_axis in pairs:
        d = (a - b).abs().amax(dim=tuple(k for k in range(a.ndim)
                                         if k != lane_axis))
        if held.any():
            dval = max(dval, d[held].max().item())
    return share, dsf, dval, held


def spread_bars(label, share_c, dsf_c, dval_c, B):
    """Bars of a kernel-vs-plain comparison from the plain version's own
    spread: identical counts at least min(99%, its share less
    WITNESS_SLACK); solved fractions within its difference plus one lane;
    values within max(1e-4, twice its value difference)."""
    share = min(BAR_ITER_SHARE, share_c - WITNESS_SLACK)
    solved_tol = dsf_c + 1 / B
    atol = max(BAR_ATOL, 2 * dval_c)
    log(f"  {label} plain(gpu) vs plain(cpu): identical counts "
        f"{share_c:.5f}, solved fractions {dsf_c:.5f} apart, max value "
        f"difference {dval_c:.3e} on agreeing lanes -> bars: counts "
        f"{share:.4f}, solved {solved_tol:.5f}, values {atol:.3e}")
    return share, solved_tol, atol


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(torch, fn):
    """Milliseconds of one call of ``fn`` on the host clock, to the end of
    its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def family_ops(spec):
    """Operations of the constraint families beyond the box in one ADMM
    iteration of one lane (1 each for an add, multiply, divide, square
    root, compare or select): per row and family the candidate x + dual,
    the dual update and the linear-cost term (6 a feature); per cone and
    row the norm, the case select and the scale (3 (dim - 1) + 10); per
    hyperplane and row the dot, the test, the step (val - b) / ||a||^2 and
    the axpy (4 F + 3). ||a||^2 is an input: it is summed once, when the
    table is packed, not per lane."""
    ops = 0
    for rows, F, cones, nlin, ntv in (
            (spec.N, spec.nx, spec.enabled_state_cones, spec.n_state_lin,
             spec.n_tv_state_lin),
            (spec.N - 1, spec.nu, spec.enabled_input_cones, spec.n_input_lin,
             spec.n_tv_input_lin)):
        families = bool(cones) + bool(nlin) + bool(ntv)
        ops += rows * (6 * F * families
                       + sum(3 * (dim - 1) + 10 for _, dim in cones)
                       + (nlin + ntv) * (4 * F + 3))
    return ops


def iteration_ops(N, nx, nu):
    """Operations of one ADMM iteration of one lane: the backward sweep's
    [B';AmBKt]p, Quu w and Kinf'r products and the forward sweep's
    [Kinf;A]x and Bu products (an FMA counts as 2 operations), plus the
    elementwise work of the linear cost, projection and dual update (1
    each)."""
    fma = (N - 1) * ((nu + nx) * nx + nu * nu + nx * nu) \
        + (N - 1) * ((nu + nx) * nx + nx * nu)
    elementwise = (N - 1) * (6 * nx + 5 * nu) + N * nx * 5 \
        + (N - 1) * (nu * 6 + 2 * nx)
    return 2 * fma + elementwise


def fused_work(N, nx, nu, B, iter_sum, carry_floats=0, spec=None):
    """Operations and bytes a fused solve needs for this run: the run's
    summed iteration count times :func:`iteration_ops` (plus
    :func:`family_ops` of ``spec``); bytes are x0 read once and x, u,
    iterations, solved flags and residuals written once, plus a warm
    carry of ``carry_floats`` floats a lane read and written once."""
    per_iter = iteration_ops(N, nx, nu) + (0 if spec is None
                                           else family_ops(spec))
    ops = float(iter_sum) * per_iter
    nbytes = 4 * B * nx + 4 * B * (N * nx + (N - 1) * nu) + B * (4 + 1 + 16)
    nbytes += 2 * 4 * B * carry_floats
    return ops, nbytes


def adaptive_ops(N, nx, nu, apply_c):
    """Operations adaptive rho adds to one ADMM iteration of one lane: the
    sensitivity products dKinf x and dKinf^T r of every row (and dC1 w,
    dC2 p under apply_c), each scaled by drho and added (2 operations an
    output), and the terminal term's drho * (-dPinf^T Xref) (2 a
    feature)."""
    fma = (N - 1) * (nu * nx + nx * nu)
    scale = (N - 1) * (nu + nx) + nx
    if apply_c:
        fma += (N - 1) * (nu * nu + nx * nx)
        scale += (N - 1) * (nu + nx)
    return 2 * fma + 2 * scale


def adaptation_ops(N, nx, nu):
    """Operations of one rho adaptation of one lane (every 5th iteration):
    A^T g and B^T g of every dynamics row, Pinf x and dPinf x of the last
    state, the dynamics rows (A x + B u) - x+ (1 a feature; the products
    are the rollout's), the elementwise P x + q + A^T y terms and the
    max-abs updates of the residuals and norms (10 a feature), and the
    prediction (10)."""
    fma = (N - 1) * (nx * nx + nu * nx) + 2 * nx * nx
    elementwise = (N - 1) * nx + 10 * (N * nx + (N - 1) * nu) + 10
    return 2 * fma + elementwise


def adaptations(iters):
    """Adaptations a lane that ran ``iters`` iterations made: iterations
    5, 10, ... below ``iters``, summed over the lanes."""
    return int(((iters.long() - 1).clamp(min=0) // 5).sum().item())


def adaptive_work(N, nx, nu, B, iters, apply_c, carry_floats=0):
    """Operations and bytes of an adaptive fused solve for this run: the
    fixed-rho work of :func:`fused_work` plus :func:`adaptive_ops` on every
    iteration and :func:`adaptation_ops` on every adaptation the run made;
    bytes add the final rho row (and a warm carry, rho included)."""
    iter_sum = int(iters.sum().item())
    ops, nbytes = fused_work(N, nx, nu, B, iter_sum, carry_floats)
    ops += float(iter_sum) * adaptive_ops(N, nx, nu, apply_c) \
        + float(adaptations(iters)) * adaptation_ops(N, nx, nu)
    return ops, nbytes + 4 * B


def compare_rho(label, rho_k, rho_p, held, rtol=RHO_RTOL):
    """Final rho rows of kernel and plain version on the held lanes,
    within ``rtol``; returns the largest relative difference."""
    rel = ((rho_k - rho_p).abs() / rho_p.abs())[held]
    worst = rel.max().item() if held.any() else 0.0
    moved = (rho_k != rho_k.flatten()[0]).float().mean().item()
    log(f"  {label}: final rho max rel diff {worst:.3e} on held lanes; "
        f"quartiles {[round(q, 4) for q in quartiles(rho_k)]}")
    fail(label, worst <= rtol and bool((rho_k > 0).all()),
         f"final rho differs by {worst:.3e} > {rtol} (or is not positive)")
    return worst


def quartiles(t):
    t = t.flatten().float().cpu()
    return [t.quantile(q).item() for q in (0.0, 0.25, 0.5, 0.75, 1.0)]


def lane_carry_floats(carry):
    """Floats a lane of a warm carry holds."""
    return sum(getattr(carry, f.name)[..., 0].numel()
               for f in dataclasses.fields(carry)
               if getattr(carry, f.name) is not None)


def loop_work(N, nx, nu, B, T, iter_sum):
    """Operations and bytes of a fused closed loop for this run: the summed
    (step, lane) iteration count times :func:`iteration_ops`, plus per step
    and lane the terminal reference term Pinf^T x (nx^2 FMA) and the plant
    step A x + B u + f; bytes are x0 and the reference read once and xs,
    us, iterations and solved flags written once."""
    per_step = 2 * nx * nx + 2 * (nx * nx + nx * nu) + 2 * nx
    ops = float(iter_sum) * iteration_ops(N, nx, nu) \
        + float(T * B) * per_step
    nbytes = 4 * B * nx + 4 * (T + N - 1) * nx \
        + T * B * (4 * nx + 4 * nu + 4 + 1)
    return ops, nbytes


def bound(ops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = ops / peak_flops, nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def ptxas_entries(text):
    """Registers, stack frame and spill bytes of each entry function in
    ``nvcc -Xptxas -v`` output, by mangled name."""
    out, cur, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None and props == cur:
            out[cur].update(stack=int(m[1]), spill_st=int(m[2]),
                            spill_ld=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur]["regs"] = int(m[1])
    return out


def kernel_label(fn):
    """A readable name for a mangled kernel name of csrc/."""
    m = re.search(r"ILi(\d+)ELi(\d+)ELb([01])EN7tinympc\d+(NoFamilies|"
                  r"Families)", fn)
    if m:
        kind = "families" if m[4] == "Families" else "box"
        a = re.search(r"AdaptiveRhoILi\d+ELi\d+ELb([01])E", fn)
        if a:
            kind = "adaptive apply_c" if a[1] == "1" else "adaptive"
        mode = "warm" if m[3] == "1" else "cold"
        return f"admm_fused {kind} {mode} ({m[1]}, {m[2]})"
    return "closed_loop_fused" if "closed_loop" in fn else fn


def check_rounding(torch, lib, n=1 << 24):
    """The families kernel's division and square root (div_rn, sqrt_rn in
    csrc/admm_families.cuh) against IEEE's, bitwise, on n random float
    pairs of every exponent plus zeros, infinities, NaN and subnormals.
    Returns the number of results that differ."""
    import ctypes
    g = torch.Generator(device="cpu").manual_seed(0)
    bits = torch.randint(-2 ** 31, 2 ** 31, (2, n), generator=g,
                         dtype=torch.int64).to(torch.int32)
    a, b = bits.view(torch.float32).to(DEVICE)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-45, -1e-45, 1.1754942e-38,
                            3.4028235e38, 1.0, 3.0, 0.25],
                           device=DEVICE)
    k = special.numel()
    a[:k * k] = special.repeat_interleave(k)
    b[:k * k] = special.repeat(k)
    q, r = torch.empty_like(a), torch.empty_like(a)
    fn = lib.tinympc_admm_fused_check_rounding
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    err = fn(n, a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rounding check launch failed: CUDA error {err}")
    torch.cuda.synchronize()

    def differ(x, y):
        both_nan = torch.isnan(x) & torch.isnan(y)
        return int(((x.view(torch.int32) != y.view(torch.int32))
                    & ~both_nan).sum().item())

    return differ(q, a / b) + differ(r, torch.sqrt(a.abs()))


def adaptive_problem(tt, torch, rho, N, max_iter, ct, tol=1.0, apply_c=False,
                     tables=None):
    """The quadrotor of bench_all.py:401-403 with adaptive rho, through the
    user's entry points: with_settings computes the rho sensitivities
    (compute_sensitivities) unless ``tables`` (dKinf, dPinf, dC1, dC2) are
    given."""
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=N,
                    dtype=torch.float32, device=DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    if tables is not None:
        prob = tt.with_sensitivities(prob, tables)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            adaptive_rho=True, adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c)


def sensitivity_tables(prob):
    c = prob.cache
    return c.dKinf_drho, c.dPinf_drho, c.dC1_drho, c.dC2_drho


def adaptive_small(torch, tt, convert, label, prob, x0, Xref, B):
    """An adaptive cold batch, kernel against its plain version on the CPU
    at the default bar, and against its plain version on the card at the
    bar of the plain version's own spread between the two (its counts,
    solved fraction and values; never looser than the default bar); final
    rho within RHO_RTOL on the lanes whose counts agree."""
    prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                        "cpu")
    sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
    sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, None, x0)
    sol_c, res_c = tt.kernels.solve_fused_reference(prob_c, Xref.cpu(), None,
                                                    x0.cpu())
    torch.cuda.synchronize()
    everyone = torch.ones(B, dtype=torch.bool)
    share, solved_tol, atol = spread_bars(
        label, *plain_spread(torch, sol_p, sol_c, everyone)[:3], B)
    sol_kc = on_cpu(sol_k)
    for other, sol_o, res_o, bars in (
            ("plain(cpu)", sol_c, res_c, {}),
            ("plain(gpu)", on_cpu(sol_p), res_p.cpu(),
             dict(atol=atol, solved_tol=solved_tol, share=share))):
        name = f"{label} vs {other}"
        compare(torch, name, sol_kc, sol_o, lanes="same_iters", **bars)
        compare_rho(name, res_k[4].cpu(), res_o[4],
                    sol_kc.iter == sol_o.iter)
    log(f"  {label}: lanes whose rho moved "
        f"{(res_k[4] != float(prob.cache.rho)).float().mean().item():.5f}, "
        f"mean iters {sol_k.iter.float().mean().item():.4f}, solved frac "
        f"{sol_k.solved.float().mean().item():.5f}")


def adaptive_phases(torch, tt, convert, admm_fused, counters, card,
                    peak_flops, peak_bw):
    """Phases 13-16: adaptive rho on the adaptive instantiation of
    csrc/admm_fused.cu. Returns the kernels-line numbers of the cold hard
    batch and of the warm external-plant sequence."""
    # 13. small batches against the plain version, on the card and the CPU
    phase(f"phase 13: adaptive kernel vs plain versions, B={ADAPT_SMALL_B}")
    t0 = time.perf_counter()
    prob5 = adaptive_problem(tt, torch, 5.0, N_HORIZON, ADAPT_ITER, 1)
    torch.cuda.synchronize()
    sens5_ms = 1e3 * (time.perf_counter() - t0)
    t5 = sensitivity_tables(prob5)
    t0 = time.perf_counter()
    prob85 = adaptive_problem(tt, torch, MISTUNED_RHO, N_HORIZON, ADAPT_ITER,
                              1)
    torch.cuda.synchronize()
    sens85_ms = 1e3 * (time.perf_counter() - t0)
    t85 = sensitivity_tables(prob85)
    # The same tables on the host, for the set-up cost of the round trip
    # a fixed-point step that the card pays.
    c = prob5.cache
    args = [a.cpu() for a in (prob5.A, prob5.B, prob5.f,
                                prob5.Qdiag - c.rho, prob5.Rdiag - c.rho,
                                c.rho)]
    t0 = time.perf_counter()
    t5_host = tt.riccati.compute_sensitivities(*args)
    host5_ms = 1e3 * (time.perf_counter() - t0)
    drift = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(t5, t5_host))
    log(f"  setup with compute_sensitivities on the card (set-up): rho 5 "
        f"{sens5_ms:.1f} ms, rho {MISTUNED_RHO} {sens85_ms:.1f} ms; "
        f"compute_sensitivities alone on the host, rho 5: {host5_ms:.1f} "
        f"ms, tables within {drift:.3e} (relative to each table's max) of "
        f"the card's")
    B = ADAPT_SMALL_B
    x0, Xref = inputs(torch, B)
    for label, rho, mi, tol, apply_c, tables in (
            ("adaptive rho_tol 1", 5.0, 100, 1.0, False, t5),
            ("adaptive rho_tol 3 rho0 85", MISTUNED_RHO, ADAPT_ITER, 3.0,
             False, t85),
            ("adaptive apply_c", 5.0, 100, 1.0, True, t5)):
        prob = adaptive_problem(tt, torch, rho, N_HORIZON, mi, 1, tol,
                                apply_c, tables)
        adaptive_small(torch, tt, convert, f"{label} cold B={B}", prob, x0,
                       Xref, B)
    # Warm: six solves of an external plant, rho riding the carry; each
    # step held on the lanes whose counts agree at every step so far:
    # against the plain version on the CPU at the default bar, on the card
    # at the plain version's own spread.
    prob = adaptive_problem(tt, torch, 5.0, SERVE_N, 100, 1, tables=t5)
    prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                        "cpu")
    x, Xref = inputs(torch, B, N=SERVE_N, spread=0.3)
    c_k, c_p, c_c = (tt.init_carry(prob, B), tt.init_carry(prob, B),
                     tt.init_carry(prob_c, B))
    agreed = {o: torch.ones(B, dtype=torch.bool)
              for o in ("plain(cpu)", "plain(gpu)")}
    for step in range(6):
        sol_k, res_k, c_k = tt.kernels.solve_fused_warm(prob, Xref, None, x,
                                                        c_k)
        sol_p, res_p, c_p = tt.kernels.solve_fused_warm_reference(
            prob, Xref, None, x, c_p)
        sol_c, res_c, c_c = tt.kernels.solve_fused_warm_reference(
            prob_c, Xref.cpu(), None, x.cpu(), c_c)
        torch.cuda.synchronize()
        name = f"adaptive warm B={B} step {step}"
        share_c, dsf_c, dval_c, _ = plain_spread(
            torch, sol_p, sol_c, agreed["plain(gpu)"], c_p, c_c)
        share, solved_tol, atol = spread_bars(name, share_c, dsf_c, dval_c,
                                              B)
        sol_kc, c_kc = on_cpu(sol_k), on_cpu(c_k)
        for other, sol_o, c_o, bars in (
                ("plain(cpu)", sol_c, c_c, {}),
                ("plain(gpu)", on_cpu(sol_p), on_cpu(c_p),
                 dict(atol=atol, solved_tol=solved_tol, share=share))):
            before = agreed[other].clone()
            agreed[other] &= sol_kc.iter == sol_o.iter
            compare(torch, f"{name} vs {other}", sol_kc, sol_o,
                    lanes=agreed[other], among=before, **bars)
            compare_carry(torch, f"{name} vs {other}", c_kc, c_o,
                          agreed[other], atol=bars.get("atol", BAR_ATOL))
            compare_rho(f"{name} vs {other}", c_kc.rho[0], c_o.rho[0],
                        agreed[other])
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f

    # 14. the adaptive hard batch at full width, and fixed rho beside it
    phase(f"phase 14: adaptive hard batch, B={ADAPT_B}, N={N_HORIZON}, "
          f"max_iter {ADAPT_ITER}, ct 1")
    x0, Xref = inputs(torch, ADAPT_B)
    zero_counts(counters)
    sol_k, res_k = tt.kernels.solve_fused(prob5, Xref, None, x0)
    torch.cuda.synchronize()
    launches = admm_fused.adaptive_launch_count
    if launches < 1:
        raise AssertionError("the adaptive hard batch did not launch the "
                             "adaptive kernel")
    if sol_k.x.shape != (N_HORIZON, ADAPT_B, 12) or \
            res_k.shape != (5, ADAPT_B):
        raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                             f"{res_k.shape}")
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: tt.kernels.solve_fused_reference(prob5, Xref, None,
                                                        x0))
    # Over 500 iterations the agreed lanes are held to 1e-3, the bar of
    # the cold max_iter 500 regime.
    err = compare(torch, "adaptive hard batch", sol_k, sol_p, res_k[:4],
                  res_p[:4], atol=1e-3, lanes="same_iters")
    compare_rho("adaptive hard batch", res_k[4], res_p[4],
                sol_k.iter == sol_p.iter)

    def time_cold(prob):
        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(tables, x0c, N_HORIZON, 12, 4,
                                               **params)
        sol = run()[0]                                  # warm-up
        ms, times = cuda_ms(torch, run, 5)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, None,
                                                          x0))[0]
            for _ in range(3))
        return sol, ms, times, call_ms

    sol_t, ms, times, call_ms = time_cold(prob5)
    ops, nbytes = adaptive_work(N_HORIZON, 12, 4, ADAPT_B, sol_t.iter, False)
    bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    mean_it = sol_k.iter.float().mean().item()
    log(f"  adaptive hard batch: kernel {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), solve_fused call {call_ms:.4f} ms "
        f"on the host clock (kernel share {ms / call_ms:.4f}), "
        f"{ADAPT_B / (ms / 1e3):.1f} solves/s, solved frac "
        f"{sol_k.solved.float().mean().item():.5f}, mean iters "
        f"{mean_it:.4f} ({ms / mean_it:.5f} ms per mean iteration), "
        f"adaptations {adaptations(sol_k.iter)}, final rho quartiles "
        f"{[round(q, 4) for q in quartiles(res_k[4])]}, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.1f} ms, launches "
        f"{launches}; card {card}")
    fixed = tt.with_settings(prob5, adaptive_rho=False)
    sol_f, ms_f, times_f, call_f = time_cold(fixed)
    mean_f = sol_f.iter.float().mean().item()
    log(f"  fixed rho, same inputs: kernel {ms_f:.4f} ms (reps "
        f"{[round(t, 4) for t in times_f]}), call {call_f:.4f} ms, solved "
        f"frac {sol_f.solved.float().mean().item():.5f}, mean iters "
        f"{mean_f:.4f} ({ms_f / mean_f:.5f} ms per mean iteration); "
        f"adaptive / fixed time {ms / ms_f:.4f}, per mean iteration "
        f"{(ms / mean_it) / (ms_f / mean_f):.4f}")
    rows = {"adaptive": dict(launches=launches, err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)}

    # 15. mis-tuned rho0: fixed, adaptive, guarded, at bench_all.py's 85
    # and at DETUNED_RHO, where the adaptation must solve more lanes than
    # fixed rho does
    phase(f"phase 15: mis-tuned rho0 {MISTUNED_RHO} and {DETUNED_RHO}, "
          f"B={ADAPT_B}: fixed / adaptive / guarded tol 3")
    t0 = time.perf_counter()
    prob_d = adaptive_problem(tt, torch, DETUNED_RHO, N_HORIZON, ADAPT_ITER, 1)
    torch.cuda.synchronize()
    log(f"  setup with compute_sensitivities at rho {DETUNED_RHO} "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms (set-up)")
    for rho0, base in ((MISTUNED_RHO, prob85), (DETUNED_RHO, prob_d)):
        fractions = {}
        for label, ad, tol in (("fixed rho", False, 1.0),
                               ("adaptive rho", True, 1.0),
                               ("adaptive guarded tol=3", True, 3.0)):
            name = f"rho0 {rho0:g} {label}"
            prob = tt.with_settings(base, adaptive_rho=ad,
                                    adaptive_rho_tolerance=tol)
            sol, res = tt.kernels.solve_fused(prob, Xref, None, x0)
            if ad:
                sol_p, res_p = tt.kernels.solve_fused_reference(
                    prob, Xref, None, x0)
                compare(torch, name, sol, sol_p, res[:4], res_p[:4],
                        atol=1e-3, lanes="same_iters")
                compare_rho(name, res[4], res_p[4], sol.iter == sol_p.iter)
            _, ms_m, _, _ = time_cold(prob)
            fractions[label] = sol.solved.float().mean().item()
            log(f"  {name}: solved frac {fractions[label]:.5f}, mean iters "
                f"{sol.iter.float().mean().item():.4f}, kernel {ms_m:.4f} "
                f"ms, {ADAPT_B / (ms_m / 1e3):.1f} solves/s"
                + (f", final rho quartiles "
                   f"{[round(q, 4) for q in quartiles(res[4])]}" if ad
                   else "") + f"; card {card}")
        if rho0 == DETUNED_RHO:
            for label in ("adaptive rho", "adaptive guarded tol=3"):
                fail(f"rho0 {rho0:g} {label}",
                     fractions[label] > fractions["fixed rho"],
                     f"solves {fractions[label]:.5f} of lanes, fixed rho "
                     f"{fractions['fixed rho']:.5f}: the adaptation does "
                     "not help")

    # 16. adaptive external-plant sequence (phase 8's set-up)
    phase(f"phase 16: adaptive external-plant sequence, B={SERVE_B}, 5 warm "
          f"solves")
    prob = adaptive_problem(tt, torch, 5.0, SERVE_N, 100, 1, tables=t5)
    rng = np.random.default_rng(0)
    hover = torch.as_tensor(HOVER, dtype=torch.float32, device=DEVICE)
    Xref = hover.expand(SERVE_N, 12).contiguous()
    x = hover + torch.as_tensor(rng.uniform(-0.3, 0.3, (SERVE_B, 12)),
                                dtype=torch.float32, device=DEVICE)
    c_k = tt.init_carry(prob, SERVE_B)
    zero_counts(counters)
    states, sols, carries = [], [], []
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol_k)
        carries.append(c_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    warm_launches = admm_fused.adaptive_warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the adaptive sequence did not launch the warm "
                             "adaptive kernel")
    c_p = tt.init_carry(prob, SERVE_B)
    agreed = torch.ones(SERVE_B, dtype=torch.bool, device=DEVICE)
    err_w = 0.0
    for step, (x_s, sol_k, c_ks) in enumerate(zip(states, sols, carries)):
        plain_w_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_w = max(err_w, compare(torch, f"adaptive warm step {step}",
                                   sol_k, sol_p, lanes=agreed,
                                   solved_tol=2 / SERVE_B))
        compare_rho(f"adaptive warm step {step}", c_ks.rho[0], c_p.rho[0],
                    agreed)
        log(f"  step {step}: mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}")
    compare_carry(torch, "adaptive after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, None, x)
    carry = admm_fused._carry_tensors(prob, c_k, SERVE_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, SERVE_N,
                                                12, 4, **params)
    sol_w = run()[0]                                    # warm-up
    w_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(prob, Xref, None,
                                                           x, c_k))[0]
        for _ in range(REPS))
    ops, nbytes = adaptive_work(SERVE_N, 12, 4, SERVE_B, sol_w.iter, False,
                                lane_carry_floats(c_k))
    w_bound_ms, w_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  adaptive solve_fused_warm (the sixth solve): kernel {w_ms:.4f} "
        f"ms (reps {[round(t, 4) for t in times]}), whole call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{w_ms / call_ms:.4f}), plain {plain_w_ms:.1f} ms, bound "
        f"{w_bound_ms:.4f} ms ({w_bound_by}), mean iters "
        f"{sol_w.iter.float().mean().item():.4f}, "
        f"{SERVE_B / (w_ms / 1e3):.1f} solves/s, adaptive warm launches "
        f"{warm_launches}; card {card}")
    rows["adaptive_warm"] = dict(launches=warm_launches, err=err_w, ms=w_ms,
                                 plain_ms=plain_w_ms, bound_ms=w_bound_ms,
                                 bound_by=w_bound_by)
    return rows


def zero_counts(kernels):
    for mod, attr in kernels:
        setattr(mod, attr, 0)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch import convert
    from tinympc_tpu_torch.kernels import _build, admm_fused, \
        closed_loop_kernel
    counters = ((admm_fused, "launch_count"),
                (admm_fused, "warm_launch_count"),
                (admm_fused, "families_launch_count"),
                (admm_fused, "families_warm_launch_count"),
                (closed_loop_kernel, "launch_count"),
                (admm_fused, "adaptive_launch_count"),
                (admm_fused, "adaptive_warm_launch_count"))

    # 1. card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")

    # 2. build: both sources, one nvcc each, started together
    t0 = time.perf_counter()
    logs = _build.build([admm_fused.KERNEL, closed_loop_kernel.KERNEL])
    admm_fused._kernel_fn()
    closed_loop_kernel._kernel_fn()
    log(f"build: {time.perf_counter() - t0:.1f} s (set-up), "
        f"{len(logs)} sources compiled")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "entry function" in line \
                    or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
        for fn, e in sorted(ptxas_entries(text).items(),
                            key=lambda kv: kernel_label(kv[0])):
            label = kernel_label(fn)
            log(f"  ptxas summary: {label}: {e.get('regs')} registers, "
                f"{e.get('stack')} bytes stack frame (local memory), "
                f"{e.get('spill_st')} / {e.get('spill_ld')} bytes spill "
                f"stores / loads")
            if "families" in label:
                fail(f"ptxas {label}", e.get("stack") == 0
                     and e.get("spill_st") == 0 and e.get("spill_ld") == 0,
                     "the families kernel spills or uses local memory")

    bad = check_rounding(torch, _build.load(admm_fused.KERNEL))
    log(f"rounding: div_rn and sqrt_rn against IEEE division and square "
        f"root on {1 << 24} random float pairs: {bad} results differ")
    fail("rounding", bad == 0, f"{bad} results differ from IEEE's")

    # 3. cold kernel against plain version, small; and against admm.solve
    phase("phase 3: cold kernel vs plain version, small batches")
    for B in (1000, 1024):
        for ct in (25, 1):
            prob = problem(tt, torch, 100, ct)
            x0, Xref = inputs(torch, B)
            sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
            sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref,
                                                            None, x0)
            torch.cuda.synchronize()
            compare(torch, f"ct={ct}", sol_k, sol_p, res_k, res_p)
    prob = problem(tt, torch, 100, 5)
    x0, Xref = inputs(torch, 256)
    sol_k, _ = tt.kernels.solve_fused(prob, Xref, None, x0)
    sol_s, _, _ = tt.solve(prob, tt.init_state(prob, (256,)), Xref, None, x0)
    torch.cuda.synchronize()
    compare(torch, "kernel vs admm.solve ct=5", sol_k, sol_s)

    # 4. cold main path at full width
    phase(f"phase 4: cold main path, B={BATCH}")
    x0, Xref = inputs(torch, BATCH)
    regimes = {}
    # The main path is held to the bar on every lane. The other two
    # regimes hold the lanes whose iteration counts agree: to 1e-3 over
    # max_iter 500 (float32 rounding differences grow with the iterations)
    # and to the bar at check_termination 1.
    for mi, ct, atol, lanes in ((100, 25, BAR_ATOL, "all"),
                                (500, 25, 1e-3, "same_iters"),
                                (100, 1, BAR_ATOL, "same_iters")):
        t0 = time.perf_counter()
        prob = problem(tt, torch, mi, ct)
        setup_ms = 1e3 * (time.perf_counter() - t0)
        zero_counts(counters)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
        torch.cuda.synchronize()
        launches = admm_fused.launch_count
        if launches < 1:
            raise AssertionError("the main path did not launch the kernel")
        if sol_k.x.shape != (N_HORIZON, BATCH, 12) or \
                sol_k.u.shape != (N_HORIZON - 1, BATCH, 4):
            raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                                 f"{sol_k.u.shape}")
        plain_ms, (sol_p, res_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_reference(prob, Xref, None,
                                                            x0))
        err = compare(torch, f"max_iter={mi} ct={ct}", sol_k, sol_p, res_k,
                      res_p, atol, lanes)

        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(
            tables, x0c, N_HORIZON, 12, 4, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        # The whole entry-point call on the host clock (table packing,
        # allocation, launch, wait): how much of it the device is busy.
        e2e_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, None,
                                                          x0))[0]
            for _ in range(REPS))
        iter_sum = int(sol_k.iter.sum().item())
        ops, nbytes = fused_work(N_HORIZON, 12, 4, BATCH, iter_sum)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        avg_it = iter_sum / BATCH
        solved = sol_k.solved.float().mean().item()
        log(f"  max_iter={mi} ct={ct}: kernel {ms:.4f} ms "
            f"(reps {[round(t, 4) for t in times]}), plain {plain_ms:.1f} ms, "
            f"bound {bound_ms:.4f} ms ({ops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {BATCH / (ms / 1e3):.1f} solves/s, "
            f"avg iters {avg_it:.4f}, solved frac {solved:.5f}, "
            f"launches {launches}; setup {setup_ms:.1f} ms, solve_fused "
            f"call {e2e_ms:.4f} ms (kernel share {ms / e2e_ms:.4f}); "
            f"card {card}")
        regimes[(mi, ct)] = dict(launches=launches, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)

    # 5. warm kernel against plain version, small external-plant sequences
    phase("phase 5: warm kernel vs plain version, B=1000, 6 warm solves")
    for ct in (1, 5):
        prob = problem(tt, torch, 100, ct, N=SERVE_N)
        x, Xref = inputs(torch, 1000, N=SERVE_N, spread=0.3)
        c_k, c_p = tt.init_carry(prob, 1000), tt.init_carry(prob, 1000)
        agreed = torch.ones(1000, dtype=torch.bool, device=DEVICE)
        for step in range(6):
            sol_k, res_k, c_k = tt.kernels.solve_fused_warm(prob, Xref, None,
                                                            x, c_k)
            sol_p, res_p, c_p = tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x, c_p)
            torch.cuda.synchronize()
            agreed &= sol_k.iter == sol_p.iter
            label = f"ct={ct} step {step}"
            compare(torch, label, sol_k, sol_p, lanes=agreed)
            compare_carry(torch, label, c_k, c_p, agreed)
            x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f

    # 6. closed-loop kernel against plain version, small
    phase("phase 6: closed-loop kernel vs plain version, B=1000, T=20")
    T6 = 20
    # The last two loops slide the window along a reference that climbs
    # 0.01 m a step in y (0.2 m/s at 20 Hz).
    moving = torch.as_tensor(
        [[0, 0.01 * k, 1.0] + [0.0] * 9 for k in range(T6 + SERVE_N - 1)],
        dtype=torch.float32, device=DEVICE)
    for ct, reset, shift, move, label in (
            (5, False, False, False, "ct=5"),
            (1, True, False, False, "ct=1 reset_duals"),
            (5, False, True, False, "ct=5 shift_warm"),
            (5, True, False, True, "ct=5 reset_duals, moving reference"),
            (1, True, False, True, "ct=1 reset_duals, moving reference")):
        prob = problem(tt, torch, 100, ct, N=SERVE_N)
        x0, Xref = inputs(torch, 1000, N=SERVE_N, spread=0.3)
        xref = moving if move else Xref
        opts = dict(reset_duals=reset, shift_warm=shift)
        out_k = tt.kernels.closed_loop_fused(prob, xref, x0, T6, **opts)
        out_p = tt.kernels.closed_loop_fused_reference(prob, xref, x0, T6,
                                                       **opts)
        torch.cuda.synchronize()
        share = BAR_ITER_SHARE
        if ct == 1 and move:
            share = rounding_floor(torch, tt, label, 100, ct, xref, x0, T6,
                                   opts, out_k, out_p)
        compare_loop(torch, label, out_k, out_p, share)

    # 7. serving path at full width, then the max_iter 500 regimes
    phase(f"phase 7: serving closed loop, B={SERVE_B}, T={SERVE_T}, "
        f"N={SERVE_N}")
    x0, Xref = inputs(torch, SERVE_B, N=SERVE_N, spread=0.3)
    loops = {}
    for mi, shift, reps in ((100, False, REPS), (500, False, 3),
                            (500, True, 3)):
        prob = problem(tt, torch, mi, 5, N=SERVE_N)
        label = f"max_iter={mi} ct=5 shift_warm={shift}"
        zero_counts(counters)
        out_k = tt.kernels.closed_loop_fused(prob, Xref, x0, SERVE_T,
                                             shift_warm=shift)
        torch.cuda.synchronize()
        launches = closed_loop_kernel.launch_count
        if launches < 1:
            raise AssertionError("the serving path did not launch the "
                                 "closed-loop kernel")
        if out_k[0].shape != (SERVE_T, SERVE_B, 12) or \
                out_k[1].shape != (SERVE_T, SERVE_B, 4):
            raise AssertionError(f"bad output shapes {out_k[0].shape} "
                                 f"{out_k[1].shape}")
        plain_ms, out_p = host_ms(
            torch, lambda: tt.kernels.closed_loop_fused_reference(
                prob, Xref, x0, SERVE_T, shift_warm=shift))
        err = compare_loop(torch, label, out_k, out_p)
        args = closed_loop_kernel._prepare_loop(prob, Xref, x0, SERVE_T,
                                                None)
        tables, xtot, x0c, T, params = args
        run = lambda: closed_loop_kernel._loop_kernel(
            tables, xtot, x0c, T, SERVE_N, 12, 4, reset_duals=False,
            shift_warm=shift, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, reps)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.closed_loop_fused(
                prob, Xref, x0, SERVE_T, shift_warm=shift))[0]
            for _ in range(reps))
        iters = out_k[2]
        iter_sum = int(iters.sum().item())
        ops, nbytes = loop_work(SERVE_N, 12, 4, SERVE_B, SERVE_T, iter_sum)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        log(f"  {label}: kernel {ms:.4f} ms (reps "
            f"{[round(t, 4) for t in times]}), "
            f"{SERVE_B * SERVE_T / (ms / 1e3):.1f} MPC steps/s, mean iters "
            f"per step {iter_sum / (SERVE_B * SERVE_T):.4f}, solved frac "
            f"{out_k[3].float().mean().item():.5f}, bound {bound_ms:.4f} ms "
            f"({bound_by}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"plain {plain_ms:.1f} ms, closed_loop_fused call {call_ms:.4f} "
            f"ms (kernel share {ms / call_ms:.4f}), launches {launches}; "
            f"card {card}")
        loops[(mi, shift)] = dict(launches=launches, err=err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)

    # 8. the external-plant loop of examples/serving_fleet.py:62-77
    phase(f"phase 8: external-plant loop, B={SERVE_B}, 5 warm solves")
    # check_termination 1, as serving_fleet.py leaves it.
    prob = problem(tt, torch, 100, 1, N=SERVE_N)
    rng = np.random.default_rng(0)
    hover = torch.as_tensor(HOVER, dtype=torch.float32, device=DEVICE)
    Xref = hover.expand(SERVE_N, 12).contiguous()
    x = hover + torch.as_tensor(rng.uniform(-0.3, 0.3, (SERVE_B, 12)),
                                dtype=torch.float32, device=DEVICE)
    c_k = tt.init_carry(prob, SERVE_B)
    zero_counts(counters)
    states, sols = [], []
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol_k)
        u0 = sol_k.u[0] + 0.01 * torch.as_tensor(
            rng.normal(size=(SERVE_B, 4)), dtype=torch.float32,
            device=DEVICE)
        x = x @ prob.A.T + u0 @ prob.B.T + prob.f
    torch.cuda.synchronize()
    warm_launches = admm_fused.warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the external-plant loop did not launch the "
                             "warm kernel")
    # The plain version on the same plant states, with its own carry.
    c_p = tt.init_carry(prob, SERVE_B)
    agreed = torch.ones(SERVE_B, dtype=torch.bool, device=DEVICE)
    err_warm = 0.0
    for step, (x_s, sol_k) in enumerate(zip(states, sols)):
        plain_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_warm = max(err_warm, compare(torch, f"step {step}", sol_k,
                                         sol_p, lanes=agreed,
                                         solved_tol=2 / SERVE_B))
        log(f"  step {step}: mean iters {sol_k.iter.float().mean().item():.4f}"
            f", mean pos err "
            f"{(x_s[:, :3] - hover[:3]).norm(dim=-1).mean().item():.6f}")
    compare_carry(torch, "after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, None, x)
    carry = admm_fused._carry_tensors(prob, c_k, SERVE_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, SERVE_N,
                                                12, 4, **params)
    sol_w = run()[0]                                    # warm-up
    warm_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(prob, Xref, None,
                                                           x, c_k))[0]
        for _ in range(REPS))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(SERVE_N, 12, 4, SERVE_B, iter_sum,
                             lane_carry_floats(c_k))
    warm_bound_ms, warm_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  solve_fused_warm: kernel {warm_ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), whole call {call_ms:.4f} ms on "
        f"the host clock (kernel share {warm_ms / call_ms:.4f}), plain "
        f"{plain_ms:.1f} ms, bound {warm_bound_ms:.4f} ms ({warm_bound_by}; "
        f"mean iters {iter_sum / SERVE_B:.4f}), "
        f"{SERVE_B / (warm_ms / 1e3):.1f} solves/s, launches "
        f"{warm_launches}; card {card}")

    # 9. families kernels against their plain versions, small
    phase(f"phase 9: families kernels vs plain versions, B={FAM_SMALL_B}")
    # The quadrotor's ceilings sit low enough here that the state planes
    # bite on part of the lanes while most still converge.
    B = FAM_SMALL_B
    small = []
    for ct in (1, 5):
        small += [("rocket SOC", ct,
                   lambda mi, ct, dt=None: rocket_problem(
                       tt, torch, mi, ct, dtype=dt), rocket_inputs)]
        kind = "linear" if ct == 1 else "tv"
        small += [(f"quadrotor {kind}", ct,
                   lambda mi, ct, dt=None, k=kind: quad_plane_problem(
                       tt, torch, k == "tv", mi, ct, LOW_CEILING[k],
                       dtype=dt), quad_plane_inputs)]
    cpu = lambda a: None if a is None else a.cpu()
    everyone = torch.ones(B, dtype=torch.bool)
    for label, ct, make, make_inputs in small:
        prob = make(100, ct)
        # The same problem arrays on the CPU, for the plain version there.
        prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                            "cpu")
        x0, Xref, Uref = make_inputs(torch, B)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, Uref, x0)
        sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, Uref, x0)
        sol_c, _ = tt.kernels.solve_fused_reference(prob_c, cpu(Xref),
                                                    cpu(Uref), cpu(x0))
        torch.cuda.synchronize()
        name = f"{label} cold B={B} ct={ct}"
        # The bar against the plain version on the CPU, on the lanes
        # whose counts agree; against the plain version on the card
        # (cuBLAS's summation order), the bar of its own spread from the
        # CPU.
        compare(torch, f"{name} vs plain(cpu)", on_cpu(sol_k), sol_c,
                lanes="same_iters")
        share, solved_tol, atol = spread_bars(
            name, *plain_spread(torch, sol_p, sol_c, everyone)[:3], B)
        compare(torch, name, sol_k, sol_p, res_k, res_p, atol=atol,
                lanes="same_iters", solved_tol=solved_tol, share=share)
        # Float64 witness: the kernel agrees with admm.solve in float64 on
        # as many counts as the plain version does, less WITNESS_SLACK.
        prob64 = make(100, ct, torch.float64)
        f64 = lambda a: None if a is None else a.double()
        it_64 = tt.solve(prob64, tt.init_state(prob64, (B,)), f64(Xref),
                         f64(Uref), f64(x0))[0].iter
        s_k64 = (sol_k.iter == it_64).float().mean().item()
        s_p64 = (sol_p.iter == it_64).float().mean().item()
        log(f"  {name}: identical counts with admm.solve float64: kernel "
            f"{s_k64:.5f}, plain {s_p64:.5f}")
        fail(name, s_k64 >= s_p64 - WITNESS_SLACK, f"kernel agrees with "
             f"the float64 solve on {s_k64:.4f} of counts, the plain "
             f"version on {s_p64:.4f}")
        # Warm: an external-plant sequence of 4 solves, the plant stepped
        # with the kernel's u0; each step held on the lanes that agree at
        # every step so far: to the bar against the plain version on
        # the CPU, and to the plain version's own spread on the card.
        c_k, c_p = tt.init_carry(prob, B), tt.init_carry(prob, B)
        c_c = tt.init_carry(prob_c, B)
        agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
        agreed_c, agreed_kc = everyone, everyone.clone()
        x = x0
        for step in range(4):
            sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, Uref, x,
                                                        c_k)
            sol_p, _, c_p = tt.kernels.solve_fused_warm_reference(
                prob, Xref, Uref, x, c_p)
            sol_c, _, c_c = tt.kernels.solve_fused_warm_reference(
                prob_c, cpu(Xref), cpu(Uref), cpu(x), c_c)
            torch.cuda.synchronize()
            name = f"{label} warm B={B} ct={ct} step {step}"
            before = agreed_kc.clone()
            sol_kc, c_kc = on_cpu(sol_k), on_cpu(c_k)
            agreed_kc &= sol_kc.iter == sol_c.iter
            compare(torch, f"{name} vs plain(cpu)", sol_kc, sol_c,
                    lanes=agreed_kc, among=before)
            compare_carry(torch, f"{name} vs plain(cpu)", c_kc, c_c,
                          agreed_kc)
            share_c, dsf_c, dval_c, held_c = plain_spread(
                torch, sol_p, sol_c, agreed_c, c_p, c_c)
            share, solved_tol, atol = spread_bars(name, share_c, dsf_c,
                                                  dval_c, B)
            before = agreed.clone()
            agreed &= sol_k.iter == sol_p.iter
            agreed_c = held_c
            compare(torch, name, sol_k, sol_p, atol=atol, lanes=agreed,
                    solved_tol=solved_tol, share=share, among=before)
            compare_carry(torch, name, c_k, c_p, agreed, atol=atol)
            x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f

    def time_cold(prob, Xref, Uref, x0, sol_k):
        """Kernel ms (CUDA events, median of REPS), the solve_fused call on
        the host clock, and the bound of this run's work."""
        tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x0)
        spec = prob.spec
        run = lambda: admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx,
                                               spec.nu, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, Uref,
                                                          x0))[0]
            for _ in range(REPS))
        iter_sum = int(sol_k.iter.sum().item())
        ops, nbytes = fused_work(spec.N, spec.nx, spec.nu, x0.shape[0],
                                 iter_sum, spec=spec)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        return ms, times, call_ms, bound_ms, bound_by, ops, nbytes

    def full_width_cold(label, prob, Xref, Uref, x0):
        """Drive a families cold batch through kernels.solve_fused with the
        counts at 0, check it, hold it against the plain version and time
        it. Returns the kernels-line numbers."""
        spec = prob.spec
        zero_counts(counters)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, Uref, x0)
        torch.cuda.synchronize()
        launches = admm_fused.families_launch_count
        if launches < 1:
            raise AssertionError(f"{label} did not launch the families "
                                 "kernel")
        B = x0.shape[0]
        if sol_k.x.shape != (spec.N, B, spec.nx) or \
                sol_k.u.shape != (spec.N - 1, B, spec.nu):
            raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                                 f"{sol_k.u.shape}")
        plain_ms, (sol_p, res_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_reference(prob, Xref, Uref,
                                                            x0))
        err = compare(torch, label, sol_k, sol_p, res_k, res_p)
        ms, times, call_ms, bound_ms, bound_by, ops, nbytes = time_cold(
            prob, Xref, Uref, x0, sol_k)
        iters = sol_k.iter.float()
        log(f"  {label}: families launches {launches}, kernel {ms:.4f} ms "
            f"(reps {[round(t, 4) for t in times]}), solve_fused call "
            f"{call_ms:.4f} ms on the host clock (kernel share "
            f"{ms / call_ms:.4f}), {B / (ms / 1e3):.1f} solves/s, mean "
            f"iters {iters.mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.1f} ms; card {card}")
        return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    # 10. rocket SOC cold batch at full width
    phase(f"phase 10: rocket SOC cold batch, B={FAM_B}, N={FAM_N}")
    t0 = time.perf_counter()
    prob = rocket_problem(tt, torch, 100, 1)
    setup_ms = 1e3 * (time.perf_counter() - t0)
    log(f"  setup -> with_bounds -> with_cones -> with_settings "
        f"{setup_ms:.1f} ms (set-up)")
    x0, Xref, Uref = rocket_inputs(torch, FAM_B)
    fam_rows = {"soc": full_width_cold("rocket SOC cold ct=1", prob, Xref,
                                       Uref, x0)}

    # 11. rocket SOC external-plant sequence, 5 warm solves
    phase(f"phase 11: rocket SOC external-plant sequence, B={FAM_B}, 5 warm "
        f"solves")
    c_k = tt.init_carry(prob, FAM_B)
    zero_counts(counters)
    states, sols = [], []
    x = x0
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, Uref, x, c_k)
        states.append(x)
        sols.append(sol_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    fam_warm_launches = admm_fused.families_warm_launch_count
    if fam_warm_launches < 5:
        raise AssertionError("the rocket SOC sequence did not launch the "
                             "warm families kernel")
    c_p = tt.init_carry(prob, FAM_B)
    agreed = torch.ones(FAM_B, dtype=torch.bool, device=DEVICE)
    err_fw = 0.0
    for step, (x_s, sol_k) in enumerate(zip(states, sols)):
        plain_fw_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, Uref, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_fw = max(err_fw, compare(torch, f"rocket SOC warm step {step}",
                                     sol_k, sol_p, lanes=agreed))
        log(f"  step {step}: mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}, mean altitude "
            f"{x_s[:, 2].mean().item():.4f}")
    compare_carry(torch, "rocket SOC after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, Uref, x)
    carry = admm_fused._carry_tensors(prob, c_k, FAM_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, FAM_N, 6,
                                                3, **params)
    sol_w = run()[0]                                    # warm-up
    fw_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(
            prob, Xref, Uref, x, c_k))[0] for _ in range(REPS))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(FAM_N, 6, 3, FAM_B, iter_sum,
                             lane_carry_floats(c_k), prob.spec)
    fw_bound_ms, fw_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  rocket SOC solve_fused_warm (the sixth solve): kernel "
        f"{fw_ms:.4f} ms (reps {[round(t, 4) for t in times]}), whole call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{fw_ms / call_ms:.4f}), plain {plain_fw_ms:.1f} ms, bound "
        f"{fw_bound_ms:.4f} ms ({fw_bound_by}; {nbytes / 1e6:.2f} MB), mean "
        f"iters {iter_sum / FAM_B:.4f}, solved frac "
        f"{sol_w.solved.float().mean().item():.5f}, "
        f"{FAM_B / (fw_ms / 1e3):.1f} solves/s, families warm launches "
        f"{fam_warm_launches}; card {card}")
    fam_rows["soc_warm"] = dict(launches=fam_warm_launches, err=err_fw,
                                ms=fw_ms, plain_ms=plain_fw_ms,
                                bound_ms=fw_bound_ms, bound_by=fw_bound_by)

    # 12. the hyperplane demos as cold batches at full width
    phase(f"phase 12: hyperplane demos, cold, B={FAM_B}, N={FAM_N}")
    x0, Xref, _ = quad_plane_inputs(torch, FAM_B)
    for kind in ("linear", "tv"):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1)
        fam_rows[kind] = full_width_cold(f"quadrotor {kind} cold ct=1", prob,
                                         Xref, None, x0)
    # The demos' ceilings do not bind at step 0; under phase 9's low
    # ceilings the state planes bite, held here to the bar at full width.
    for kind in ("linear", "tv"):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1,
                                  LOW_CEILING[kind])
        full_width_cold(f"quadrotor {kind} low ceilings cold ct=1", prob,
                        Xref, None, x0)
        # How many lanes the z ceiling binds on: a non-zero dual of the
        # state plane after a solve from a zero carry.
        c = tt.kernels.solve_fused_warm(prob, Xref, None, x0,
                                        tt.init_carry(prob, FAM_B))[2]
        dual = c.gl if kind == "linear" else c.gtv
        log(f"  quadrotor {kind} low ceilings: the z ceiling binds on "
            f"{(dual[:, 2].abs().amax(dim=0) > 0).float().mean().item():.5f}"
            f" of lanes")

    adapt_rows = adaptive_phases(torch, tt, convert, admm_fused, counters,
                                 card, peak_flops, peak_bw)

    if FAILURES:
        phase(f"{len(FAILURES)} comparison(s) missed their bar:")
        for f in FAILURES:
            log(f"  {f}")
        return 1

    # 17. kernels line, then the device line last
    phase("phase 17: kernels line")
    main_run, serve = regimes[(100, 25)], loops[(100, False)]
    rows = [("admm_fused", "tinympc_tpu_torch/csrc/admm_fused.cu",
             "tinympc_tpu/kernels/admm_pallas.py:387", main_run),
            ("admm_fused_warm", "tinympc_tpu_torch/csrc/admm_fused.cu",
             "tinympc_tpu/kernels/admm_pallas.py:387",
             dict(launches=warm_launches, err=err_warm, ms=warm_ms,
                  plain_ms=plain_ms, bound_ms=warm_bound_ms,
                  bound_by=warm_bound_by)),
            ("closed_loop_fused",
             "tinympc_tpu_torch/csrc/closed_loop_fused.cu",
             "tinympc_tpu/kernels/closed_loop_pallas.py:63", serve)]
    rows += [(f"admm_fused_families_{key}",
              "tinympc_tpu_torch/csrc/admm_fused.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", fam_rows[key])
             for key in ("soc", "soc_warm", "linear", "tv")]
    rows += [(f"admm_fused_{key}", "tinympc_tpu_torch/csrc/admm_fused.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", adapt_rows[key])
             for key in ("adaptive", "adaptive_warm")]
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda", "source": src, "replaces": rep,
        "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for kname, src, rep, r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
