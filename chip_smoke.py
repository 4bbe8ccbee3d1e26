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
  actuator noise from the seeded generator.

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
9. the kernels line, then the device line last.

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
holds its agreed lanes to 1e-3 (PR 1's bar). A closed loop at
check_termination 1 on a moving reference puts many (step, lane) counts
on a float32 tie, so two summation orders disagree on more than 1% of
them whichever two they are: there the count bar is the plain version's
own agreement between the GPU and the CPU (another order for every
product) less 0.005, where that is below 99%, and the kernel must be as
close as the plain version to the port's closed_loop in float64, to
0.005. Exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
import json
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

# Published dense peaks (NVIDIA data sheets): FP32 on the CUDA cores, and
# device-memory bandwidth. The SXM part is the default.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12))


def log(msg):
    print(msg, flush=True)


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


def fail(label, ok, msg):
    """Record a missed bar (printed now, failing the run at its end)."""
    if not ok:
        FAILURES.append(f"{label}: {msg}")
        log(f"  FAIL {label}: {msg}")


def compare(torch, label, sol_k, sol_p, res_k=None, res_p=None,
            atol=BAR_ATOL, lanes="all", solved_tol=0.0):
    """Kernel against plain version. ``lanes="all"`` holds every lane to
    ``atol`` (the bar); ``lanes="same_iters"`` holds only the lanes whose
    iteration counts agree, for the long regimes where a lane that crosses
    the tolerance one check earlier on one side ends on another iterate; a
    bool tensor names the lanes held. Solved fractions must be identical,
    or within ``solved_tol``. Returns the max abs difference over x and u
    of the lanes held."""
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
    same_iter = same.float().mean().item()
    sf_k = sol_k.solved.float().mean().item()
    sf_p = sol_p.solved.float().mean().item()
    finite = bool(torch.isfinite(sol_k.x).all() and torch.isfinite(sol_k.u)
                  .all())
    dres = None if res_k is None else (res_k - res_p).abs().max().item()
    log(f"  {label}: B={B} lanes held={lanes} "
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
    fail(label, same_iter >= BAR_ITER_SHARE, f"only {same_iter:.4f} of "
         "lanes have identical iteration counts")
    return max(dx, du)


def compare_carry(torch, label, c_k, c_p, held, atol=BAR_ATOL):
    """The warm carries' vnew, v, g and y (lane-last) on the held lanes."""
    errs = {}
    for name in ("vnew", "v", "g", "y"):
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


def fused_work(N, nx, nu, B, iter_sum, carry=False):
    """Operations and bytes a fused solve needs for this run: the run's
    summed iteration count times :func:`iteration_ops`; bytes are x0 read
    once and x, u, iterations, solved flags and residuals written once,
    plus the warm carry read and written once."""
    ops = float(iter_sum) * iteration_ops(N, nx, nu)
    nbytes = 4 * B * nx + 4 * B * (N * nx + (N - 1) * nu) + B * (4 + 1 + 16)
    if carry:
        nbytes += 2 * 4 * B * 3 * (N * nx + (N - 1) * nu)
    return ops, nbytes


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


def zero_counts(kernels):
    for mod, attr in kernels:
        setattr(mod, attr, 0)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import _build, admm_fused, \
        closed_loop_kernel
    counters = ((admm_fused, "launch_count"),
                (admm_fused, "warm_launch_count"),
                (closed_loop_kernel, "launch_count"))

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
    admm_fused._kernel_fns()
    closed_loop_kernel._kernel_fn()
    log(f"build: {time.perf_counter() - t0:.1f} s (set-up), "
        f"{len(logs)} sources compiled")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "entry function" in line \
                    or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    # 3. cold kernel against plain version, small; and against admm.solve
    log("phase 3: cold kernel vs plain version, small batches")
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
    log(f"phase 4: cold main path, B={BATCH}")
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
    log("phase 5: warm kernel vs plain version, B=1000, 6 warm solves")
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
    log("phase 6: closed-loop kernel vs plain version, B=1000, T=20")
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
    log(f"phase 7: serving closed loop, B={SERVE_B}, T={SERVE_T}, "
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
    log(f"phase 8: external-plant loop, B={SERVE_B}, 5 warm solves")
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
    ops, nbytes = fused_work(SERVE_N, 12, 4, SERVE_B, iter_sum, carry=True)
    warm_bound_ms, warm_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  solve_fused_warm: kernel {warm_ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), whole call {call_ms:.4f} ms on "
        f"the host clock (kernel share {warm_ms / call_ms:.4f}), plain "
        f"{plain_ms:.1f} ms, bound {warm_bound_ms:.4f} ms ({warm_bound_by}; "
        f"mean iters {iter_sum / SERVE_B:.4f}), "
        f"{SERVE_B / (warm_ms / 1e3):.1f} solves/s, launches "
        f"{warm_launches}; card {card}")

    if FAILURES:
        log(f"{len(FAILURES)} comparison(s) missed their bar:")
        for f in FAILURES:
            log(f"  {f}")
        return 1

    # 9. kernels line, then the device line last
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
