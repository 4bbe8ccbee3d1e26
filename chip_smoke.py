#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- the headline workload of bench.py:build():
Crazyflie quadrotor at 20 Hz (nx=12, nu=4), horizon N=20, box bounds +-5 on
x and +-0.5 on u, hover reference, cold start, fixed rho, B=32768 problems
with x0 ~ U[-0.5, 0.5]^12 from numpy's default_rng(0), max_iter=100,
check_termination=25 -- through setup -> with_bounds -> with_settings ->
kernels.solve_fused, on the card. Phases, each of which raises on failure:

1. card: name and power limit (nvidia-smi); TF32 off;
2. build: compile csrc/*.cu for sm_90a (timed, set-up);
3. kernel against its plain PyTorch version at B=1000 (ragged) and 1024,
   check_termination 25 and 1; and against the port's admm.solve at B=256;
4. main path at B=32768: the kernel's launch count, the kernel against the
   plain version, the kernel's time (CUDA events, median of 7 after a
   warm-up) and the plain version's time; then the other two bench.py
   regimes (max_iter 500 / check_termination 25, max_iter 100 /
   check_termination 1), each also held against the plain version;
5. the kernels line, then the device line last.

Bar of kernel against plain version (float32; the kernel sums with FMA in
a fixed order, the plain version through cuBLAS): max|dx|, max|du| <= 1e-4,
identical solved fraction, >= 99% of lanes with identical iteration
counts. The two extra regimes of phase 4 hold the lanes whose iteration
counts agree (1e-3 over max_iter 500, 1e-4 at check_termination 1). Exits non-zero, printing no result, without a CUDA device or
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
REPS = 7

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


def problem(tt, torch, max_iter, ct, device="cuda"):
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N_HORIZON, dtype=torch.float32, device=device)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct)


def inputs(torch, B, device="cuda"):
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 12))
    Xref = np.tile(HOVER, (N_HORIZON, 1))
    kw = dict(dtype=torch.float32, device=device)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def compare(torch, label, sol_k, sol_p, res_k=None, res_p=None,
            atol=BAR_ATOL, lanes="all"):
    """Kernel against plain version. ``lanes="all"`` holds every lane to
    ``atol`` (the bar); ``lanes="same_iters"`` holds only the lanes whose
    iteration counts agree, for the long regimes where a lane that crosses
    the tolerance one check earlier on one side ends on another iterate.
    Returns the max abs difference over x and u of the lanes held."""
    B = sol_k.iter.shape[0]
    same = sol_k.iter == sol_p.iter
    held = torch.ones_like(same) if lanes == "all" else same
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
    log(f"  {label}: B={B} lanes held={lanes} max|dx|={dx:.3e} "
        f"max|du|={du:.3e} (all lanes {dx_all.max().item():.3e} "
        f"{du_all.max().item():.3e}) max|dres|={dres} "
        f"same_iters={same_iter:.5f} solved_frac kernel={sf_k:.5f} "
        f"plain={sf_p:.5f}")
    if not finite:
        raise AssertionError(f"{label}: kernel output is not finite")
    if not (dx <= atol and du <= atol):
        raise AssertionError(f"{label}: kernel differs from plain version "
                             f"by {max(dx, du):.3e} > {atol}")
    if sf_k != sf_p:
        raise AssertionError(f"{label}: solved fraction {sf_k} != {sf_p}")
    if same_iter < BAR_ITER_SHARE:
        raise AssertionError(f"{label}: only {same_iter:.4f} of lanes have "
                             "identical iteration counts")
    return max(dx, du)


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


def fused_work(N, nx, nu, B, iter_sum):
    """Operations and bytes the fused solve needs for this run: per lane
    and iteration, the backward sweep's [B';AmBKt]p, Quu w and Kinf'r
    products and the forward sweep's [Kinf;A]x and Bu products (an FMA
    counts as 2 operations), plus the elementwise work of the linear cost,
    projection and dual update (1 each); bytes are x0 read once and x, u,
    iterations, solved flags and residuals written once."""
    fma = (N - 1) * ((nu + nx) * nx + nu * nu + nx * nu) \
        + (N - 1) * ((nu + nx) * nx + nx * nu)
    elementwise = (N - 1) * (6 * nx + 5 * nu) + N * nx * 5 \
        + (N - 1) * (nu * 6 + 2 * nx)
    ops = float(iter_sum) * (2 * fma + elementwise)
    nbytes = 4 * B * nx + 4 * B * (N * nx + (N - 1) * nu) + B * (4 + 1 + 16)
    return ops, nbytes


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import _build, admm_fused

    # 1. card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build([admm_fused.KERNEL])
    admm_fused._kernel_fn()
    log(f"build: {time.perf_counter() - t0:.1f} s (set-up)")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "entry function" in line:
                log(f"  ptxas {line.strip()}")

    # 3. kernel against plain version, small; and against admm.solve
    log("phase 3: kernel vs plain version, small batches")
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

    # 4. main path at full width
    log(f"phase 4: main path, B={BATCH}")
    x0, Xref = inputs(torch, BATCH)
    regimes = {}
    # The main path is held to the bar on every lane. The other two
    # regimes hold the lanes whose iteration counts agree: to 1e-3 over
    # max_iter 500 (float32 rounding differences grow with the iterations)
    # and to the bar at check_termination 1.
    for mi, ct, atol, lanes in ((100, 25, BAR_ATOL, "all"),
                                (500, 25, 1e-3, "same_iters"),
                                (100, 1, BAR_ATOL, "same_iters")):
        admm_fused.launch_count = 0
        t0 = time.perf_counter()
        prob = problem(tt, torch, mi, ct)
        setup_ms = 1e3 * (time.perf_counter() - t0)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
        torch.cuda.synchronize()
        launches = admm_fused.launch_count
        if launches < 1:
            raise AssertionError("the main path did not launch the kernel")
        if sol_k.x.shape != (N_HORIZON, BATCH, 12) or \
                sol_k.u.shape != (N_HORIZON - 1, BATCH, 4):
            raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                                 f"{sol_k.u.shape}")
        t0 = time.perf_counter()
        sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, None, x0)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = compare(torch, f"max_iter={mi} ct={ct}", sol_k, sol_p, res_k,
                      res_p, atol, lanes)

        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(
            tables, x0c, N_HORIZON, 12, 4, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        # The whole entry-point call on the host clock (table packing,
        # allocation, launch, wait): how much of it the device is busy.
        e2e = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            tt.kernels.solve_fused(prob, Xref, None, x0)
            torch.cuda.synchronize()
            e2e.append(1e3 * (time.perf_counter() - t0))
        e2e_ms = statistics.median(e2e)
        iter_sum = int(sol_k.iter.sum().item())
        ops, nbytes = fused_work(N_HORIZON, 12, 4, BATCH, iter_sum)
        bound_ms = 1e3 * max(ops / peak_flops, nbytes / peak_bw)
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
                                 bound_by="operations" if ops / peak_flops
                                 >= nbytes / peak_bw else "bytes")

    # 5. kernels line, then the device line last
    main_run = regimes[(100, 25)]
    print(json.dumps({"kernels": [{
        "name": "admm_fused",
        "route": "cuda",
        "source": "tinympc_tpu_torch/csrc/admm_fused.cu",
        "replaces": "tinympc_tpu/kernels/admm_pallas.py:387",
        "launches": main_run["launches"],
        "max_abs_err": main_run["err"],
        "ms": main_run["ms"],
        "plain_ms": main_run["plain_ms"],
        "bound_ms": main_run["bound_ms"],
        "bound_by": main_run["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
