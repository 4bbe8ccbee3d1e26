"""Speed-of-light accounting for the fused solve on the card (counterpart of
``tools/roofline.py``).

    python -m tinympc_tpu_torch.roofline

Times one ADMM iteration of the fused kernel (``csrc/admm_fused.cu``)
beside the probes of ``csrc/roofline.cu`` on the same shapes, and prints one
JSON line a config. The configs are the TPU tool's: the quadrotor (nx=12,
nu=4) at N=20 and B=32768, check_termination 1 and 25, and
``systems.synthetic(32, 8)`` at N=20 and B=16384; box +-50 / +-5,
max_iter 100 and tolerances 0, so that no lane converges and every solve
does fixed work. They run at ``matmul_precision="highest"`` (the TPU tool's
``"high"`` is a TPU mode the port refuses). The fused kernel has no (32, 8)
instantiation (ROADMAP Queue 2 item 1c): there only the probes run, and the
solve's fields are null.

The probes, timed per rep of the whole batch:
  * the TPU probe's dots: L = 5 (N-1) dots of depth 3 nx with bf16
    operands and float32 accumulation, chained (on the CUDA cores: a chain
    of one-column products, the solve's pattern) and independent (on the
    tensor cores, mma.sync, as the TPU probe runs on the MXU). So
    ``independent_dots_us`` is the card's bf16 tensor-core rate at these
    shapes, and ``chain_vs_pipeline`` the solve's chain against it, as the
    TPU tool meant it against the MXU;
  * the card's own chain: float32 matvecs at depth nx, chained and
    independent, L = 2 (N-1). That is the depth-nx matvecs on one
    iteration's serial chain in ``csrc/admm_sweep.cuh``: the backward
    sweep's [B^T; AmBKt] p (each step's p waits on the last) and the
    forward sweep's [Kinf; A] x, N-1 each, 38 at N=20. The forward sweep's
    N-1 products B u, of depth nu, sit on the chain too and are left out
    (``chain_depth_nu``);
  * the elementwise stream: 8 add+clip passes, and 4 max-abs reductions,
    over (N, nx + nu, B) float32.

Keys are the TPU tool's where they mean the same on the card. On the TPU a
launch walks its lane tiles one after another, so the tool divides by the
tiles; on the card every block of a launch runs at once, so "per tile"
becomes "per iteration of the batch": ``measured_iter_us`` is the kernel's
time over its iterations, and each probe's time is that of one rep over
all B lanes. Times come from CUDA events around launches (median of
``TIMING_REPS``), not from the TPU tool's pipelined host clock. Each line
carries the card's name and power limit, and its SM clock sampled just
after the probes and just after the solve. Without a CUDA device the tool
exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import api, systems
from .kernels import admm_fused
from .kernels.roofline import (dot_inputs, elementwise_inputs, run_dot,
                               run_elementwise)

REPS = 20              # in-kernel repetitions of each probe
TIMING_REPS = 5        # launches timed (median)
PASSES, REDUCTIONS = 8, 4

# (label, system, nx, nu, N, B, check_termination)
CONFIGS = (
    ("quadrotor nx=12 nu=4 N=20 B=32768 f32 ct=1", "quadrotor_20hz", 12, 4,
     20, 32768, 1),
    ("quadrotor nx=12 nu=4 N=20 B=32768 f32 ct=25", "quadrotor_20hz", 12, 4,
     20, 32768, 25),
    ("synthetic nx=32 nu=8 N=20 B=16384 f32 ct=25", "synthetic", 32, 8, 20,
     16384, 25),
)


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def sm_clock() -> str:
    """The card's SM clock and its maximum now, as nvidia-smi gives them
    (``"1980 MHz, 1980 MHz"``): a card below its maximum clock runs the
    same kernel slower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events),
    after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def iteration_flops(N: int, nx: int, nu: int) -> int:
    """Operations of one ADMM iteration of one lane, the TPU tool's count:
    the backward and forward sweeps' products (2 an FMA) and 15 a feature
    and step of elementwise work."""
    back = (N - 1) * (2 * (nx + nu) * nx + 2 * nu * nu + 2 * nx * nu)
    fwd = (N - 1) * (2 * (nx + nu) * nx + 2 * nx * nu)
    return back + fwd + 15 * N * (nx + nu)


def chain_length(N: int) -> int:
    """Depth-nx matvecs on one iteration's serial chain: N-1 backward, N-1
    forward (see the module docstring)."""
    return 2 * (N - 1)


def probe_times(nx: int, nu: int, N: int, B: int, device="cuda") -> dict:
    """Milliseconds per rep of each probe at a config's shapes."""
    out = {}
    for operand, depth, L in (("bf16", 3 * nx, 5 * (N - 1)),
                              ("f32", nx, chain_length(N))):
        M, Ms, v = dot_inputs(L, depth, B, operand, device)
        for chained in (True, False):
            out[(operand, chained)] = cuda_ms(
                lambda: run_dot(M, Ms, v, chained, REPS)) / REPS
        del M, Ms, v
    a, b = elementwise_inputs(N, nx + nu, B, device)
    out["pass"] = cuda_ms(
        lambda: run_elementwise(a, b, PASSES, 0, REPS)) / REPS
    out["red4"] = cuda_ms(
        lambda: run_elementwise(a, b, 0, REDUCTIONS, REPS)) / REPS
    return out


def solve_time(sysd: dict, nx: int, nu: int, N: int, B: int, ct: int,
               device="cuda"):
    """Milliseconds of one fused solve of fixed work at the config, and its
    mean iterations; None where the thread-group kernel has no (nx, nu)
    instantiation (ROADMAP Queue 2 item 1c: (32, 8) waits for the group
    design; the one-thread kernel's pairs are not timed here)."""
    dims = set(admm_fused.KERNEL_DIMS) | set(admm_fused.FAMILY_KERNEL_DIMS)
    if (nx, nu) not in dims:
        return None
    prob = api.setup(sysd["A"], sysd["B"], sysd["Qdiag"], sysd["Rdiag"],
                     rho=sysd["rho"], N=N, dtype=torch.float32, device=device)
    prob = api.with_bounds(prob, x_min=-50.0, x_max=50.0, u_min=-5.0,
                           u_max=5.0)
    prob = api.with_settings(prob, max_iter=100, check_termination=ct,
                             abs_pri_tol=0.0, abs_dua_tol=0.0)
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5,
                                                           (B, nx)),
                          dtype=torch.float32, device=device)
    tables, x0, params = admm_fused._prepare(prob, None, None, x0s)
    run = lambda: admm_fused._solve_kernel(tables, x0, N, nx, nu, **params)
    ms = cuda_ms(run)
    return ms, float(run()[0].iter.float().mean())


def run_config(label, sysd, nx, nu, N, B, ct, card, device="cuda") -> dict:
    """Measure one config on the card; print and return its JSON line."""
    p = probe_times(nx, nu, N, B, device)
    clock_probes = sm_clock()
    solve = solve_time(sysd, nx, nu, N, B, ct, device)
    clock_solve = sm_clock()
    L, Lf = 5 * (N - 1), chain_length(N)
    us = lambda ms: round(ms * 1e3, 4)
    flops_lane = iteration_flops(N, nx, nu)
    rows = N * (nx + nu) * B
    chain, indep = p[("bf16", True)], p[("bf16", False)]
    chain_f, indep_f = p[("f32", True)], p[("f32", False)]
    line = {
        "config": label,
        "check_termination": ct,
        "solve": "fused kernel" if solve else
        f"no ({nx}, {nu}) instantiation",
        "measured_iter_us": None if solve is None
        else us(solve[0] / solve[1]),
        "standalone_parts_sum_us": us(chain + p["pass"] + p["red4"] / ct),
        "chained_dots_us": us(chain),
        "independent_dots_us": us(indep),
        "chain_vs_pipeline": round(chain / indep, 4),
        "elementwise_pass_us": us(p["pass"]),
        "residual_reduction4_us": us(p["red4"]),
        "dots_per_iter": L,
        "ns_per_chained_dot": round(chain / L * 1e6, 2),
        "ns_per_pipelined_dot": round(indep / L * 1e6, 2),
        "flops_per_lane_iter": flops_lane,
        "achieved_tflops": None if solve is None else round(
            flops_lane * B * solve[1] / (solve[0] * 1e-3) / 1e12, 4),
        "solves_per_s_equiv": None if solve is None
        else round(B / (solve[0] * 1e-3), 1),
        "f32_chain_matvecs_per_iter": Lf,
        "chain_depth_nu": N - 1,
        "f32_chained_dots_us": us(chain_f),
        "f32_independent_dots_us": us(indep_f),
        "f32_chain_vs_pipeline": round(chain_f / indep_f, 4),
        "ns_per_chained_matvec": round(chain_f / Lf * 1e6, 2),
        "predicted_iter_us": us(chain_f),
        # a and b read once a pass rep; a alone for the reductions
        "elementwise_pass_tb_s": round(8 * rows / (p["pass"] * 1e-3)
                                       / 1e12, 4),
        "residual_reduction4_tb_s": round(4 * rows / (p["red4"] * 1e-3)
                                          / 1e12, 4),
        "batch": B,
        "sm_clock_after_probes": clock_probes,
        "sm_clock_after_solve": clock_solve,
        "device": torch.cuda.get_device_name(0),
        "card": card["name"],
        "power_limit": card["power_limit"],
    }
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: no CUDA device; the tool measures the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    for label, name, nx, nu, N, B, ct in CONFIGS:
        sysd = systems.synthetic(nx, nu) if name == "synthetic" \
            else getattr(systems, name)()
        run_config(label, sysd, nx, nu, N, B, ct, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
