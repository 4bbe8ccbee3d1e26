#!/usr/bin/env python3
"""Outputs of the port's fixed-rho kernels on fixed inputs, saved and
compared bitwise: a check that a change left a kernel's results as they
were, across two checkouts on one card.

    python3 chip_compare.py save OUT.pt      # in each checkout, on the GPU
    python3 chip_compare.py diff A.pt B.pt   # anywhere

``save`` runs, at B=1024 with inputs from numpy's default_rng(0), the box
kernel cold and warm (the quadrotor at 20 Hz, N=20), the families kernel
cold and warm (the rocket's cones at N=10; the quadrotor's static and
time-varying hyperplanes under low z ceilings), the families kernel with
consensus (128 groups of 8), the fused closed loop (T=10), and the streamed
kernels cold and warm (box at N=64, the rocket's cones at N=32, consensus
at N=10), and writes every output and carry field. ``diff`` prints, for
each entry, whether the two files hold the same bits, and exits non-zero
when any differs. Two packages cannot share a process: run ``save`` once
per checkout.

    python3 chip_compare.py build OUT.json   # in each checkout, on the GPU
    python3 chip_compare.py diff A.json B.json

``build`` compiles csrc/admm_fused.cu afresh and writes, for each of its
kernels by chip_smoke.py's label, the ptxas registers, stack and spills
and a hash of its SASS (cuobjdump -sass, addresses and encodings
dropped; the instructions themselves in OUT.json.sass); ``diff`` of two
such files says, for each label both have, whether the ptxas figures and
the instructions are the same, and exits non-zero when any differs.

    python3 chip_compare.py time             # in each checkout, on the GPU

``time`` times the main path's kernel (bench.py's batch: the quadrotor at
20 Hz, N=20, box +-5 / +-0.5, hover, B=32768, x0 ~ U[-0.5, 0.5] from
default_rng(0), max_iter 100, check_termination 25): ``TIME_REPS``
launches on CUDA events after one to warm up, and prints one JSON line with
every time, the median, the card's name and power limit and its SM clock
sampled just after. Run it in alternation (parent, change, change,
parent) to compare two checkouts on one card.
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


def _quad(tt, torch, N, max_iter=100, ct=1):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device=DEVICE)
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct)


def _rocket(tt, torch, N):
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device=DEVICE)
    p = tt.with_bounds(
        p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
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
    x_g = x_q.reshape(B // 8, 8, 12)
    out.update(_flat("consensus.cold",
                     kern.solve_fused(tree, hover(10), None, x_g)))
    c = tt.init_carry(tree, B)
    out.update(_flat("consensus.warm",
                     kern.solve_fused_warm(tree, hover(10), None, x_g, c)))
    loop = kern.closed_loop_fused(_quad(tt, torch, 10, ct=5),
                                  hover(10 + 9), x_q, 10)
    out.update({f"closed_loop.{k}": v for k, v in zip(
        ("xs", "us", "iters", "solved"), loop)})
    streamed = [("box", _quad(tt, torch, 64, 20), x_q, hover(64), None),
                ("rocket_soc", _rocket(tt, torch, 32), x_r, *descent(32)),
                ("consensus", tree, x_g, hover(10), None)]
    for name, prob, x0, Xref, Uref in streamed:
        out.update(_flat(f"streamed.{name}.cold", kern.solve_fused_streamed(
            prob, Xref, Uref, x0)))
        c = tt.init_carry(prob, B)
        out.update(_flat(f"streamed.{name}.warm",
                         kern.solve_fused_streamed_warm(prob, Xref, Uref,
                                                        x0, c)))
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"chip_compare: {len(out)} tensors saved to {path}; card "
          f"{torch.cuda.get_device_name(0)}")


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def time_main_path():
    import torch
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch.kernels import admm_fused
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dtype=torch.float32, device=DEVICE)
    prob = _quad(tt, torch, 20, ct=25)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5,
                                                         (TIME_B, 12)), **kw)
    Xref = torch.zeros((20, 12), **kw)
    Xref[:, 2] = 1.0
    tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
    run = lambda: admm_fused._solve_kernel(tables, x0c, 20, 12, 4, **params)
    sol = run()[0]
    torch.cuda.synchronize()
    times = []
    for _ in range(TIME_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(json.dumps({
        "main_path_ms": statistics.median(times), "times_ms": times,
        "mean_iters": sol.iter.float().mean().item(),
        "card": _smi("name,power.limit"),
        "sm_clock_after": _smi("clocks.sm,clocks.max.sm")}), flush=True)


def build_report(path):
    import chip_smoke
    from tinympc_tpu_torch.kernels import _build
    lib = _build.library_path("admm_fused")
    if lib.exists():
        lib.unlink()
    log = _build.build(["admm_fused"])["admm_fused"]
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
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
    print(f"chip_compare: {len(out)} kernels of admm_fused.cu written to "
          f"{path} (SASS text in {path}.sass)")


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
    for k in sorted(set(a) | set(b)):
        same = k in a and k in b and a[k].shape == b[k].shape and \
            torch.equal(a[k], b[k])
        bad += not same
        print(f"{k}: {'same bits' if same else 'DIFFERS'}")
    print(f"chip_compare: {len(set(a) | set(b)) - bad} entries bitwise "
          f"equal, {bad} differ")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "build":
        build_report(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "time":
        time_main_path()
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "diff":
        sys.exit(diff(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
