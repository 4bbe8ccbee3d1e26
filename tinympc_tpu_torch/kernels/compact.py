"""To-convergence fused solves with lane compaction on the GPU (counterpart
of ``tinympc_tpu.kernels.compact``).

The fused kernels stop each lane at its own convergence, but under SIMT a
converged thread idles in its warp until the warp's slowest lane stops, and
a block exits only with its slowest lane: on mixed to-convergence batches
most warp-iterations hold a running lane while few lanes do work (PERF.md
section 5). :func:`make_compact_solver` splits the iteration budget into
phases (``chunk``), runs each phase as one warm ``final=True`` solve of the
live lanes, and between phases gathers the lanes that are still running
into a dense batch, so the next phase's warps and blocks hold live lanes
only.

The warm carry (:class:`~.admm_fused.FusedCarry`) hands a phase boundary
over exactly: a lane that has not converged hands over its final iterate
(vnew/znew/g/y and, as v/z, the same iterate, which the next phase's first
dual residual compares against as one long solve would), and the next
phase resumes it. For box problems at fixed rho the compacted solve is
therefore bitwise equal to one long solve of the same backend: the same
iterates, counts and residuals. Everything between phases is plain
``torch`` indexing on the card: the live lanes' x0 and carry are gathered
with ``index_select`` along the lane axis (the carry is lane-last), and
each phase's outputs are scattered back with ``index_copy_``, counts offset
by the iterations already spent. The host reads one solved mask a phase.

Deviations from one long solve, by construction (as in the JAX package):
  * the other constraint families re-seed their slacks from the carried
    x/u at each phase boundary, as the reference does on every solve
    (admm.cpp:352-376);
  * adaptive rho restarts its every-5-iterations clock at each phase, and
    each lane's rho rides the carry; the residuals keep the final-rho 5th
    row;
  * consensus compacts in group units: a group stays while any of its
    lanes is unsolved (its mean reads every lane), and the scatter keeps a
    converged lane's first-convergence outputs. A converged lane of a live
    group resumes from its carry, which here is its state at first
    convergence (the JAX kernel hands over a post-convergence iterate),
    and the consensus slack re-seeds from the carried u[0] at each phase.

On CPU tensors the phases run the kernels' plain versions, on CUDA tensors
the kernels; any other device raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..types import Solution, TinyProblem
from . import admm_fused, admm_stream
from .admm_fused import BLOCK, FusedCarry, init_carry

BACKENDS = ("auto", "resident", "streamed")

# Compaction phases run in this process (each one warm final=True solve,
# the precise tail included); chip_smoke.py resets and reads it beside the
# kernels' launch counters.
phase_count = 0


def _backend(prob: TinyProblem, backend: str) -> str:
    """The backend that runs the phases, checked against the problem:
    "auto" is the resident kernel when :func:`~.admm_fused.fused_supported`
    holds, else the streamed kernels when
    :func:`~.admm_stream.stream_supported` does."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        if admm_fused.fused_supported(prob):
            return "resident"
        if admm_stream.stream_supported(prob):
            return "streamed"
        errors = []
        for check in (admm_fused._check, admm_stream._check):
            try:
                check(prob)
            except ValueError as e:
                errors.append(str(e))
        raise ValueError("neither the resident nor the streamed kernel takes "
                         "this problem: " + "; ".join(errors))
    (admm_fused._check if backend == "resident" else admm_stream._check)(prob)
    return backend


def make_compact_solver(prob: TinyProblem, *,
                        chunk: Union[int, Sequence[int]] = 100,
                        min_batch: int = 256, segment: Optional[int] = None,
                        backend: str = "auto",
                        precise_tail: Optional[int] = None):
    """Build a reusable to-convergence compaction solver for ``prob``.

    Returns ``solve(x0s, Xref=None, Uref=None) -> (Solution, residuals)``,
    the results of one ``solve_fused`` over the problem's whole
    ``settings.max_iter`` budget (bitwise so for box problems at fixed rho,
    see the module docstring), where converged lanes stop taking warps at
    the next phase boundary. A consensus problem takes x0s as
    (n_groups, G, nx) and returns the grouped layout, as ``solve_fused``
    does.

    Args:
      prob: the configured problem; ``settings.max_iter`` is the budget.
      chunk: iterations a phase: an int, or a schedule of phase lengths
        whose last entry repeats until the budget is spent (``[100, 400]``:
        compact once after 100 iterations, then run the survivors to the
        cap, one readback in all). Each must be a positive multiple of
        ``settings.check_termination``, so that checks land on phase
        boundaries.
      min_batch: stop shrinking below this many lanes: a phase runs at
        least ``min(min_batch, B)`` lanes, the first live lane (group)
        repeated, and the repeats are dropped at the scatter. (On the CPU
        a one-lane plain solve multiplies one column, which PyTorch sums
        in another order than a wider product: keep it at 2 or more there
        for the bitwise property.)
      segment: at most this many lanes on the card at once; a larger
        batch runs as independent segments whose results are concatenated
        (the fleet pattern; the box quadrotor's carry at N=20 is ~3.7 KiB
        a lane). None: the whole batch. Consensus ignores it.
      backend: "resident" (:func:`~.admm_fused.solve_fused_warm`,
        ``final=True``), "streamed"
        (:func:`~.admm_stream.solve_fused_streamed_warm`, the same carry),
        or "auto": the
        resident kernel where :func:`~.admm_fused.fused_supported` holds,
        else the streamed kernels where
        :func:`~.admm_stream.stream_supported` does, else ``ValueError``.
        (The TPU's rule, a resident tile below 1024 lanes, is a VMEM rule
        with no meaning on the card.)
      precise_tail: after the budget, the lanes (groups) still unsolved
        warm-resume for up to this many more iterations and report
        ``iter > max_iter``. On the TPU the tail reruns them at
        matmul_precision "highest" after a cheaper "high" budget; the port
        runs "highest" throughout, so here the tail changes only the
        budget. None: off.

    Raises ``ValueError`` for a bad chunk or backend and for a problem the
    backend does not take; ``solve`` raises it for a consensus group size
    that is not a power of two up to the kernels' 128-lane block, and for
    a device other than the CPU or a GPU.
    """
    settings = prob.settings
    total = int(settings.max_iter)
    ct = int(settings.check_termination)
    backend = _backend(prob, backend)
    schedule = [chunk] if isinstance(chunk, (int, np.integer)) \
        else [int(c) for c in chunk]
    if not schedule:
        raise ValueError("chunk must be an int or a non-empty schedule")
    for c in schedule:
        if c < 1 or c % ct:
            raise ValueError(
                f"chunk ({c}) must be a positive multiple of "
                f"check_termination ({ct}) so that residual checks land on "
                "phase boundaries")
    if min_batch < 1:
        raise ValueError(f"min_batch ({min_batch}) must be at least 1")
    if precise_tail is not None and precise_tail < 0:
        raise ValueError(f"precise_tail ({precise_tail}) must be >= 0")
    consensus = prob.spec.en_consensus
    warm = (admm_stream.solve_fused_streamed_warm if backend == "streamed"
            else lambda *a: admm_fused.solve_fused_warm(*a, final=True))
    phase_probs = {}

    def run(iters, Xref, Uref, x0, carry):
        """One phase: a warm solve of ``iters`` iterations."""
        global phase_count
        if iters not in phase_probs:
            phase_probs[iters] = prob.replace(settings=dataclasses.replace(
                settings, max_iter=iters))
        out = warm(phase_probs[iters], Xref, Uref, x0, carry)
        phase_count += 1
        return out

    def phase_len(idx, remaining):
        return min(schedule[min(idx, len(schedule) - 1)], remaining)

    def solve(x0s, Xref=None, Uref=None):
        dev = prob.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"compaction runs on cuda or cpu, not {dev}")
        if isinstance(x0s, torch.Tensor) and x0s.device != dev:
            raise ValueError(f"x0s is on {x0s.device}, the problem on {dev}")
        x0s = torch.as_tensor(x0s, dtype=torch.float32, device=dev)
        nx = prob.spec.nx
        if consensus:
            if x0s.ndim != 3 or x0s.shape[0] < 1:
                raise ValueError("a consensus problem takes x0s as (n_groups, "
                                 f"G, {nx}), got {tuple(x0s.shape)}")
            G = x0s.shape[1]
            if G < 1 or G & (G - 1) or G > BLOCK:
                raise ValueError(
                    f"scenario group size {G} must be a power of two and at "
                    f"most {BLOCK}, the kernels' block (larger groups are not "
                    "ported yet, ROADMAP.md)")
            return _phases(x0s, Xref, Uref)
        if x0s.ndim != 2 or x0s.shape[0] < 1:
            raise ValueError(f"x0s must be (B, {nx}), got {tuple(x0s.shape)}")
        B = x0s.shape[0]
        if segment and B > segment:
            parts = [solve(x0s[o:o + segment], Xref, Uref)
                     for o in range(0, B, segment)]
            sols, ress = zip(*parts)
            return (Solution(iter=torch.cat([s.iter for s in sols]),
                             solved=torch.cat([s.solved for s in sols]),
                             x=torch.cat([s.x for s in sols], dim=1),
                             u=torch.cat([s.u for s in sols], dim=1)),
                    torch.cat(ress, dim=1))
        # A batch without consensus is the case of groups of one lane.
        return _phases(x0s[:, None], Xref, Uref)

    def _phases(x0g, Xref, Uref):
        """The phases over x0g (n_groups, G, nx), compacted in group units:
        a group stays while any of its lanes is unsolved. Returns the
        outputs in the layout of x0s."""
        ng0, G = x0g.shape[:2]
        B, dev = ng0 * G, x0g.device
        inputs = (lambda x: x) if consensus else (lambda x: x[:, 0])
        used = phase_len(0, total)
        sol, res, carry = run(used, Xref, Uref, inputs(x0g),
                              init_carry(prob, B))
        out = list(_lanes(sol, res))
        groups = np.arange(ng0)        # global group of each carry slot
        solved = out[3].cpu().numpy()  # of the lanes of each slot's group
        lane = torch.arange(G, device=dev)
        idx = 1
        while used < total or precise_tail:
            tail = used >= total
            # Liveness is positional in the narrowed order: carry slot i
            # holds group groups[i] (tinympc_tpu/kernels/compact.py:364-373).
            live = np.flatnonzero(~solved.reshape(-1, G).all(axis=1))
            if live.size == 0:
                break
            groups, kg = groups[live], live.size
            pg = max(kg, -(-min(min_batch, B) // G))
            local_t, global_t = (_padded(a, pg, dev) for a in (live, groups))
            carry = _take(carry, (local_t[:, None] * G + lane).reshape(-1))
            step = precise_tail if tail else phase_len(idx, total - used)
            idx += 1
            sol, res, carry = run(step, Xref, Uref,
                                  inputs(x0g.index_select(0, global_t)), carry)
            sel = (global_t[:kg, None] * G + lane).reshape(-1)
            _scatter(out, sel, _lanes(sol, res), used, kg * G, G > 1)
            if tail:
                break
            used += step
            solved = out[3].index_select(0, sel).cpu().numpy()
        N, nu, nx = prob.spec.N, prob.spec.nu, prob.spec.nx
        lead = (ng0, G) if consensus else (ng0,)
        return (Solution(iter=out[2].reshape(lead),
                         solved=out[3].reshape(lead),
                         x=out[0].reshape(N, *lead, nx),
                         u=out[1].reshape(N - 1, *lead, nu)),
                out[4].reshape(out[4].shape[0], *lead))

    return solve


def solve_fused_compact(prob: TinyProblem, Xref=None, Uref=None, x0s=None,
                        *, chunk: Union[int, Sequence[int]] = 100,
                        min_batch: int = 256):
    """One-shot wrapper over :func:`make_compact_solver`: builds the solver
    and runs it once. Hold on to ``make_compact_solver(prob, ...)`` for
    repeated solves."""
    return make_compact_solver(prob, chunk=chunk,
                               min_batch=min_batch)(x0s, Xref, Uref)


def _padded(ids: np.ndarray, P: int, device) -> torch.Tensor:
    """``ids`` with its first entry repeated up to P entries, on the
    device."""
    if P > ids.size:
        ids = np.concatenate([ids, np.full(P - ids.size, ids[0])])
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def _take(carry: FusedCarry, lanes: torch.Tensor) -> FusedCarry:
    """The carry of the given lanes (slots), in that order: each field
    indexed along its last, lane axis."""
    return FusedCarry(**{
        f.name: None if getattr(carry, f.name) is None
        else getattr(carry, f.name).index_select(-1, lanes)
        for f in dataclasses.fields(carry)})


def _lanes(sol: Solution, res: torch.Tensor):
    """A solve's outputs as lanes, whatever its batch layout: x (N, B, nx),
    u (N-1, B, nu), iter (B,), solved (B,), residuals (rows, B)."""
    N, nx, nu = sol.x.shape[0], sol.x.shape[-1], sol.u.shape[-1]
    return (sol.x.reshape(N, -1, nx), sol.u.reshape(N - 1, -1, nu),
            sol.iter.reshape(-1), sol.solved.reshape(-1),
            res.reshape(res.shape[0], -1))


def _scatter(out, sel: torch.Tensor, phase, used: int, k: int,
             freeze: bool) -> None:
    """Write the first k lanes of a phase into the outputs at lanes
    ``sel``, counts offset by the ``used`` iterations before the phase.
    With ``freeze`` (consensus: whole live groups), keep the outputs of the
    lanes that had converged before it (first-convergence freeze,
    tinympc_tpu/kernels/compact.py:232-249); without, every lane written
    is one that had not converged."""
    live = ~out[3].index_select(0, sel) if freeze else None
    px, pu, pit, psolved, pres = phase
    for dst, new, axis in zip(out, (px, pu, pit + used, psolved, pres),
                              (1, 1, 0, 0, 1)):
        new = new.narrow(axis, 0, k)
        if freeze:
            shape = [1] * new.ndim
            shape[axis] = -1
            new = torch.where(live.reshape(shape), new,
                              dst.index_select(axis, sel))
        dst.index_copy_(axis, sel, new)
