"""The streamed solve's wrappers: what ``solve_fused_streamed`` and
``solve_fused_streamed_warm`` refuse, the host loop's launches against a
stand-in for the C entry points of csrc/admm_stream.cu (family arrays, the
stale first iteration, the tracked x/u, the flag read after check
iterations only), the public layout on the CPU, and the resident kernel's
shared-memory limit, past which the streamed solve takes over."""
import contextlib
import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.kernels import (fused_supported, init_carry,
                                       solve_fused, solve_fused_streamed,
                                       solve_fused_streamed_warm,
                                       stream_supported)
from tinympc_tpu_torch.kernels import _build, admm_fused, admm_stream

torch.set_num_threads(1)


def _quad(N=8, **settings):
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, **{"max_iter": 5, **settings})


def _rocket(N=8, **settings):
    s = tt.systems.rocket_landing_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 f=s["f"], dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, u_min=-10.0, u_max=105.0)
    p = tt.with_cones(p, state_cones=[(0, 3, 0.25)],
                      input_cones=[(0, 3, 0.5)])
    return tt.with_settings(p, **{"max_iter": 5, **settings})


def _tv(N=8, **settings):
    s = tt.systems.quadrotor_50hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    Ax = np.zeros((N, 1, 12))
    Ax[:, 0, 2] = 1.0
    p = tt.with_tv_linear_constraints(p, Ax, np.full((N, 1), 1.2),
                                      np.ones((N - 1, 1, 4)),
                                      np.full((N - 1, 1), 6.0))
    return tt.with_settings(p, **{"max_iter": 5, **settings})


@pytest.mark.parametrize("settings,match", [
    (dict(adaptive_rho=True), "sensitivities"),
    (dict(matmul_precision="high"), "highest"),
    (dict(coarse_iters=50), "coarse_iters"),
], ids=["adaptive_rho", "high", "coarse_iters"])
def test_streamed_refuses_settings_outside_the_slice(settings, match):
    # The settings alone: adaptive rho runs on the streamed kernels, but
    # not without its sensitivities, which are not computed here.
    p = _quad()
    p = p.replace(settings=dataclasses.replace(p.settings, **settings))
    assert not stream_supported(p)
    x0 = torch.zeros((2, 12))
    with pytest.raises(ValueError, match=match):
        solve_fused_streamed(p, None, None, x0)
    with pytest.raises(ValueError, match=match):
        solve_fused_streamed_warm(p, None, None, x0, init_carry(_quad(), 2))


def test_streamed_refuses_consensus_and_other_sizes():
    """Consensus without its step-0 gains (en_consensus set by hand, not by
    with_consensus), a scenario group past the kernels' 128-lane block, an
    uninstantiated (nx, nu) and a carry of another problem are refused."""
    p = _quad()
    consensus = p.replace(spec=dataclasses.replace(p.spec, en_consensus=True))
    s = tt.systems.synthetic(5, 2)
    odd = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=5,
                   device="cpu")          # (nx, nu) = (5, 2): not built
    with pytest.raises(ValueError, match="with_consensus"):
        solve_fused_streamed(consensus, None, None, torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="power of two"):
        solve_fused_streamed(tt.with_consensus(p), None, None,
                             torch.zeros((1, 256, 12)))
    assert stream_supported(tt.with_consensus(p))
    with pytest.raises(ValueError, match="instantiations"):
        solve_fused_streamed(odd, None, None, torch.zeros((2, 5)))
    assert not stream_supported(consensus) and not stream_supported(odd)
    with pytest.raises(ValueError, match="carry"):
        solve_fused_streamed_warm(p, None, None, torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="carry fields"):
        solve_fused_streamed_warm(_rocket(), None, None, torch.zeros((2, 6)),
                                  init_carry(_quad(), 2))


def test_smem_bytes_follow_the_kernels_layout():
    """The resident kernel's shared memory, as csrc/admm_fused.cu sums it
    (Layout, the family and adaptive tables, the terminal reference term),
    here for (12, 4) box and the tv family at (6, 3)."""
    nx, nu = 12, 4
    for N in (20, 512, 2048):
        box = ((nu + nx) * nx * 2 + nu * nu + 2 * nx * nu + 3 * nx + 2 * nu
               + nx * nx + 3 * N * nx + 3 * (N - 1) * nu)
        assert admm_fused.smem_bytes(nx, nu, N) == 4 * (box + nx)
    fam = admm_fused.Families(ntx=2)
    N = 100
    box = ((3 + 6) * 6 * 2 + 9 + 2 * 18 + 18 + 6 + 36 + 3 * N * 6
           + 3 * (N - 1) * 3)
    assert admm_fused.smem_bytes(6, 3, N, fam) == 4 * (box + N * 2 * 8 + 6)


def test_resident_kernel_refuses_tables_past_shared_memory():
    """At N=2048 the (12, 4) table takes ~396 KB, more than the 232,448 B
    a block may have: fused_supported is False and solve_fused raises,
    naming the streamed solve, which takes the same problem. The last
    horizon that fits, 1196, is still the resident kernel's."""
    big = _quad(N=2048)
    assert admm_fused.smem_bytes(12, 4, 2048) > admm_fused.SMEM_LIMIT
    assert not fused_supported(big)
    with pytest.raises(ValueError, match="solve_fused_streamed"):
        solve_fused(big, None, None, torch.zeros((2, 12)))
    assert stream_supported(big)
    assert fused_supported(_quad(N=1196)) and not fused_supported(
        _quad(N=1197))


def test_streamed_on_cpu_returns_the_public_layout():
    p = _quad(N=12, max_iter=30)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (5, 12)),
                         dtype=torch.float32)
    sol, res = solve_fused_streamed(p, None, None, x0)
    assert sol.x.shape == (12, 5, 12) and sol.u.shape == (11, 5, 4)
    assert sol.iter.dtype == torch.int32 and sol.solved.dtype == torch.bool
    assert res.shape == (4, 5)
    sol_w, res_w, carry = solve_fused_streamed_warm(p, None, None, x0,
                                                    init_carry(p, 5))
    assert torch.equal(sol_w.x, sol.x) and torch.equal(res_w, res)
    assert carry.vnew.shape == (12, 12, 5) and carry.znew.shape == (11, 4, 5)
    sol0, _, carry0 = solve_fused_streamed_warm(
        tt.with_settings(p, max_iter=0), None, None, x0, carry)
    assert (sol0.iter == 0).all()
    assert torch.equal(carry0.vnew, carry.vnew) and torch.equal(carry0.v,
                                                                carry.vnew)


class _Entries:
    """Stand-ins for tinympc_stream_backward / tinympc_stream_forward and
    their team entries, the box pair and the families pair: they record
    what each launch is given and write nothing; ``active`` says what the
    forward launch of a check iteration leaves in the flag; ``stale_v`` is
    the address of the carried v, which a team launch's dual residual
    reads in its stale launch."""

    def __init__(self, active=0):
        self.calls, self.active, self.stale_v = [], active, None

    def backward(self, *args):
        assert len(args) == 18
        nx, nu, N, B = args[:4]
        fam = [args[14][k] for k in range(12)]
        self.calls.append(("bwd", [args[4][k] for k in range(6)],
                           [p is not None for p in fam]))
        assert all(p is not None for p in args[6:14])
        assert args[15] is None            # no consensus arguments
        assert args[16] is None            # no adaptive-rho arguments
        return 0

    def forward(self, *args):
        assert len(args) == 29
        assert args[26] is None            # no consensus arguments
        assert args[27] is None            # no adaptive-rho arguments
        stale, it, ct = args[0], args[5], args[6]
        prev = [args[13][k] for k in range(4)]
        assert prev[0] is not None and prev[1] is not None
        assert (prev[2] is not None) == bool(stale)
        assert (prev[3] is not None) == bool(stale)
        fam = [args[23][k] for k in range(12)]
        x_out, u_out = args[24], args[25]
        assert (x_out is None) == (u_out is None)
        self.calls.append(("fwd", it, bool(stale), x_out is not None,
                           [p is not None for p in fam]))
        if (it + 1) % ct == 0:      # the flag (a CPU tensor here)
            ctypes.c_int.from_address(args[22]).value = self.active
        return 0

    def team_backward(self, *args):
        assert len(args) == 15
        assert all(p is not None for p in args[5:13])
        assert args[13] is None            # no adaptive-rho arguments
        # a box problem's: no family counts and no family arrays
        self.calls.append(("bwd", [0] * 6, [False] * 12))
        return 0

    def team(self, *args):
        assert len(args) == 24
        assert all(p is not None for p in args[9:22])
        assert args[22] is None            # no adaptive-rho arguments
        it, ct = args[4], args[5]
        # no family arrays and no tracked x/u: a box problem's
        self.calls.append(("fwd", it, args[11] == self.stale_v, False,
                           [False] * 12))
        if (it + 1) % ct == 0:
            ctypes.c_int.from_address(args[21]).value = self.active
        return 0

    def team_families_backward(self, *args):
        assert len(args) == 16
        assert all(p is not None for p in args[6:14])
        self.calls.append(("bwd", [args[4][k] for k in range(6)],
                           [args[14][k] is not None for k in range(12)]))
        return 0

    def team_families(self, *args):
        assert len(args) == 27
        assert all(p is not None for p in args[10:23])
        it, ct = args[4], args[5]
        x_out, u_out = args[24], args[25]
        assert (x_out is None) == (u_out is None)
        self.calls.append(("fwd", it, args[12] == self.stale_v,
                           x_out is not None,
                           [args[23][k] is not None for k in range(12)]))
        if (it + 1) % ct == 0:
            ctypes.c_int.from_address(args[22]).value = self.active
        return 0


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (e.backward, e.forward))
    monkeypatch.setattr(admm_stream, "_team_fns",
                        lambda: (e.team_backward, e.team))
    monkeypatch.setattr(admm_stream, "_team_families_fns",
                        lambda: (e.team_families_backward, e.team_families))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    return e


@pytest.mark.parametrize("make", [_quad, _rocket, _tv],
                         ids=["box", "soc", "tv"])
def test_host_loop_launches_the_kernels(make, entries):
    """Cold then warm through the kernel launchers: a backward and a
    forward launch an iteration, each family's slack and dual passed when
    it is on, the stale forward kernel on a warm solve's first iteration
    only, x/u tracked on warm family solves only, the counters counted,
    and the loop stopped after the first check iteration whose flag reads
    0 (here ct 2: after iteration 1). The box problem's launches take the
    team entries (its stale launch reads the carried v), counted under
    backward_team / forward_team / forward_team_stale; those of the
    families at fixed rho the family team entries, counted under
    backward_team_families / forward_team_families /
    forward_team_families_stale."""
    p = make(max_iter=5, check_termination=2)
    spec = p.spec
    B = 3
    fam = admm_fused._families(spec)
    on = [bool(n) for n in fam for _ in range(2)]
    tables, x0, _, params = admm_stream._prepare(
        p, None, None, torch.zeros((B, spec.nx)))
    admm_stream._loop(tables, x0, None, spec, admm_stream._KERNELS,
                      **params)
    carry = admm_fused._carry_tensors(p, init_carry(p, B), B)
    entries.stale_v = carry.v.data_ptr()
    _, _, out = admm_stream._loop(tables, x0, carry, spec,
                                  admm_stream._KERNELS, **params)
    tracked = any(fam)
    assert entries.calls == [
        ("bwd", list(fam), on), ("fwd", 0, False, False, on),
        ("bwd", list(fam), on), ("fwd", 1, False, False, on),
        ("bwd", list(fam), on), ("fwd", 0, True, tracked, on),
        ("bwd", list(fam), on), ("fwd", 1, False, tracked, on)]
    team = "_team" if not any(fam) else "_team_families"
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0),
        **{f"backward{team}": 4, f"forward{team}": 3,
           f"forward{team}_stale": 1})
    for f in dataclasses.fields(carry):
        assert (getattr(out, f.name) is None) == \
            (getattr(carry, f.name) is None), f.name


def test_host_loop_runs_to_max_iter_while_a_lane_runs(entries):
    """With the flag set after every check, the loop runs max_iter
    iterations and no more."""
    entries.active = 1
    p = _quad(max_iter=7, check_termination=3)
    tables, x0, _, params = admm_stream._prepare(p, None, None,
                                                 torch.zeros((2, 12)))
    admm_stream._loop(tables, x0, None, p.spec, admm_stream._KERNELS,
                      **params)
    assert [c[1] for c in entries.calls if c[0] == "fwd"] == list(range(7))


def test_stream_source_is_built_with_the_others(tmp_path, monkeypatch):
    """csrc/admm_stream.cu is one of the sources the build compiles, and
    its library name follows each header it includes."""
    assert admm_stream.KERNEL in _build.SOURCES
    assert set(_build.SOURCES) == {p.stem for p in
                                   _build.CSRC_DIR.glob("*.cu")}
    src = (_build.CSRC_DIR / f"{admm_stream.KERNEL}.cu").read_text()
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    for header in ("admm_sweep.cuh", "admm_families.cuh"):
        assert f'#include "{header}"' in src
        before = _build.library_path(admm_stream.KERNEL)
        (tmp_path / header).write_text((tmp_path / header).read_text()
                                       + "\n// edited\n")
        assert _build.library_path(admm_stream.KERNEL) != before
