"""Scenario-tree consensus on the streamed solve: the plain versions of the
backward and forward kernels' consensus instantiations (what
``solve_fused_streamed(_warm)`` runs on CPU tensors, and what
csrc/admm_stream.cu's CONS kernels are held against on the card), float32,
against the JAX package's streamed kernel in interpret mode and its XLA
path on tests/test_stream_kernel.py:219-300's cases and at their
tolerances: cold x and u within 2e-4 and counts within 1; warm u within
5e-4, counts within 2 and the carried yc0 within 5e-4 of the XLA state.
Then bitwise against the port's resident consensus plain version, the rule
for a converged lane's standing offer, the launch glue against stand-ins
for the C entry points, and the refusals. The CUDA kernels themselves run
only on the card: chip_smoke.py holds them there against their plain
version and, bitwise, against the resident consensus kernel."""
import contextlib
import ctypes
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused_streamed as jax_streamed
from tinympc_tpu.kernels import solve_fused_streamed_warm as jax_streamed_warm

from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (admm_fused, admm_stream, init_carry,
                                       solve_fused, solve_fused_streamed,
                                       solve_fused_streamed_warm,
                                       solve_fused_warm, stream_supported)

torch.set_num_threads(1)


def _jax_problem(N, max_iter, rho_c=None, **settings):
    """tests/test_stream_kernel.py:_problem with consensus: the float32
    quadrotor, box +-5 / +-0.5."""
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    prob = tm.with_settings(prob, max_iter=max_iter, **settings)
    return tm.with_consensus(prob, rho_c=rho_c)


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _xref(N):
    return np.tile(np.asarray([0, 0, 0.5] + [0.0] * 9, np.float32), (N, 1))


def test_plain_cold_matches_jax_streamed_kernel_and_xla():
    """tests/test_stream_kernel.py:219-246: 2 groups of 4 at N=16,
    max_iter 80, the default rho_c; against the JAX streamed kernel in
    interpret mode and the XLA path: x and u within 2e-4, counts within 1;
    each solved group's u[0] spread below 2e-3."""
    ng, G, N = 2, 4, 16
    pj = _jax_problem(N, 80)
    x0 = np.random.default_rng(7).uniform(-0.3, 0.3, (ng, G, 12)).astype(
        np.float32)
    Xref = _xref(N)
    sol, res = solve_fused_streamed(_port(pj), torch.as_tensor(Xref), None,
                                    torch.as_tensor(x0))
    assert sol.x.shape == (N, ng, G, 12) and res.shape == (4, ng, G)
    sol_k, _ = jax_streamed(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                            tile=ng * G, chunk=8, interpret=True)
    sol_x, _, _ = tm.solve(pj, tm.init_state(pj, (ng, G)),
                           Xref=jnp.asarray(Xref), x0=jnp.asarray(x0))
    for ref in (sol_k, sol_x):
        np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x),
                                   atol=2e-4)
        np.testing.assert_allclose(sol.u.numpy(), np.asarray(ref.u),
                                   atol=2e-4)
        assert np.all(np.abs(sol.iter.numpy() - np.asarray(ref.iter)) <= 1)
    u0 = sol.u[0].numpy()
    for gi in range(ng):
        if sol.solved[gi].all():
            assert np.ptp(u0[gi], axis=0).max() < 2e-3


def test_plain_warm_sequence_matches_jax():
    """tests/test_stream_kernel.py:269-300: 2 groups of 4, N=16, max_iter
    40, rho_c 50, three warm solves of a plant stepped with the XLA path's
    u[0]: u within 5e-4 of the JAX streamed kernel's and of the XLA
    path's, counts within 2, the carried yc0 within 5e-4 of the XLA
    state's."""
    ng, G, N = 2, 4, 16
    pj = _jax_problem(N, 40, rho_c=50.0)
    prob = _port(pj)
    x0 = np.random.default_rng(5).uniform(-0.3, 0.3, (ng, G, 12)).astype(
        np.float32)
    Xref = _xref(N)
    state = tm.init_state(pj, (ng, G))
    c_j, c = jax_init_carry(pj, ng * G), init_carry(prob, ng * G)
    assert c.zc0 is not None and c.u is not None
    for t in range(3):
        sol_r, state, _ = tm.solve(pj, state, Xref=jnp.asarray(Xref),
                                   x0=jnp.asarray(x0))
        sol_j, _, c_j = jax_streamed_warm(pj, jnp.asarray(Xref), None,
                                          jnp.asarray(x0), c_j, tile=ng * G,
                                          chunk=4, interpret=True)
        sol, _, c = solve_fused_streamed_warm(prob, torch.as_tensor(Xref),
                                              None, torch.as_tensor(x0), c)
        for ref in (sol_j, sol_r):
            np.testing.assert_allclose(sol.u.numpy(), np.asarray(ref.u),
                                       atol=5e-4, err_msg=f"step {t}")
            assert np.all(np.abs(sol.iter.numpy() - np.asarray(ref.iter))
                          <= 2), t
        np.testing.assert_allclose(c.yc0.numpy().T.reshape(ng, G, -1),
                                   np.asarray(state.yc0), atol=5e-4)
        u0 = np.asarray(state.u[0])
        x0 = (np.einsum("ij,...j->...i", np.asarray(pj.A), x0)
              + np.einsum("ij,...j->...i", np.asarray(pj.B), u0)
              + np.asarray(pj.f)).astype(np.float32)


def _staggered():
    """tests/test_compact.py:338-417's workload: 8 groups of 4 whose
    difficulty is staggered, so lanes converge at different iterations."""
    rng = np.random.default_rng(7)
    scales = np.asarray([0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12,
                         0.2])[:, None, None]
    return torch.as_tensor((rng.uniform(-1, 1, (8, 4, 12)) * scales),
                           dtype=torch.float32)


def _rocket():
    """The rocket's cones (bench_all.py:199-222) with consensus, at (6, 3):
    4 groups of 4."""
    s = systems.rocket_landing_20hz()
    N = 10
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  f=s["f"], dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=np.tile([-5.0, -5, -0.5, -10, -10, -20],
                                          (N, 1)),
                        x_max=np.tile([5.0, 5, 100, 10, 10, 20], (N, 1)),
                        u_min=-10.0, u_max=105.0)
    pj = tm.with_cones(pj, state_cones=[(0, 3, 0.25)],
                       input_cones=[(0, 3, 0.5)])
    pj = tm.with_consensus(tm.with_settings(pj, max_iter=40,
                                            abs_pri_tol=2e-3), rho_c=100.0)
    rng = np.random.default_rng(1)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x0 = xinit * (1 + 0.1 * rng.uniform(-1, 1, (4, 4, 6)))
    Xref = xinit * (1 - np.arange(N)[:, None] / 99.0)
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return _port(pj), f32(x0), f32(Xref), f32(Uref)


def _assert_same(a, b):
    for k in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(a[0], k), getattr(b[0], k)), k
    assert torch.equal(a[1], b[1])
    if len(a) > 2:
        for f in dataclasses.fields(a[2]):
            if getattr(a[2], f.name) is not None:
                assert torch.equal(getattr(a[2], f.name),
                                   getattr(b[2], f.name)), f.name


@pytest.mark.parametrize("case", ["quadrotor ct 1", "quadrotor ct 5",
                                  "rocket"])
def test_plain_equals_resident_plain_bitwise(case):
    """Cold and then three warm solves of a plant stepped with u[0]: the
    streamed plain solve is bitwise the resident consensus plain solve
    (x, u, counts, flags, residuals, every carry field), on the staggered
    batch, where lanes of a group converge at different iterations, and on
    the rocket's cones with consensus at (6, 3)."""
    if case == "rocket":
        prob, x, Xref, Uref = _rocket()
    else:
        pj = _jax_problem(10, 120, rho_c=50.0, abs_pri_tol=2e-2,
                          abs_dua_tol=2e-2,
                          check_termination=int(case[-1]))
        prob, x, Xref, Uref = _port(pj), _staggered(), None, None
    s = solve_fused_streamed(prob, Xref, Uref, x)
    _assert_same(s, solve_fused(prob, Xref, Uref, x))
    it = s[0].iter
    assert case == "rocket" or (it.amin(dim=1) < it.amax(dim=1)).any()
    ng, G, nx = x.shape
    c_s = c_r = init_carry(prob, ng * G)
    for _ in range(3):
        s = solve_fused_streamed_warm(prob, Xref, Uref, x, c_s)
        r = solve_fused_warm(prob, Xref, Uref, x, c_r)
        _assert_same(s, r)
        c_s, c_r = s[2], r[2]
        u0 = s[0].u[0].reshape(ng * G, -1)
        x = (x.reshape(ng * G, nx) @ prob.A.T + u0 @ prob.B.T
             + prob.f).reshape(ng, G, nx)


def test_a_done_lane_keeps_its_offer_and_state():
    """Forward launches of the plain version with one lane of a group
    done: that lane's iterates, slack, dual and standing offer are left as
    they were and the group mean still reads its offer; the running lanes
    move, but store their offers only on the iteration they converge."""
    pj = _jax_problem(10, 5, rho_c=50.0)
    prob = _port(pj)
    x0 = _staggered()[:2]
    tables, x, _, params = admm_stream._prepare(prob, None, None, x0)
    cons, B = params["cons"], 8
    s = admm_stream._init(x, 10, 12, 4, None, params["fam"], cons)
    run = admm_stream._PLAIN(tables, x, s, None, 10, 12, 4,
                             **{k: v for k, v in params.items()
                                if k != "max_iter"})
    for it in range(2):
        run.backward(1 - it % 2)
        run.forward(it, False)
    s["done"][1] = True
    s["offer"][:, 1] = torch.tensor([0.25, -0.125, 0.0625, 0.5])
    before = {k: s[k].clone() for k in ("zc0", "yc0", "offer", "g", "y")}
    run.backward(0)
    run.forward(2, False)
    assert s["done"].tolist() == [False, True] + [False] * 6
    for k, a in before.items():
        assert torch.equal(s[k][..., 1], a[..., 1]), k
        if k in ("zc0", "yc0"):
            assert not torch.equal(s[k][..., 0], a[..., 0]), k
    assert s["iters"][1] == 2 and s["iters"][0] == 3
    assert torch.equal(s["offer"], before["offer"])
    # Tolerances no lane misses: every running lane converges and stores
    # the offer the group mean read, beside lane 1's standing one.
    run.params.update(tol_pri=float("inf"), tol_dua=float("inf"))
    run.backward(1)
    run.forward(3, False)
    assert bool(s["done"].all())
    assert torch.equal(s["offer"][:, 1], before["offer"][:, 1])
    assert not torch.equal(s["offer"][:, 0], before["offer"][:, 0])
    mean = sum(s["offer"][:, j] for j in range(4)) / 4
    assert torch.equal(s["zc0"][:, 0], mean)


class _Entries:
    """Stand-ins for tinympc_stream_backward / tinympc_stream_forward: they
    record the consensus arguments each launch is given and write
    nothing; the forward launch of a check iteration leaves 0 in the
    flag."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _cons(arg):
        if arg is None:
            return None
        c = ctypes.cast(arg, ctypes.POINTER(admm_stream._StreamConsensus))[0]
        return (c.group, round(c.rho_c, 3),
                all(p is not None for p in (c.zc0, c.yc0, c.offer)))

    def backward(self, *args):
        assert len(args) == 18 and args[16] is None   # no adaptive rho
        self.calls.append(("bwd", self._cons(args[15])))
        return 0

    def forward(self, *args):
        assert len(args) == 29 and args[27] is None   # no adaptive rho
        it, ct, x_out = args[5], args[6], args[24]
        self.calls.append(("fwd", it, bool(args[0]), x_out is not None,
                           self._cons(args[26])))
        if (it + 1) % ct == 0:
            ctypes.c_int.from_address(args[22]).value = 0
        return 0


def test_host_loop_launches_the_consensus_kernels(monkeypatch):
    """Cold then warm through the one-thread kernel launchers
    (``_KERNELS(..., team=False)``: the in-process A/B, and the route of a
    group whose cluster cannot be formed; the team consensus entries have
    tests/test_torch_stream_team_consensus.py) on a consensus problem:
    every launch gets the group size, rho_c and the three lane arrays, the
    warm solve tracks x/u, the consensus counters count (the others stay
    at 0), and the carry hands over zc0 / yc0 and x/u."""
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (e.backward, e.forward))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    prob = _port(_jax_problem(10, 5, rho_c=50.0, check_termination=2))
    x0 = torch.zeros((2, 4, 12))
    tables, x, _, params = admm_stream._prepare(prob, None, None, x0)
    one = functools.partial(admm_stream._KERNELS, team=False)
    admm_stream._loop(tables, x, None, prob.spec, one, **params)
    carry = admm_fused._carry_tensors(prob, init_carry(prob, 8), 8)
    _, _, out = admm_stream._loop(tables, x, carry, prob.spec, one,
                                  **params)
    cons = (4, 50.0, True)
    assert e.calls == [("bwd", cons), ("fwd", 0, False, False, cons),
                       ("bwd", cons), ("fwd", 1, False, False, cons),
                       ("bwd", cons), ("fwd", 0, True, True, cons),
                       ("bwd", cons), ("fwd", 1, False, True, cons)]
    assert admm_stream.launch_counts == {
        "backward": 0, "forward": 0, "forward_stale": 0,
        "backward_consensus": 4, "forward_consensus": 3,
        "forward_consensus_stale": 1, "backward_adaptive": 0,
        "forward_adaptive": 0, "forward_adaptive_stale": 0,
        "backward_team": 0, "forward_team": 0, "forward_team_stale": 0,
        "backward_team_adaptive": 0, "forward_team_adaptive": 0,
        "forward_team_adaptive_stale": 0, "backward_team_families": 0,
        "forward_team_families": 0, "forward_team_families_stale": 0,
        "backward_team_consensus": 0, "forward_team_consensus": 0,
        "forward_team_consensus_stale": 0}
    for name in ("zc0", "yc0", "x", "u"):
        assert getattr(out, name) is not None, name


def test_refusals_and_support():
    """A consensus problem is streamed-supported; a group that is not a
    power of two or passes the 128-lane block, a flat x0s and adaptive
    rho (which neither package runs with consensus) are refused."""
    prob = _port(_jax_problem(10, 5))
    assert stream_supported(prob)
    for shape in ((2, 3, 12), (1, 256, 12)):
        with pytest.raises(ValueError, match="power of two"):
            solve_fused_streamed(prob, None, None, torch.zeros(shape))
    with pytest.raises(ValueError, match="n_groups"):
        solve_fused_streamed(prob, None, None, torch.zeros((8, 12)))
    adaptive = prob.replace(settings=dataclasses.replace(
        prob.settings, adaptive_rho=True))
    assert not stream_supported(adaptive)
    with pytest.raises(ValueError, match="adaptive_rho"):
        solve_fused_streamed(adaptive, None, None, torch.zeros((2, 4, 12)))

