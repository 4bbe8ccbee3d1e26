"""The streamed long-horizon solve with adaptive rho: its plain PyTorch
versions (what ``solve_fused_streamed`` and ``solve_fused_streamed_warm``
run on CPU tensors, and what the adaptive instantiations of
csrc/admm_stream.cu are held against on the card) against the JAX package's
streamed Pallas kernels in interpret mode, and bitwise against the port's
resident plain version, as tests/test_stream_kernel.py:304-435 holds the
JAX pair; compaction's streamed backend on an adaptive problem, bitwise
against the resident one; and the launch glue of the adaptive kernels
against stand-ins for their C entry points.

The CUDA kernels cannot run here; chip_smoke.py holds them against these
plain versions and against the resident kernel on the GPU."""
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

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy)
from tinympc_tpu_torch.kernels import (admm_fused, admm_stream,
                                       init_carry, make_compact_solver,
                                       solve_fused_reference,
                                       solve_fused_streamed,
                                       solve_fused_streamed_warm,
                                       solve_fused_warm_reference,
                                       stream_supported)

torch.set_num_threads(1)

N = 16
B = 8
XINIT = np.array([4, 2, 20, -3, 2, -4.5])
# case: (system, families, rho0, adaptive_rho_tolerance, apply_c), the
# problems of tests/test_stream_kernel.py:257-265 (the quadrotor's box, the
# Crazyflie tables) and the rocket's cones. The guard starts from a rho far
# above adaptive_rho_max, so that its first prediction, clipped to 100,
# commits; its sensitivities are those of its rho (the Crazyflie tables are
# rho 5's, whose Taylor update diverges that far away).
CASES = {"box": ("quad", "box", None, 1.0, False),
         "box_apply_c": ("quad", "box", None, 1.0, True),
         "guard": ("quad", "box", 1000.0, 3.0, False),
         "soc": ("rocket", "soc", None, 1.0, False),
         "tv": ("quad", "tv", None, 1.0, False)}


@functools.lru_cache(maxsize=None)
def _jax_problem(case, max_iter=40):
    system, fam, rho, tol, apply_c = CASES[case]
    extra = {}
    if system == "rocket":
        s = systems.rocket_landing_20hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"],
                        rho=rho or s["rho"], N=N, f=s["f"],
                        dtype=jnp.float32)
        prob = tm.with_bounds(
            prob, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        prob = tm.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
        # The rocket's rho of 1 is adaptive_rho_min's default, and its
        # predictions fall below it: a lower floor lets rho move.
        extra = dict(abs_pri_tol=2e-3, adaptive_rho_min=0.05)
        return tm.with_settings(prob, max_iter=max_iter, adaptive_rho=True,
                                adaptive_rho_tolerance=tol,
                                adaptive_rho_apply_c=apply_c, **extra)
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"],
                    rho=rho or s["rho"], N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    if fam == "tv":
        a = np.zeros(12)
        a[2] = 1.0
        prob = tm.with_tv_linear_constraints(
            prob, tv_Alin_x=np.tile(a, (N, 1, 1)),
            tv_blin_x=np.linspace(0.6, 0.3, N)[:, None])
    if rho is None:
        prob = tm.with_sensitivities(prob,
                                     systems.crazyflie_sensitivity_tables())
    return tm.with_settings(prob, max_iter=max_iter, adaptive_rho=True,
                            adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c)


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _inputs(case, seed, batch=B):
    """x0s (B, nx), Xref, Uref as float32 numpy."""
    rng = np.random.default_rng(seed)
    if CASES[case][0] == "rocket":
        x0 = XINIT * rng.uniform(0.9, 1.1, (batch, 1))
        Xref = np.linspace(XINIT, np.zeros(6), N)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
    else:
        x0 = rng.uniform(-0.4, 0.4, (batch, 12))
        Xref = np.tile([0, 0, 0.5] + [0.0] * 9, (N, 1))
        Uref = None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(x0), f32(Xref), f32(Uref)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _same(a, b):
    """Two solves, bitwise: x, u, counts, flags, residuals (the final rho
    row included) and, warm, every carry field."""
    assert all(torch.equal(getattr(a[0], k), getattr(b[0], k))
               for k in ("x", "u", "iter", "solved"))
    assert torch.equal(a[1], b[1])
    if len(a) > 2:
        for f in dataclasses.fields(a[2]):
            x, y = getattr(a[2], f.name), getattr(b[2], f.name)
            assert (x is None and y is None) or torch.equal(x, y), f.name


@pytest.mark.parametrize("case", ["box", "box_apply_c", "guard", "soc"])
def test_plain_cold_matches_jax_streamed_kernel(case):
    """The same float32 problem through both streamed cold solves (the JAX
    one in chunks of 4 rows), B=8, N=16, max_iter 40: atol 5e-4 on x and u
    (relative on the rocket's thrust), final rho rtol 1e-3, counts within
    2 (tests/test_fused_adaptive.py's bar); rho has moved."""
    pj = _jax_problem(case)
    pt = _port(pj)
    assert stream_supported(pt)
    x0, Xref, Uref = _inputs(case, seed=3)
    sol_j, res_j = jax_streamed(pj, _j(Xref), _j(Uref), _j(x0), tile=B,
                                chunk=4, interpret=True)
    sol_t, res_t = solve_fused_streamed(pt, _t(Xref), _t(Uref), _t(x0))
    assert res_t.shape == (5, B) and bool(torch.isfinite(sol_t.x).all())
    for got, want in ((sol_t.x, sol_j.x), (sol_t.u, sol_j.u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-6,
                                   atol=5e-4)
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    assert np.any(np.abs(res_t[4].numpy() - float(pt.cache.rho)) > 1e-3)


def test_plain_warm_sequence_matches_jax_streamed_kernel():
    """A warm sequence of 3 streamed solves (max_iter 25) with rho riding
    the carry, each package with its own carry (the JAX one converted at
    the start), the plant stepped with the JAX solve's u0: atol 2e-3 on u,
    the carried rho rtol 5e-3, counts within 3
    (tests/test_fused_adaptive.py:101-128)."""
    pj = _jax_problem("box", max_iter=25)
    pt = _port(pj)
    cj = jax_init_carry(pj, B)
    ct_ = carry_from_numpy(carry_to_numpy(cj), "cpu")
    x0, Xref, _ = _inputs("box", seed=5)
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    for _ in range(3):
        sol_j, _, cj = jax_streamed_warm(pj, _j(Xref), None, _j(x0), cj,
                                         tile=B, chunk=4, interpret=True)
        sol_t, res_t, ct_ = solve_fused_streamed_warm(pt, _t(Xref), None,
                                                      _t(x0), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=2e-3)
        np.testing.assert_allclose(ct_.rho.numpy(), np.asarray(cj.rho),
                                   rtol=5e-3)
        assert torch.equal(ct_.rho[0], res_t[4])
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 3)
        x0 = (x0 @ A.T + np.asarray(sol_j.u[0]) @ Bm.T).astype(np.float32)
    assert np.any(np.abs(ct_.rho.numpy() - float(pt.cache.rho)) > 1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_resident_plain_bitwise(case):
    """The streamed plain version runs the resident plain version's
    arithmetic launch by launch: cold, then 3 warm solves with each one's
    carry handed on (rho, the family duals and x/u among it), bitwise;
    max_iter 1 and 6 (one adaptation) too."""
    pt = _port(_jax_problem(case))
    x0, Xref, Uref = (_t(a) for a in _inputs(case, seed=7))
    for mi in (1, 6):
        short = tt.with_settings(pt, max_iter=mi)
        _same(solve_fused_streamed(short, Xref, Uref, x0),
              solve_fused_reference(short, Xref, Uref, x0))
    _same(solve_fused_streamed(pt, Xref, Uref, x0),
          solve_fused_reference(pt, Xref, Uref, x0))
    c_s = c_r = init_carry(pt, B)
    x = x0
    for _ in range(3):
        out_s = solve_fused_streamed_warm(pt, Xref, Uref, x, c_s)
        out_r = solve_fused_warm_reference(pt, Xref, Uref, x, c_r)
        _same(out_s, out_r)
        c_s, c_r = out_s[2], out_r[2]
        x = x @ pt.A.T + out_r[0].u[0] @ pt.B.T + pt.f
    assert not torch.equal(c_s.rho, init_carry(pt, B).rho)


def test_carry_passes_between_resident_and_streamed():
    """A carry of either solve serves the other: resident then streamed
    equals streamed then streamed, bitwise."""
    pt = _port(_jax_problem("box_apply_c", max_iter=12))
    x0, Xref, _ = (_t(a) for a in _inputs("box", seed=9))
    c0 = init_carry(pt, B)
    _, _, c_r = solve_fused_warm_reference(pt, Xref, None, x0, c0)
    _, _, c_s = solve_fused_streamed_warm(pt, Xref, None, x0, c0)
    _same(solve_fused_streamed_warm(pt, Xref, None, x0, c_r),
          solve_fused_streamed_warm(pt, Xref, None, x0, c_s))


def test_streamed_compaction_equals_resident_compaction():
    """Compaction with backend="streamed" on an adaptive problem: each
    phase a warm streamed solve with rho riding the carry, bitwise the
    resident backend's phases (the phases run the plain versions here);
    "auto" picks the resident one at this horizon. The guard's lanes
    converge from iteration 11 on, one not within 40."""
    pt = _port(_jax_problem("guard", max_iter=40))
    x0 = _t(_inputs("guard", seed=7, batch=12)[0])
    Xref = _t(_inputs("guard", seed=7)[1])
    outs = [make_compact_solver(pt, chunk=[10, 15], min_batch=2,
                                backend=backend)(x0, Xref)
            for backend in ("streamed", "resident", "auto")]
    sol = outs[0][0]
    assert outs[0][1].shape == (5, 12)
    assert sol.solved.any() and not sol.solved.all()
    _same(outs[0], outs[1])
    _same(outs[2], outs[1])


class _Entries:
    """Stand-ins for tinympc_stream_backward / tinympc_stream_forward on an
    adaptive problem: they record the adaptive-rho arguments each launch is
    given and write nothing but the flag."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _adapt(arg):
        a = ctypes.cast(arg, ctypes.POINTER(admm_fused._AdaptArgs))[0]
        return (a.apply_c, a.clip, round(a.rho_tol, 3),
                a.rho_in is not None and a.rho_in == a.rho_out,
                all(p is not None for p in (a.xs, a.us, a.axd, a.rho_v)))

    def backward(self, *args):
        assert len(args) == 18 and args[15] is None   # no consensus
        self.calls.append(("bwd", self._adapt(args[16])))
        return 0

    def forward(self, *args):
        assert len(args) == 29 and args[26] is None   # no consensus
        it, ct = args[5], args[6]
        self.calls.append(("fwd", it, bool(args[0]), self._adapt(args[27])))
        if (it + 1) % ct == 0:
            ctypes.c_int.from_address(args[22]).value = 0
        return 0


def test_host_loop_launches_the_adaptive_kernels(monkeypatch):
    """Cold then warm through the kernel launchers on an adaptive problem
    with a family (the guard's settings on the time-varying hyperplane;
    an adaptive box problem takes the team entries,
    tests/test_torch_stream_team_backward.py): every launch gets the
    settings, each lane's rho (read and written in place), its virtual
    rho and the scratch of an adaptation iteration; the stale forward runs
    on the warm solve's first iteration; the adaptive counters count; the
    residuals gain the rho row and the carry the rho."""
    e = _Entries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (e.backward, e.forward))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    pt = tt.with_settings(_port(_jax_problem("tv")), max_iter=4,
                          check_termination=2, adaptive_rho_apply_c=True,
                          adaptive_rho_tolerance=3.0)
    tables, x0, _, params = admm_stream._prepare(pt, None, None,
                                                 torch.zeros((3, 12)))
    _, res = admm_stream._loop(tables, x0, None, pt.spec,
                               admm_stream._KERNELS, **params)[:2]
    assert res.shape == (5, 3) and torch.equal(
        res[4], torch.full((3,), float(pt.cache.rho)))
    carry = admm_fused._carry_tensors(pt, init_carry(pt, 3), 3)
    out = admm_stream._loop(tables, x0, carry, pt.spec,
                            admm_stream._KERNELS, **params)[2]
    assert out.rho.shape == (1, 3)
    a = (1, 1, 3.0, True, True)
    assert e.calls == [("bwd", a), ("fwd", 0, False, a),
                       ("bwd", a), ("fwd", 1, False, a),
                       ("bwd", a), ("fwd", 0, True, a),
                       ("bwd", a), ("fwd", 1, False, a)]
    assert admm_stream.launch_counts == dict(
        dict.fromkeys(admm_stream.launch_counts, 0), backward_adaptive=4,
        forward_adaptive=3, forward_adaptive_stale=1)


def test_every_family_is_stream_supported_with_adaptive_rho():
    """stream_supported with adaptive rho: every family mix at (12, 4) and
    (6, 3), the box-only rocket too; not without the sensitivities, nor at
    an (nx, nu) that is not instantiated."""
    for case in CASES:
        assert stream_supported(_port(_jax_problem(case)))
    rocket = _port(_jax_problem("soc"))
    box = rocket.replace(spec=dataclasses.replace(
        rocket.spec, state_cones=(), input_cones=()))
    assert stream_supported(box)
    bare = rocket.replace(cache=dataclasses.replace(
        rocket.cache, dKinf_drho=None, dPinf_drho=None, dC1_drho=None,
        dC2_drho=None))
    assert not stream_supported(bare)
    with pytest.raises(ValueError, match="sensitivities"):
        solve_fused_streamed(bare, None, None, torch.zeros((2, 6)))
    s = tt.systems.synthetic(5, 2)       # (nx, nu) = (5, 2): not built
    odd = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                   N=N, device="cpu")
    odd = tt.with_settings(tt.with_sensitivities(
        odd, [np.zeros((2, 5)), np.zeros((5, 5)), np.zeros((2, 2)),
              np.zeros((5, 5))]), adaptive_rho=True)
    assert not stream_supported(odd)
    with pytest.raises(ValueError, match="ROADMAP"):
        solve_fused_streamed(odd, None, None, torch.zeros((2, 5)))
