"""The fused solve with adaptive rho, cold and warm: its plain PyTorch
version (what ``solve_fused`` and ``solve_fused_warm`` run on CPU tensors,
and what the adaptive CUDA kernel is held against on the card) against the
JAX package's fused Pallas kernel in interpret mode at
tests/test_fused_adaptive.py's tolerances, ``adapted_cache``, the packed
tables, the launch glue against a stand-in for the C entry point, and the
combinations the kernel refuses.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the GPU."""
import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import adapted_cache as jax_adapted_cache
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy)
from tinympc_tpu_torch.kernels import (fused_supported, init_carry,
                                       shift_carry, solve_fused,
                                       solve_fused_reference,
                                       solve_fused_warm)
from tinympc_tpu_torch.kernels import admm_fused

torch.set_num_threads(1)

N = 10
B = 8
XREF = np.tile(np.asarray([0, 0, 0.5] + [0] * 9, np.float32), (N, 1))
# The guard's case starts from a rho far above adaptive_rho_max, so that its
# first prediction, clipped to 100, commits; from the tuned rho of 5 no lane
# drifts 3-fold within 40 iterations.
CASES = {"rho_tol_1": (5.0, 1.0, False), "rho_tol_3": (1000.0, 3.0, False),
         "apply_c": (5.0, 1.0, True)}


def _jax_problem(case, max_iter=40):
    """tests/test_fused_adaptive.py's float32 quadrotor (N=10, box, the
    Crazyflie tables) at the case's rho0, guard and apply_c."""
    rho, tol, apply_c = CASES[case]
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=N,
                    dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    prob = tm.with_sensitivities(prob,
                                 systems.crazyflie_sensitivity_tables())
    return tm.with_settings(prob, max_iter=max_iter, adaptive_rho=True,
                            adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c)


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _x0s(seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.2, 0.2, (B, 12)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def cold_runs():
    """One JAX interpret-mode cold solve per case, shared by the tests."""
    out = {}
    for case in CASES:
        pj = _jax_problem(case)
        x0 = _x0s(seed=1 if case == "apply_c" else 0)
        sol, res = jax_solve_fused(pj, jnp.asarray(XREF), None,
                                   jnp.asarray(x0), tile=B, interpret=True)
        out[case] = (pj, x0, sol, res)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_cold_matches_jax_fused_kernel(case, cold_runs):
    """The same float32 problem through both fused cold solves, B=8,
    max_iter 40: atol 5e-4 on x and u, final rho rtol 1e-3, counts within
    2 (tests/test_fused_adaptive.py's bar), and rho has moved."""
    pj, x0, sol_j, res_j = cold_runs[case]
    sol_t, res_t = solve_fused_reference(_port(pj), torch.as_tensor(XREF),
                                         None, torch.as_tensor(x0))
    assert res_t.shape == (5, B)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 2)
    rho0 = CASES[case][0]
    assert np.any(np.abs(res_t[4].numpy() - rho0) > 1e-3)


def test_adapted_cache_matches_jax(cold_runs):
    """adapted_cache rebuilds the per-problem cache from the final rho row,
    as the JAX package's does."""
    pj, _, _, res_j = cold_runs["apply_c"]
    pt = _port(pj)
    cj = jax_adapted_cache(pj, res_j[4])
    ct = admm_fused.adapted_cache(pt, torch.as_tensor(np.array(res_j[4])))
    for k in ("rho", "Kinf", "Pinf", "C1", "C2", "Quu_inv", "AmBKt"):
        got, want = getattr(ct, k).numpy(), np.asarray(getattr(cj, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_plain_cold_agrees_with_port_admm_solve():
    """The kernel-layout plain version against the port's telescoped
    admm.solve on the same float32 problem: the same operations, the
    matrix products summed in other orders, so equal counts and 1e-4."""
    pt = _port(_jax_problem("rho_tol_1"))
    x0 = torch.as_tensor(_x0s(seed=2))
    sol_f, res_f = solve_fused_reference(pt, torch.as_tensor(XREF), None, x0)
    sol_s, _, cache = tt.solve(pt, tt.init_state(pt, (B,)),
                               torch.as_tensor(XREF), None, x0)
    np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
    np.testing.assert_allclose(sol_f.x.numpy(), sol_s.x.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(res_f[4].numpy(), cache.rho.numpy(),
                               rtol=1e-5)


def test_plain_warm_matches_jax_warm_kernel():
    """A warm sequence of 4 solves with rho riding the carry, each package
    with its own carry (the JAX one handed across through convert), the
    plant stepped with the JAX solve's u0: atol 2e-3 on u, the carried rho
    rtol 5e-3, counts within 3 (tests/test_fused_adaptive.py:101-128)."""
    pj = _jax_problem("rho_tol_1", max_iter=25)
    pt = _port(pj)
    cj = jax_init_carry(pj, B)
    ct_ = carry_from_numpy(carry_to_numpy(cj), "cpu")
    assert ct_.rho.shape == (1, B)
    x = _x0s(seed=3)
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    for _ in range(4):
        sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(XREF), None,
                                            jnp.asarray(x), cj, tile=B,
                                            interpret=True)
        sol_t, res_t, ct_ = solve_fused_warm(pt, torch.as_tensor(XREF), None,
                                             torch.as_tensor(x), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=2e-3)
        np.testing.assert_allclose(ct_.rho.numpy(), np.asarray(cj.rho),
                                   rtol=5e-3)
        assert torch.equal(ct_.rho[0], res_t[4])
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 3)
        x = (x @ A.T + np.asarray(sol_j.u[0]) @ Bm.T).astype(np.float32)
    assert np.any(np.abs(ct_.rho.numpy() - 5.0) > 1e-3)


def test_carry_rho_starts_at_the_problems_and_passes_the_shift():
    pt = _port(_jax_problem("rho_tol_1"))
    c = init_carry(pt, 3)
    assert torch.equal(c.rho, torch.full((1, 3), 5.0))
    marked = c.replace(rho=torch.tensor([[1.0, 2.0, 3.0]]))
    assert torch.equal(shift_carry(marked).rho, marked.rho)
    fixed = tt.with_settings(pt, adaptive_rho=False)
    assert init_carry(fixed, 3).rho is None
    with pytest.raises(ValueError, match="carry fields"):
        solve_fused_warm(pt, None, None, torch.zeros((3, 12)),
                         init_carry(fixed, 3))


@pytest.mark.parametrize("apply_c", [False, True])
def test_adaptive_tables_follow_the_box_tables(apply_c):
    """The box prefix of the packed table is the fixed-rho table byte for
    byte; then A^T, Pinf, dKinf, dKinf^T, dPinf, dPinf^T and, under
    apply_c, dC1 and dC2, which unpack to the problem's matrices."""
    pt = _port(_jax_problem("apply_c" if apply_c else "rho_tol_1"))
    fixed = tt.with_settings(pt, adaptive_rho=False)
    full = admm_fused._pack_tables(pt, None, None)
    plain = admm_fused._pack_tables(fixed, None, None)
    assert torch.equal(full[:plain.numel()], plain)
    adapt = admm_fused._adaptive(pt.settings)
    t = admm_fused._unpack_tables(full, 12, 4, N, admm_fused.NO_FAMILIES,
                                  adapt)
    c = pt.cache
    want = dict(AT=pt.A.T, Pinf=c.Pinf, dK=c.dKinf_drho, dKT=c.dKinf_drho.T,
                dP=c.dPinf_drho, dPT=c.dPinf_drho.T)
    if apply_c:
        want.update(dC1=c.dC1_drho, dC2=c.dC2_drho)
    for k, v in want.items():
        assert torch.equal(t[k], v), k
    extra = sum(v.numel() for v in want.values())
    assert full.numel() == plain.numel() + extra
    assert t["dC1"].numel() == (16 if apply_c else 0)


@pytest.mark.parametrize("warm", [False, True])
def test_launch_passes_the_adaptive_arguments(warm, monkeypatch):
    """The launch glue, against a stand-in for the C entry point of
    csrc/admm_fused.cu: an adaptive solve passes its settings, the carried
    rho (warm only), the final-rho row and the scratch of the adaptation
    rows; a fixed-rho solve passes none. The new carry takes the final
    rho."""
    pt = _port(_jax_problem("rho_tol_3"))
    seen = []

    def entry(*args):
        assert len(args) == 27
        a = args[25]
        if a is None:
            seen.append(None)
            return 0
        a = a._obj
        seen.append((a.apply_c, a.clip, a.rho_min, a.rho_max, a.rho_tol,
                     a.rho_in is not None, a.rho_out is not None,
                     all(p is not None for p in (a.xs, a.us, a.axd))))
        return 0

    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    x0 = torch.zeros((3, 12))
    for prob in (pt, tt.with_settings(pt, adaptive_rho=False)):
        tables, x0c, params = admm_fused._prepare(prob, None, None, x0)
        if warm:
            carry = admm_fused._carry_tensors(prob, init_carry(prob, 3), 3)
            _, res, out = admm_fused._solve_kernel_warm(
                tables, x0c, carry, N, 12, 4, **params)
            assert (out.rho is None) == (params["adapt"] is None)
            if out.rho is not None:
                assert out.rho.shape == (1, 3)
        else:
            _, res = admm_fused._solve_kernel(tables, x0c, N, 12, 4,
                                              **params)
        assert res.shape == (4 if params["adapt"] is None else 5, 3)
    assert seen == [(0, 1, 1.0, 100.0, 3.0, warm, True, True), None]


def test_adaptive_outside_the_kernel_is_refused():
    """Adaptive rho with another constraint family or at an (nx, nu) the
    adaptive kernel is not instantiated for raises ValueError naming
    ROADMAP; so does an adaptive problem without its sensitivities."""
    pt = _port(_jax_problem("rho_tol_1"))
    assert fused_supported(pt)
    cones = tt.with_cones(pt, state_cones=[(0, 3, 0.25)])
    s = tt.systems.rocket_landing_20hz()
    rocket = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                      N=N, f=s["f"], device="cpu")
    rocket = tt.with_settings(tt.with_sensitivities(
        rocket, [np.zeros((3, 6)), np.zeros((6, 6)), np.zeros((3, 3)),
                 np.zeros((6, 6))]), adaptive_rho=True)
    for bad in (cones, rocket):
        assert not fused_supported(bad)
        with pytest.raises(ValueError, match="ROADMAP"):
            solve_fused(bad, None, None, torch.zeros((2, bad.spec.nx)))
    bare = pt.replace(cache=dataclasses.replace(
        pt.cache, dKinf_drho=None, dPinf_drho=None, dC1_drho=None,
        dC2_drho=None))
    assert not fused_supported(bare)
    with pytest.raises(ValueError, match="sensitivities"):
        solve_fused(bare, None, None, torch.zeros((2, 12)))
