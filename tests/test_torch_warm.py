"""The warm fused solve's plain PyTorch version (what ``solve_fused_warm``
runs on CPU tensors, and what the warm CUDA kernel is held against on the
card) against the JAX package's warm Pallas kernel in interpret mode and
against the port's own warm-started ``admm.solve`` sequence.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against this
plain version on the GPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import FusedCarry as JaxCarry
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy)
from tinympc_tpu_torch.kernels import (FusedCarry, init_carry, shift_carry,
                                       solve_fused_warm,
                                       solve_fused_warm_reference)

torch.set_num_threads(1)

N = 10
REF = [0, 0, 0.5, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def _jax_problem(max_iter, ct):
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, check_termination=ct)


def _port_problem(max_iter, ct):
    return problem_from_numpy(problem_to_numpy(_jax_problem(max_iter, ct)),
                              "cpu", torch.float32)


def _inputs(B, seed=0):
    x0 = np.random.default_rng(seed).uniform(-0.2, 0.2, (B, 12))
    return x0.astype(np.float32), np.tile(REF, (N, 1)).astype(np.float32)


def _plant(prob, x0, u0):
    """x+ = A x + B u0 + f in float32 numpy, the same on both sides."""
    A, Bm, f = (np.asarray(getattr(prob, k), np.float32)
                for k in ("A", "B", "f"))
    return (x0 @ A.T + u0 @ Bm.T + f).astype(np.float32)


@pytest.mark.parametrize("ct", [1, 5])
def test_plain_warm_matches_jax_warm_kernel(ct):
    """A warm external-plant sequence of 4 solves (B=8, max_iter 25) through
    both fused warm solves, each carrying its own carry. Bar of
    tests/test_torch_admm_fused.py: atol 1e-4 on u and on the carry's vnew,
    v, g and y (float32 sums in another order on each side, over up to 25
    iterations a solve), counts within 1, equal solved flags. ct=1 reaches
    iteration 0's dual residual against the carried v/z."""
    pj = _jax_problem(25, ct)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    B = 8
    x0, Xref = _inputs(B)
    cj, ct_ = jax_init_carry(pj, B), init_carry(pt, B)
    saw_mixed = False
    for _ in range(4):
        sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(Xref), None,
                                            jnp.asarray(x0), cj, tile=B,
                                            interpret=True)
        sol_t, _, ct_ = solve_fused_warm_reference(
            pt, torch.as_tensor(Xref), None, torch.as_tensor(x0), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=1e-4)
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 1)
        np.testing.assert_array_equal(sol_t.solved.numpy(),
                                      np.asarray(sol_j.solved))
        for k in ("vnew", "v", "g", "y"):
            np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                       np.asarray(getattr(cj, k)), rtol=0,
                                       atol=1e-4, err_msg=k)
        sv = sol_t.solved.numpy()
        saw_mixed |= sv.any() and not sv.all()
        x0 = _plant(pj, x0, np.asarray(sol_j.u[0]))
    assert saw_mixed, "the sequence must mix converged and max-iter lanes"


@pytest.mark.parametrize("ct", [1, 5])
def test_plain_warm_matches_port_admm_solve_sequence(ct):
    """The same warm sequence against a warm-started admm.solve sequence
    (the reference semantics the JAX test_fused_warm_matches_xla_sequence
    holds its kernel to): the same float32 operations in the same order on
    the CPU, only the layout differs, so exact counts and 1e-6."""
    pt = _port_problem(25, ct)
    B = 8
    x0, Xref = _inputs(B, seed=1)
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    state, carry = tt.init_state(pt, (B,)), init_carry(pt, B)
    saw_mixed = False
    for _ in range(4):
        sol_s, state, _ = tt.solve(pt, state, Xref, None, x0)
        sol_f, _, carry = solve_fused_warm_reference(pt, Xref, None, x0,
                                                     carry)
        np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
        np.testing.assert_array_equal(sol_f.solved.numpy(),
                                      sol_s.solved.numpy())
        np.testing.assert_allclose(sol_f.u.numpy(), sol_s.u.numpy(), rtol=0,
                                   atol=1e-6)
        for k in ("vnew", "znew", "g", "y", "v", "z"):
            np.testing.assert_allclose(
                getattr(carry, k).permute(0, 2, 1).numpy(),
                getattr(state, k).numpy(), rtol=0, atol=1e-6, err_msg=k)
        sv = sol_s.solved.numpy()
        saw_mixed |= sv.any() and not sv.all()
        x0 = x0 @ pt.A.T + state.u[0] @ pt.B.T + pt.f
    assert saw_mixed


def test_max_iter_zero_hands_the_carry_back_as_the_jax_kernel_does():
    """max_iter=0 is no no-op: no lane converged, so every lane is a
    max-iter lane -- vnew/znew/g/y come back unchanged and v/z come back as
    vnew/znew (admm_pallas.py:1259-1283). A random carry, compared exactly:
    no arithmetic runs."""
    pj = _jax_problem(0, 1)
    pt = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)
    B = 8
    x0, Xref = _inputs(B, seed=2)
    rng = np.random.default_rng(5)
    d = {k: rng.normal(size=a.shape).astype(np.float32)
         for k, a in carry_to_numpy(init_carry(pt, B)).items()}
    sol_j, res_j, cj = jax_solve_fused_warm(
        pj, jnp.asarray(Xref), None, jnp.asarray(x0),
        JaxCarry(**{k: jnp.asarray(v) for k, v in d.items()}), tile=B,
        interpret=True)
    sol_t, res_t, ct_ = solve_fused_warm_reference(
        pt, torch.as_tensor(Xref), None, torch.as_tensor(x0),
        carry_from_numpy(d, "cpu"))
    for k, v in carry_to_numpy(ct_).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(cj, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(ct_.v.numpy(), d["vnew"])
    np.testing.assert_array_equal(sol_t.x.numpy(), np.asarray(sol_j.x))
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    assert not sol_t.solved.any()


def test_solve_fused_warm_on_cpu_runs_the_plain_version_in_public_layout():
    pt = _port_problem(20, 5)
    B = 5
    x0, Xref = _inputs(B, seed=3)
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    c0 = init_carry(pt, B)
    sol, res, c1 = solve_fused_warm(pt, Xref, None, x0, c0)
    ref, ref_res, r1 = solve_fused_warm_reference(pt, Xref, None, x0, c0)
    assert sol.x.shape == (N, B, 12) and sol.u.shape == (N - 1, B, 4)
    assert sol.iter.shape == (B,) and sol.iter.dtype == torch.int32
    assert sol.solved.dtype == torch.bool and res.shape == (4, B)
    assert isinstance(c1, FusedCarry)
    for k in ("vnew", "g", "v"):
        assert getattr(c1, k).shape == (N, 12, B)
    for k in ("znew", "y", "z"):
        assert getattr(c1, k).shape == (N - 1, 4, B)
    assert all(getattr(c1, k).dtype == torch.float32
               for k in ("vnew", "znew", "g", "y", "v", "z"))
    for a, b in ((sol.x, ref.x), (sol.u, ref.u), (res, ref_res),
                 (sol.iter, ref.iter), (sol.solved, ref.solved),
                 (c1.vnew, r1.vnew), (c1.v, r1.v), (c1.g, r1.g)):
        assert torch.equal(a, b)
    # The input carry is not modified.
    assert not c0.g.any() and not c0.vnew.any()


def test_solve_fused_warm_checks_its_inputs():
    pt = _port_problem(20, 5)
    x0, Xref = _inputs(4)
    x0, Xref = torch.as_tensor(x0), torch.as_tensor(Xref)
    c = init_carry(pt, 4)
    with pytest.raises(ValueError, match="carry"):
        solve_fused_warm(pt, Xref, None, x0, None)
    with pytest.raises(ValueError, match="carry"):
        solve_fused_warm(pt, Xref, None, x0, None, final=True)
    # final=True, the mode of lane compaction, is accepted: the port keeps
    # no snapshots, so it hands over what final=False hands over.
    a = solve_fused_warm(pt, Xref, None, x0, c, final=True)
    b = solve_fused_warm(pt, Xref, None, x0, c)
    assert all(torch.equal(getattr(a[0], k), getattr(b[0], k))
               for k in ("x", "u", "iter", "solved"))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2].v, b[2].v)
    with pytest.raises(ValueError):
        solve_fused_warm(pt, Xref, None, x0, init_carry(pt, 3))
    soc = pt.replace(spec=dataclasses.replace(
        pt.spec, en_state_soc=True, state_cones=((0, 3),)))
    with pytest.raises(ValueError):
        solve_fused_warm(soc, Xref, None, x0, c)


def test_shift_carry_semantics():
    """Rows roll by one with the last repeated, on every field
    (tests/test_closed_loop_fused.py:119-144)."""
    pt = _port_problem(5, 1)
    c = init_carry(pt, 3)
    marked = c.replace(**{
        k: torch.arange(getattr(c, k).numel(), dtype=torch.float32)
        .reshape(getattr(c, k).shape) for k in ("vnew", "znew", "g", "y",
                                                 "v", "z")})
    sh = shift_carry(marked)
    for k in ("vnew", "znew", "g", "y", "v", "z"):
        a, b = getattr(marked, k), getattr(sh, k)
        assert torch.equal(b[:-1], a[1:]) and torch.equal(b[-1], a[-1])
