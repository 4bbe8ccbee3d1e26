"""The fused solve with scenario-tree consensus, cold and warm: its plain
PyTorch version (what ``solve_fused`` and ``solve_fused_warm`` run on CPU
tensors, and what the consensus variant of the CUDA kernel is held against
on the card), float32, against the JAX package's fused Pallas kernel in
interpret mode and its XLA path, on tests/test_fused_kernel.py:246-330's
cases and at its tolerances: cold x and u within 2e-4 and counts within 1;
warm u within 5e-4, counts within 2 and the carry's zc0 / yc0 within 5e-4
of the XLA state; each solved group's u[0] spread below
2 abs_pri_tol + 1e-5. Then the rule for a converged lane's offer, the
launch glue against a stand-in C entry, the tables, and the refusals.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the GPU."""
import contextlib
import ctypes
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (admm_fused, fused_supported,
                                       init_carry, shift_carry, solve_fused,
                                       solve_fused_reference,
                                       solve_fused_warm,
                                       solve_fused_warm_reference)

torch.set_num_threads(1)

N = 10
XREF = np.tile(np.asarray([0, 0, 0.5] + [0.0] * 9, np.float32), (N, 1))


def _jax_problem(max_iter, rho_c=None):
    """tests/test_fused_kernel.py:_consensus_case's float32 quadrotor:
    N=10, box +-5 / +-0.5, consensus at rho_c."""
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tm.with_consensus(tm.with_settings(prob, max_iter=max_iter),
                             rho_c=rho_c)


def _port(pj, dtype=torch.float32):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", dtype)


def _x0s(ng, G, seed=7):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (ng, G, 12)) \
        .astype(np.float32)


def _spread_bar(sol, prob):
    """Each group whose lanes all converged has its u[0] within
    2 abs_pri_tol + 1e-5 (tests/test_fused_kernel.py:262-268)."""
    u0 = sol.u[0].numpy()
    spread = np.ptp(u0, axis=1).max(-1)
    done = sol.solved.numpy().all(axis=1)
    assert np.all(spread[done] < 2 * prob.settings.abs_pri_tol + 1e-5)


@pytest.mark.parametrize("ng,G,max_iter,rho_c", [
    (2, 4, 60, None), (1, 8, 60, None), (2, 2, 500, 100.0)])
def test_plain_cold_matches_jax_kernel_and_xla(ng, G, max_iter, rho_c):
    """tests/test_fused_kernel.py:271-289: the same float32 problem through
    the JAX XLA path, the JAX kernel in interpret mode and the port's plain
    fused version, x0s (n_groups, G, nx). Against both: x and u within
    2e-4, counts within 1, and the solved groups' spread. At rho_c 100 the
    counts sit on float32 ties (a float64 solve counts 443 / 443 / 442 /
    442 where all three float32 paths count 441 or 442), so the witness
    that the port's differences are rounding: it is no further from the
    float64 solve than the JAX kernel is, less 1e-5."""
    pj = _jax_problem(max_iter, rho_c)
    pt = _port(pj)
    x0 = _x0s(ng, G)
    sol_r = tm.solve(pj, tm.init_state(pj, (ng, G)), Xref=jnp.asarray(XREF),
                     x0=jnp.asarray(x0))[0]
    sol_j, res_j = jax_solve_fused(pj, jnp.asarray(XREF), None,
                                   jnp.asarray(x0), tile=ng * G,
                                   interpret=True)
    sol_t, res_t = solve_fused_reference(pt, torch.as_tensor(XREF), None,
                                         torch.as_tensor(x0))
    assert sol_t.x.shape == (N, ng, G, 12) and sol_t.u.shape == (N - 1, ng,
                                                                  G, 4)
    assert sol_t.iter.shape == (ng, G) and res_t.shape == (4, ng, G)
    for ref in (sol_r, sol_j):
        np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(ref.x),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(ref.u),
                                   rtol=0, atol=2e-4)
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(ref.iter)) <= 1)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=0,
                               atol=2e-4)
    _spread_bar(sol_t, pt)
    p64 = _port(pj, torch.float64)
    x64 = tt.solve(p64, tt.init_state(p64, (ng, G)),
                   torch.as_tensor(XREF, dtype=torch.float64), None,
                   torch.as_tensor(x0, dtype=torch.float64))[0].x.numpy()
    assert np.abs(sol_t.x.numpy() - x64).max() \
        <= np.abs(np.asarray(sol_j.x) - x64).max() + 1e-5
    if rho_c is not None:
        assert sol_t.solved.numpy().all()
        assert np.ptp(sol_t.u[0].numpy(), axis=1).max() < 5e-3


def test_plain_warm_sequence_matches_jax_kernel_and_xla():
    """tests/test_fused_kernel.py:292-324: four warm solves (2 groups of 4,
    rho_c 50, max_iter 40), the plant stepped with the XLA state's u[0]:
    u within 5e-4 and counts within 2 of both JAX paths, and the carry's
    zc0 / yc0 within 5e-4 of the XLA state's zc0new / yc0 and of the JAX
    kernel's carry; x/u ride the carry too."""
    ng, G = 2, 4
    pj = _jax_problem(40, 50.0)
    pt = _port(pj)
    x0 = _x0s(ng, G)
    state = tm.init_state(pj, (ng, G))
    cj, ct_ = jax_init_carry(pj, ng * G), init_carry(pt, ng * G)
    assert ct_.zc0.shape == (4, ng * G) and ct_.u is not None
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    for t in range(4):
        sol_r, state, _ = tm.solve(pj, state, Xref=jnp.asarray(XREF),
                                   x0=jnp.asarray(x0))
        sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(XREF), None,
                                            jnp.asarray(x0), cj,
                                            tile=ng * G, interpret=True)
        sol_t, _, ct_ = solve_fused_warm_reference(
            pt, torch.as_tensor(XREF), None, torch.as_tensor(x0), ct_)
        for ref in (sol_r, sol_j):
            np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(ref.u),
                                       rtol=0, atol=5e-4, err_msg=str(t))
            assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(ref.iter))
                          <= 2)
        for k, sk in (("zc0", "zc0new"), ("yc0", "yc0")):
            np.testing.assert_allclose(
                getattr(ct_, k).T.reshape(ng, G, -1).numpy(),
                np.asarray(getattr(state, sk)), rtol=0, atol=5e-4,
                err_msg=f"{k} step {t}")
            np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                       np.asarray(getattr(cj, k)), rtol=0,
                                       atol=5e-4, err_msg=f"{k} step {t}")
        for k in ("x", "u"):
            np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                       np.asarray(getattr(cj, k)), rtol=0,
                                       atol=5e-4, err_msg=f"{k} step {t}")
        x0 = (x0 @ A.T + np.asarray(state.u[0]) @ Bm.T).astype(np.float32)


def test_families_with_consensus_at_six_by_three():
    """The rocket's cones and box with consensus over groups of four
    (rho_c 100) at (nx, nu) = (6, 3), cold and one warm solve, against
    the JAX kernel in interpret mode: x and u within 2e-4, counts within 1,
    the warm carry's cone duals and consensus pair within 5e-4."""
    s = systems.rocket_landing_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  f=s["f"], dtype=jnp.float32)
    pj = tm.with_bounds(
        pj, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
        x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
        u_max=105.0)
    pj = tm.with_cones(pj, state_cones=[(0, 3, 0.25)],
                       input_cones=[(0, 3, 0.5)])
    pj = tm.with_consensus(tm.with_settings(pj, max_iter=20,
                                            abs_pri_tol=2e-3), rho_c=100.0)
    pt = _port(pj)
    assert fused_supported(pt)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x0 = (xinit * np.random.default_rng(3).uniform(0.9, 1.2, (2, 4, 1))) \
        .astype(np.float32)
    Xref = np.linspace(xinit, np.zeros(6), N).astype(np.float32)
    Uref = np.zeros((N - 1, 3), np.float32)
    Uref[:, 2] = 10.0
    args_j = (jnp.asarray(Xref), jnp.asarray(Uref), jnp.asarray(x0))
    args_t = (torch.as_tensor(Xref), torch.as_tensor(Uref),
              torch.as_tensor(x0))
    sol_j, _ = jax_solve_fused(pj, *args_j, tile=8, interpret=True)
    sol_t, _ = solve_fused_reference(pt, *args_t)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=2e-4)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 1)
    _, _, cj = jax_solve_fused_warm(pj, *args_j, jax_init_carry(pj, 8),
                                    tile=8, interpret=True)
    _, _, ct_ = solve_fused_warm_reference(pt, *args_t, init_carry(pt, 8))
    for k in ("gc", "yc", "zc0", "yc0", "x", "u"):
        np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                   np.asarray(getattr(cj, k)), rtol=0,
                                   atol=5e-4, err_msg=k)


def test_a_converged_lane_offers_its_converging_iterate():
    """A group whose lanes converge at different iterations (2 groups of 2,
    rho_c 100, max_iter 500: counts 441 and 442 in one group). The rule of
    the kernel and its plain version: a converged lane freezes and its
    offer u[0] + yc0 of the converging iteration stands. Its carried pair
    gives that offer back as yc0 + zc0, so the later lane's slack is the
    mean of the two lanes' yc0 + zc0, to rounding. (The XLA path's offer,
    one iteration past the frozen iterate, is another value; the two rules
    agree to the JAX tests' tolerances, as the cold test shows.)"""
    pt = _port(_jax_problem(500, 100.0))
    x0 = torch.as_tensor(_x0s(2, 2))
    sol, _, c = solve_fused_warm_reference(pt, torch.as_tensor(XREF), None,
                                           x0, init_carry(pt, 4))
    it = sol.iter.reshape(-1)
    assert sol.solved.all()
    offers = (c.yc0 + c.zc0).reshape(4, 2, 2)
    mean = offers.mean(dim=-1)
    mixed = 0
    for g in range(2):
        a, b = it[2 * g].item(), it[2 * g + 1].item()
        if a == b:
            continue
        mixed += 1
        late = 2 * g + (0 if a > b else 1)
        np.testing.assert_allclose(c.zc0[:, late].numpy(), mean[:, g].numpy(),
                                   rtol=0, atol=1e-6)
    assert mixed >= 1


def test_launch_passes_the_consensus_arguments(monkeypatch):
    """The launch glue, against stand-ins for the C entry points: a box
    problem with consensus at (12, 4) goes to the thread-group kernel's
    consensus entry (tinympc_admm_group_consensus) with its group, the
    blocks of its cluster (1: a group of 4 lies in a block of 8), rho_c,
    and on a warm solve the carried u, x and dual in and the pair and x/u
    out, x/u in the carry, and counts as a consensus launch; with the
    exchange off (group 0) the same problem goes to the families kernel's
    one-thread entry with zero family counts."""
    pt = tt.with_consensus(_port(_jax_problem(5)), rho_c=100.0)
    seen = []

    def group_entry(*args):
        assert len(args) == 25
        warm = args[0]
        c = args[23]._obj
        assert (c.group, c.cluster, c.rho_c) == (4, 1, 100.0)
        assert args[3] == 8 and args[20] is None     # P, no block systems
        assert all((getattr(c, f) is not None) == bool(warm) for f in (
            "u_in", "x_in", "yc0_in", "zc0_out", "yc0_out", "x_out",
            "u_out"))
        seen.append(("group", warm))
        return 0

    def entry(*args):
        assert len(args) == 28
        counts = [args[7][k] for k in range(6)]
        c = args[26]._obj
        assert args[25] is None and c.group == 0
        seen.append(("fused", args[0], counts))
        return 0

    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda: entry)
    monkeypatch.setattr(admm_fused, "_group_policy_fn",
                        lambda kind: group_entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_fused, "consensus_launch_count", 0)
    monkeypatch.setattr(admm_fused, "consensus_warm_launch_count", 0)
    monkeypatch.setattr(admm_fused, "families_launch_count", 0)
    tables, x0, params = admm_fused._prepare(pt, None, None,
                                             torch.zeros((2, 4, 12)))
    assert params["cons"] == admm_fused.Consensus(4, 100.0)
    admm_fused._solve_kernel(tables, x0, N, 12, 4, **params)
    carry = admm_fused._carry_tensors(pt, init_carry(pt, 8), 8)
    _, _, out = admm_fused._solve_kernel_warm(tables, x0, carry, N, 12, 4,
                                              **params)
    off = dict(params, cons=admm_fused.Consensus(0, 0.0))
    admm_fused._launch(tables, x0, N, 12, 4, off["fam"], None, off["cons"],
                       None, 5, 1, off["rho"], off["tol_pri"],
                       off["tol_dua"])
    assert seen == [("group", 0), ("group", 1), ("fused", 0, [0] * 6)]
    for k in ("zc0", "yc0", "x", "u"):
        assert getattr(out, k).shape == getattr(carry, k).shape
    assert admm_fused.consensus_launch_count == 1
    assert admm_fused.consensus_warm_launch_count == 1
    assert admm_fused.families_launch_count == 0


def test_tables_carry_and_shared_memory():
    """The step-0 gains follow the family tables (Kinf0, then Quu0_inv),
    the box prefix is unchanged, shared memory grows by the gains and
    three (nu, 128) lane arrays, and the consensus pair passes through the
    carry's shift."""
    pt = _port(_jax_problem(5, 100.0))
    box = pt.replace(spec=dataclasses.replace(pt.spec, en_consensus=False))
    full = admm_fused._pack_tables(pt, None, None)
    plain = admm_fused._pack_tables(box, None, None)
    t = admm_fused._unpack_tables(full, 12, 4, N, consensus=True)
    assert torch.equal(full[:plain.numel()], plain)
    assert full.numel() == plain.numel() + 4 * 12 + 4 * 4
    assert torch.equal(t["Kinf0"], pt.cache.Kinf0)
    assert torch.equal(t["Quu0"], pt.cache.Quu0_inv)
    fam = admm_fused.NO_FAMILIES
    assert admm_fused.smem_bytes(12, 4, N, fam, None, True) == \
        admm_fused.smem_bytes(12, 4, N) + 4 * (64 + 3 * 4 * 128)
    c = init_carry(pt, 3)
    marked = c.replace(zc0=torch.arange(12.).reshape(4, 3),
                       yc0=-torch.arange(12.).reshape(4, 3))
    sh = shift_carry(marked)
    assert torch.equal(sh.zc0, marked.zc0) and torch.equal(sh.yc0,
                                                            marked.yc0)


def test_solve_fused_on_cpu_is_the_plain_version():
    """solve_fused and solve_fused_warm on CPU tensors run the plain
    versions, in the JAX package's grouped layout."""
    pt = _port(_jax_problem(30, 100.0))
    x0 = torch.as_tensor(_x0s(2, 4))
    Xref = torch.as_tensor(XREF)
    for a, b in zip(solve_fused(pt, Xref, None, x0),
                    solve_fused_reference(pt, Xref, None, x0)):
        for f in ("x", "u", "iter", "solved"):
            if hasattr(a, f):
                assert torch.equal(getattr(a, f), getattr(b, f))
    c0 = init_carry(pt, 8)
    sol, res, c1 = solve_fused_warm(pt, Xref, None, x0, c0)
    ref, ref_res, r1 = solve_fused_warm_reference(pt, Xref, None, x0, c0)
    assert torch.equal(res, ref_res) and torch.equal(sol.u, ref.u)
    for k in ("zc0", "yc0", "x", "u", "g"):
        assert torch.equal(getattr(c1, k), getattr(r1, k))
    assert not c0.yc0.any()


@pytest.mark.parametrize("shape,match", [
    ((8, 12), "n_groups, G"), ((2, 3, 12), "power of two"),
    ((1, 256, 12), "at most 128")])
def test_refusals(shape, match):
    """x0s not (n_groups, G, nx), G not a power of two, and G past the
    block, refused by the resident and the streamed solve alike; the fused
    closed loop refuses consensus (ROADMAP.md)."""
    pt = _port(_jax_problem(5))
    with pytest.raises(ValueError, match=match):
        solve_fused(pt, None, None, torch.zeros(shape))
    with pytest.raises(ValueError, match=match):
        tt.kernels.solve_fused_streamed(pt, None, None, torch.zeros(shape))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tt.kernels.closed_loop_fused(pt, torch.as_tensor(XREF),
                                     torch.zeros((2, 12)), 2)
    assert not tt.kernels.closed_loop_fused_supported(pt)
