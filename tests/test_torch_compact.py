"""To-convergence lane compaction (``kernels.make_compact_solver``,
``solve_fused_compact``) and the warm solve it runs,
``solve_fused_warm(final=True)``, on the CPU, where the phases run the
kernels' plain versions.

Box problems at fixed rho are held bitwise to one long plain solve, and to
the JAX package's compaction (``tinympc_tpu.kernels.make_compact_solver``
with ``interpret=True``, float32) on exact counts and solved masks; the
other families and adaptive rho at tests/test_compact.py's tolerances.
Consensus compaction, on both backends, is held bitwise to the port's own
loop of full-width ``final=True`` phases with a first-convergence freeze on
the host (tests/test_compact.py:296-321's reference), and to JAX at the
consensus tests' tolerances. Inputs come from numpy seeds. The kernels
themselves run only on the card: chip_smoke.py holds compaction on them
bitwise against one long kernel solve there."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import make_compact_solver as jax_compact_solver
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_to_numpy, problem_from_numpy,
                                       problem_to_numpy)
from tinympc_tpu_torch.kernels import (admm_fused, compact, init_carry,
                                       make_compact_solver, solve_fused,
                                       solve_fused_compact,
                                       solve_fused_streamed_warm,
                                       solve_fused_warm)

torch.set_num_threads(1)

N = 10


def _jax_quad(max_iter=60, N=N, **settings):
    """tests/test_compact.py:_quadrotor: float32, box +-5 / +-0.5."""
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, **settings)


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _quad(max_iter=60, N=N, **settings):
    return _port(_jax_quad(max_iter, N, **settings))


def _mixed(B, lo=0.05, hi=0.45, seed=0):
    """tests/test_compact.py:_mixed_x0s: scales from easy to hard."""
    rng = np.random.default_rng(seed)
    scales = np.linspace(lo, hi, B)[:, None]
    return (rng.uniform(-1, 1, (B, 12)) * scales).astype(np.float32)


def _assert_same(a, b):
    for k in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(a[0], k), getattr(b[0], k)), k
    assert torch.equal(a[1], b[1])


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("ct", [1, 5])
def test_box_compaction_is_bitwise_one_long_solve(ct):
    """tests/test_compact.py's mixed batch (B=16, max_iter 60) through
    phases of 15, a [10, 40] schedule and phases of 5 at the narrowest
    width (min_batch 2): each bitwise equal to one long plain solve; at
    check_termination 1, in phases of 15, on exact counts and solved masks
    equal to the JAX package's compaction, x and u within 1e-4 of it."""
    pj, x0 = _jax_quad(60, check_termination=ct), _mixed(16)
    prob, x = _port(pj), torch.as_tensor(x0)
    long = solve_fused(prob, None, None, x)
    it = long[0].iter.numpy()
    assert it.min() <= 15 and it.max() > 30, f"workload not mixed: {it}"
    for chunk, mb in ((15, 4), ([10, 40], 4), (5, 2)):
        _assert_same(make_compact_solver(prob, chunk=chunk,
                                         min_batch=mb)(x), long)
    if ct != 1:
        return
    sol_j = jax_compact_solver(pj, chunk=15, tile=16, min_batch=4,
                               interpret=True)(jnp.asarray(x0))[0]
    sol = solve_fused_compact(prob, None, None, x, chunk=15, min_batch=4)[0]
    np.testing.assert_array_equal(sol.iter.numpy(), _np(sol_j.iter))
    np.testing.assert_array_equal(sol.solved.numpy(), _np(sol_j.solved))
    np.testing.assert_allclose(sol.x.numpy(), _np(sol_j.x), atol=1e-4)
    np.testing.assert_allclose(sol.u.numpy(), _np(sol_j.u), atol=1e-4)


def test_budget_not_a_multiple_of_the_chunk_and_early_exit():
    """A last partial phase lands on the budget exactly (37 in phases of
    10); a batch that converges in its first phase runs no other phase."""
    prob, x = _quad(37), torch.as_tensor(_mixed(8, 0.3, 0.5))
    compact.phase_count = 0
    _assert_same(make_compact_solver(prob, chunk=10, min_batch=4)(x),
                 solve_fused(prob, None, None, x))
    assert compact.phase_count == 4
    prob, x = _quad(100), torch.as_tensor(_mixed(8, 0.01, 0.05))
    long = solve_fused(prob, None, None, x)
    assert long[0].solved.all()
    compact.phase_count = 0
    _assert_same(make_compact_solver(prob, chunk=50, min_batch=4)(x), long)
    assert compact.phase_count == 1


def test_segments_and_min_batch(monkeypatch):
    """segment=8 over 32 lanes equals the unsegmented solve and one long
    solve; each phase runs exactly its live lanes, padded up to
    min(min_batch, B) with repeats of the first live lane."""
    prob, x = _quad(40), torch.as_tensor(_mixed(32))
    long = solve_fused(prob, None, None, x)
    _assert_same(make_compact_solver(prob, chunk=20, min_batch=8,
                                     segment=8)(x), long)
    widths, warm = [], admm_fused.solve_fused_warm

    def spy(prob, Xref, Uref, x0s, carry, **kw):
        widths.append((x0s.shape[0], x0s.clone()))
        return warm(prob, Xref, Uref, x0s, carry, **kw)

    monkeypatch.setattr(admm_fused, "solve_fused_warm", spy)
    live = int((long[0].iter > 10).sum())
    for mb in (2, 16, 64):
        widths.clear()
        _assert_same(make_compact_solver(prob, chunk=10, min_batch=mb)(x),
                     long)
        assert widths[0][0] == 32
        assert widths[1][0] == max(live, min(mb, 32))
        x1 = widths[1][1]
        assert torch.equal(x1[:live], x[long[0].iter > 10])
        assert (x1[live:] == x1[0]).all()


def test_precise_tail_equals_the_matched_budget_control():
    """precise_tail=30 after a budget of 30 in phases of 15 has the phase
    boundaries of a budget of 60 in phases [15, 15, 30]: bitwise equal;
    lanes solved within the budget keep their results, recovered lanes
    report iter > max_iter."""
    x = torch.as_tensor(_mixed(16))
    base = make_compact_solver(_quad(30), chunk=15, min_batch=4)(x)
    tail = make_compact_solver(_quad(30), chunk=15, min_batch=4,
                               precise_tail=30)(x)
    control = make_compact_solver(_quad(60), chunk=[15, 15, 30],
                                  min_batch=4)(x)
    _assert_same(tail, control)
    sv_b, sv_t = base[0].solved, tail[0].solved
    assert (~sv_b).any() and (sv_t & ~sv_b).any()
    assert torch.equal(tail[0].x[:, sv_b], base[0].x[:, sv_b])
    assert torch.equal(tail[0].iter[sv_b], base[0].iter[sv_b])
    assert (tail[0].iter[sv_t & ~sv_b] > 30).all()


def test_soc_and_adaptive_against_jax():
    """tests/test_compact.py's rocket SOC (chunk 20, max_iter 80) and
    adaptive rho (chunk 10, max_iter 40): counts and solved masks as the
    JAX package's compaction, x and u within 1e-4, the final-rho 5th row
    within rtol 1e-4; solved lanes meet the tolerances and the cone."""
    s = systems.rocket_landing_20hz()
    pj = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                  f=s["f"], dtype=jnp.float32)
    pj = tm.with_bounds(pj, x_min=np.tile([-5.0, -5, -0.5, -10, -10, -20],
                                          (N, 1)),
                        x_max=np.tile([5.0, 5, 100, 10, 10, 20], (N, 1)),
                        u_min=-10.0, u_max=105.0)
    pj = tm.with_cones(pj, state_cones=[(0, 3, 0.25)],
                       input_cones=[(0, 3, 0.5)])
    pj = tm.with_settings(pj, max_iter=80, abs_pri_tol=2e-3)
    rng = np.random.default_rng(1)
    xinit = np.asarray([4, 2, 20, -3, 2, -4.5])
    x0 = (xinit * (1 + 0.1 * rng.uniform(-1, 1, (8, 6)))).astype(np.float32)
    Xref = (xinit * (1 - np.arange(N)[:, None] / 99.0)).astype(np.float32)
    Uref = np.zeros((N - 1, 3), np.float32)
    Uref[:, 2] = 10.0
    adaptive = tm.with_settings(tm.with_sensitivities(
        _jax_quad(40), systems.crazyflie_sensitivity_tables()),
        adaptive_rho=True)
    for pj, x0, refs, chunk in ((pj, x0, (Xref, Uref), 20),
                                (adaptive, _mixed(8, 0.1, 0.4, 1),
                                 (None, None), 10)):
        sol_j, res_j = jax_compact_solver(pj, chunk=chunk, tile=8,
                                          min_batch=4, interpret=True)(
            jnp.asarray(x0), *(None if r is None else jnp.asarray(r)
                               for r in refs))
        sol, res = make_compact_solver(_port(pj), chunk=chunk, min_batch=4)(
            torch.as_tensor(x0),
            *(None if r is None else torch.as_tensor(r) for r in refs))
        np.testing.assert_array_equal(sol.iter.numpy(), _np(sol_j.iter))
        np.testing.assert_array_equal(sol.solved.numpy(), _np(sol_j.solved))
        np.testing.assert_allclose(sol.x.numpy(), _np(sol_j.x), atol=1e-4)
        np.testing.assert_allclose(sol.u.numpy(), _np(sol_j.u), atol=1e-4)
        assert res.shape[0] == res_j.shape[0]
        solved = sol.solved.numpy()
        assert solved.any()
        tol = pj.settings.abs_pri_tol
        assert (res[:4].numpy()[:, solved] < tol + 1e-6).all()
        if pj.settings.adaptive_rho:
            np.testing.assert_allclose(res[4].numpy(), _np(res_j[4]),
                                       rtol=1e-4)
        else:
            xs = sol.x.numpy()[:, solved]
            assert (np.linalg.norm(xs[..., :2], axis=-1)
                    <= 0.25 * xs[..., 2] + 1e-4).all()


def _consensus(max_iter, **settings):
    return tm.with_consensus(_jax_quad(max_iter, **settings), rho_c=50.0)


def _manual(prob, x0, Xref, phase, phases, backend):
    """tests/test_compact.py:296-321's reference: every phase relaunches
    every group from its carry (full width, no compaction), and the host
    keeps each lane's outputs from its first convergence on."""
    ng, G = x0.shape[:2]
    B = ng * G
    p = tt.with_settings(prob, max_iter=phase)
    carry, out, used = init_carry(prob, B), None, 0
    for _ in range(phases):
        if backend == "streamed":
            sol, res, carry = solve_fused_streamed_warm(p, Xref, None, x0,
                                                        carry)
        else:
            sol, res, carry = solve_fused_warm(p, Xref, None, x0, carry,
                                               final=True)
        new = [sol.x.reshape(N, B, 12), sol.u.reshape(N - 1, B, 4),
               sol.iter.reshape(B), sol.solved.reshape(B),
               res.reshape(res.shape[0], B)]
        if out is None:
            out = new
        else:
            live = ~out[3]
            out[0] = torch.where(live[None, :, None], new[0], out[0])
            out[1] = torch.where(live[None, :, None], new[1], out[1])
            out[2] = torch.where(live, used + new[2], out[2])
            out[4] = torch.where(live[None, :], new[4], out[4])
            out[3] = out[3] | new[3]
        used += phase
    return out


def _staggered():
    """tests/test_compact.py:338-417's workload: 8 groups of 4 whose
    difficulty is staggered, abs tolerances 2e-2, max_iter 120."""
    rng = np.random.default_rng(7)
    scales = np.asarray([0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12,
                         0.2])[:, None, None]
    return (rng.uniform(-1, 1, (8, 4, 12)) * scales).astype(np.float32)


@pytest.mark.parametrize("backend", ["resident", "streamed"])
def test_consensus_compacts_in_group_units(backend):
    """tests/test_compact.py:270-330 and :338-417, on both backends: the
    4 x 4 batch (rho_c 50, chunk 20) and the staggered 8 x 4 batch in
    phases of 5, whose live set shrinks at two boundaries or more, each
    bitwise equal to the manual loop; on the 4 x 4 batch, as there, the
    solved groups' u[0] spread within 2 abs_pri_tol + 1e-5. (Phases of 2
    re-seed the consensus slack so often that one solved group of the
    staggered batch passes that bar, 0.041 against 0.040, in the JAX
    package's compaction as in the port's.)"""
    rng = np.random.default_rng(2)
    scales = np.linspace(0.05, 0.5, 4)[:, None, None]
    x44 = (rng.uniform(-1, 1, (4, 4, 12)) * scales).astype(np.float32)
    Xref = torch.zeros((N, 12))
    Xref[:, 2] = 0.5
    for pj, x0, xref, chunk, phases in (
            (_consensus(60), x44, Xref, 20, 3),
            (_consensus(120, abs_pri_tol=2e-2, abs_dua_tol=2e-2),
             _staggered(), None, 5, 24)):
        prob, x = _port(pj), torch.as_tensor(x0)
        sol, res = make_compact_solver(prob, chunk=chunk, min_batch=4,
                                       backend=backend)(x, xref)
        ref = _manual(prob, x, xref, chunk, phases, backend)
        B = x.shape[0] * x.shape[1]
        assert torch.equal(sol.x.reshape(N, B, 12), ref[0])
        assert torch.equal(sol.u.reshape(N - 1, B, 4), ref[1])
        assert torch.equal(sol.iter.reshape(B), ref[2])
        assert torch.equal(sol.solved.reshape(B), ref[3])
        assert torch.equal(res.reshape(4, B), ref[4])
        if chunk == 20:
            u0 = sol.u[0].numpy()
            spread = np.ptp(u0, axis=1).max(-1)
            done = sol.solved.numpy().all(axis=1)
            assert np.all(spread[done] < 2 * pj.settings.abs_pri_tol + 1e-5)
        else:
            git = sol.iter.numpy().max(axis=1)
            assert np.unique(np.ceil(git / chunk)).size >= 3, git


def test_consensus_compaction_against_jax():
    """Against the JAX package's consensus compaction: the 4 x 4 batch at
    the consensus tests' tolerances (x and u within 2e-4, counts within 1).
    On the staggered batch the solved masks agree, every group's first
    lane converges on the same iteration, and the groups whose lanes all
    converge on that iteration agree within 2e-4. After a group's first
    convergence the two may part: the JAX kernel's converged lanes keep
    computing (and offering) and hand over a post-convergence carry, the
    port's stop and hand over their first-convergence state."""
    rng = np.random.default_rng(2)
    scales = np.linspace(0.05, 0.5, 4)[:, None, None]
    x44 = (rng.uniform(-1, 1, (4, 4, 12)) * scales).astype(np.float32)
    Xref = np.zeros((N, 12), np.float32)
    Xref[:, 2] = 0.5
    pj = _consensus(60)
    sol_j = jax_compact_solver(pj, chunk=20, tile=16, min_batch=4,
                               interpret=True)(jnp.asarray(x44),
                                               jnp.asarray(Xref))[0]
    sol = make_compact_solver(_port(pj), chunk=20, min_batch=4)(
        torch.as_tensor(x44), torch.as_tensor(Xref))[0]
    assert np.all(np.abs(sol.iter.numpy() - _np(sol_j.iter)) <= 1)
    np.testing.assert_allclose(sol.x.numpy(), _np(sol_j.x), atol=2e-4)
    np.testing.assert_allclose(sol.u.numpy(), _np(sol_j.u), atol=2e-4)
    pj = _consensus(120, abs_pri_tol=2e-2, abs_dua_tol=2e-2)
    x0 = _staggered()
    sol_j = jax_compact_solver(pj, chunk=10, tile=32, min_batch=4,
                               interpret=True)(jnp.asarray(x0))[0]
    sol = make_compact_solver(_port(pj), chunk=10, min_batch=4)(
        torch.as_tensor(x0))[0]
    np.testing.assert_array_equal(sol.solved.numpy(), _np(sol_j.solved))
    it, it_j = sol.iter.numpy(), _np(sol_j.iter)
    np.testing.assert_array_equal(it.min(axis=1), it_j.min(axis=1))
    agree = (it == it_j).all(axis=1) & (it.min(axis=1) == it.max(axis=1))
    assert agree.sum() >= 3, it
    np.testing.assert_allclose(sol.x.numpy()[:, agree], _np(sol_j.x)[:, agree],
                               atol=2e-4)
    np.testing.assert_allclose(sol.u.numpy()[:, agree], _np(sol_j.u)[:, agree],
                               atol=2e-4)


def _spread_misses(sol, tol_pri):
    """The solved groups of a consensus solve and how many of them pass
    tests/test_fused_kernel.py:262-268's u[0] spread bar, 2 abs_pri_tol +
    1e-5."""
    u0 = _np(sol.u)[0]
    spread = np.ptp(u0, axis=1).max(-1)
    done = _np(sol.solved).all(axis=1)
    return int(done.sum()), int((done & (spread > 2 * tol_pri + 1e-5)).sum())


def test_consensus_compaction_spread_against_jax():
    """The spread bar's witness for a compacted consensus solve, on the
    card's G=16 batch cut to 128 x 16 (bench_all.py:224-250: N=10, z 0.5,
    rho_c 100, max_iter 500, ct 1) in the card's phases, [100, 400]. The
    JAX package's own compaction passes the bar on a larger share of its
    solved groups than its one long solve (the XLA path): each phase
    re-seeds a live group's slack from the carried u[0]. So compaction is
    held to a compacted witness, as chip_smoke.py holds it to admm.solve on
    the same phases: the port's share is no larger than the JAX
    compaction's + 0.005."""
    ng, G = 128, 16
    pj = tm.with_consensus(_jax_quad(500), rho_c=100.0)
    rng = np.random.default_rng(0)
    x0 = (rng.uniform(-0.3, 0.3, (ng, 1, 12))
          + 0.05 * rng.uniform(-1, 1, (ng, G, 12))).astype(np.float32)
    Xref = np.zeros((N, 12), np.float32)
    Xref[:, 2] = 0.5
    tol = pj.settings.abs_pri_tol
    long_j = tm.solve(pj, tm.init_state(pj, (ng, G)), Xref=jnp.asarray(Xref),
                      x0=jnp.asarray(x0))[0]
    comp_j = jax_compact_solver(pj, chunk=[100, 400], tile=ng * G,
                                min_batch=G, interpret=True)(
        jnp.asarray(x0), jnp.asarray(Xref))[0]
    comp = make_compact_solver(_port(pj), chunk=[100, 400], min_batch=G)(
        torch.as_tensor(x0), torch.as_tensor(Xref))[0]
    share = {name: over / solved for name, (solved, over) in (
        ("jax long", _spread_misses(long_j, tol)),
        ("jax compaction", _spread_misses(comp_j, tol)),
        ("port compaction", _spread_misses(comp, tol)))}
    assert share["jax compaction"] > share["jax long"], share
    assert share["port compaction"] <= share["jax compaction"] + 0.005, share


def test_final_carry():
    """solve_fused_warm(final=True): an unconverged lane hands over its
    final iterate, the JAX kernel's final=True carry field by field (within
    1e-5); a converged lane hands over its first-convergence state, the
    final=False carry, bitwise."""
    pj = _jax_quad(20)
    x0 = _mixed(8)
    sol_j, _, c_j = jax_solve_fused_warm(pj, None, None, jnp.asarray(x0),
                                         jax_init_carry(pj, 8), tile=8,
                                         final=True, interpret=True)
    prob, x = _port(pj), torch.as_tensor(x0)
    sol, _, c = solve_fused_warm(prob, None, None, x, init_carry(prob, 8),
                                 final=True)
    _, _, c0 = solve_fused_warm(prob, None, None, x, init_carry(prob, 8))
    live, done = ~sol.solved.numpy(), sol.solved.numpy()
    assert live.any() and done.any()
    np.testing.assert_array_equal(sol.solved.numpy(), _np(sol_j.solved))
    cj = {k: _np(v) for k, v in dataclasses.asdict(c_j).items()
          if v is not None}
    for name, a in carry_to_numpy(c).items():
        if a is None:
            continue
        np.testing.assert_allclose(a[..., live], cj[name][..., live],
                                   atol=1e-5, err_msg=name)
        assert torch.equal(getattr(c, name), getattr(c0, name)), name


def test_refusals():
    """A chunk that is not a positive multiple of check_termination (also
    in a schedule), an unknown backend, a consensus group that is not a
    power of two or passes 128 lanes, and an adaptive-rho problem without
    its sensitivities on either backend; with them, compaction on an
    adaptive problem builds on both."""
    prob = _quad(40, check_termination=5)
    for chunk in (7, 0, [10, 12]):
        with pytest.raises(ValueError, match="chunk"):
            make_compact_solver(prob, chunk=chunk)
    with pytest.raises(ValueError, match="backend"):
        make_compact_solver(prob, backend="tiled")
    cons = _port(_consensus(40))
    for shape in ((2, 3, 12), (1, 256, 12)):
        with pytest.raises(ValueError, match="power of two"):
            make_compact_solver(cons, chunk=20)(torch.zeros(shape))
    adaptive = _port(tm.with_settings(tm.with_sensitivities(
        _jax_quad(40), systems.crazyflie_sensitivity_tables()),
        adaptive_rho=True))
    make_compact_solver(adaptive, backend="streamed")
    make_compact_solver(adaptive, backend="resident")
    bare = adaptive.replace(cache=dataclasses.replace(
        adaptive.cache, dKinf_drho=None, dPinf_drho=None, dC1_drho=None,
        dC2_drho=None))
    for backend in ("streamed", "resident"):
        with pytest.raises(ValueError, match="sensitivities"):
            make_compact_solver(bare, backend=backend)


def test_auto_backend_follows_shared_memory():
    """"auto" takes the resident kernel while its tables fit in a block's
    shared memory and the streamed kernels past that (N=1197 at (12, 4));
    so does an adaptive-rho problem (its tables move the wall to N=1183),
    while one without its sensitivities, which neither takes, raises. No
    solve runs."""
    assert compact._backend(_quad(40, N=1196), "auto") == "resident"
    assert compact._backend(_quad(40, N=1197), "auto") == "streamed"
    tables = [np.asarray(a) for a in systems.crazyflie_sensitivity_tables()]
    for N, backend in ((1182, "resident"), (1183, "streamed")):
        adaptive = tt.with_settings(tt.with_sensitivities(
            _quad(40, N=N), tables), adaptive_rho=True)
        assert compact._backend(adaptive, "auto") == backend
    long = _quad(40, N=1197)
    bare = long.replace(settings=dataclasses.replace(
        long.settings, adaptive_rho=True))
    with pytest.raises(ValueError, match="neither"):
        compact._backend(bare, "auto")

