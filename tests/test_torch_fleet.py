"""Heterogeneous fleets: the port's ``solve_fused_multi`` and
``make_fleet_solver`` (cold and warm) on CPU tensors, where they run the
plain version of the multi-system launch, against the JAX package's
``solve_fused_multi`` and ``make_fleet_solver`` in interpret mode
(tests/test_batch.py:115-290 and tests/test_fused_kernel.py:458-495 run
them so), and bitwise against the port's own ``solve_fused`` of each
gathered bucket; the kernel path's gather, padding and scatter against a
stand-in launch; and every refusal.

The CUDA kernel itself cannot run here; chip_smoke.py holds the one launch
bitwise against per-bucket launches on the GPU."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import make_fleet_solver as jax_make_fleet_solver
from tinympc_tpu.kernels import solve_fused_multi as jax_solve_fused_multi

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (init_carry, make_fleet_solver,
                                       solve_fused, solve_fused_fleet,
                                       solve_fused_multi,
                                       solve_fused_multi_reference,
                                       solve_fused_warm)
from tinympc_tpu_torch.kernels import admm_fused

torch.set_num_threads(1)

N = 10
B = 64
SCALES = (1.0, 1.01, 0.99, 1.02)


def _variant(A, scale):
    """A with its off-diagonal entries scaled (bench_all.py:281-284)."""
    return np.asarray(A) * np.where(np.eye(len(A)) == 1, 1.0, scale)


def _quads(scales=SCALES, max_iter=40, adaptive=False, rho=None):
    """test_batch.py's quadrotor variants (N=10, box +-5 / +-0.5); adaptive
    ones take the Crazyflie tables."""
    s = systems.quadrotor_20hz()
    out = []
    for scale in scales:
        p = tm.setup(_variant(s["A"], scale), s["B"], s["Qdiag"], s["Rdiag"],
                     rho=s["rho"] if rho is None else rho, N=N,
                     dtype=jnp.float32)
        p = tm.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
        if adaptive:
            p = tm.with_sensitivities(
                p, systems.crazyflie_sensitivity_tables())
        out.append(tm.with_settings(p, max_iter=max_iter,
                                    adaptive_rho=adaptive))
    return out


def _rockets(scales=(1.0, 1.01, 0.98)):
    """Rocket variants with the state and input cones at (6, 3)
    (tests/test_fused_kernel.py:57-80's problem)."""
    s = systems.rocket_landing_20hz()
    out = []
    for scale in scales:
        p = tm.setup(_variant(s["A"], scale), s["B"], s["Qdiag"], s["Rdiag"],
                     rho=s["rho"], N=N, f=s["f"], dtype=jnp.float32)
        p = tm.with_bounds(
            p, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        p = tm.with_cones(p, state_cones=[(0, 3, 0.25)],
                          input_cones=[(0, 3, 0.5)])
        out.append(tm.with_settings(p, max_iter=40, check_termination=1,
                                    abs_pri_tol=2e-3))
    return out


def _port(probs):
    return [problem_from_numpy(problem_to_numpy(p), "cpu", torch.float32)
            for p in probs]


def _inputs(n_sys, nx=12, seed=0):
    """x0 ~ U[-0.3, 0.3] (the rocket's: xinit U[0.9, 1.2]) and uneven
    assignments, one bucket forced larger."""
    rng = np.random.default_rng(seed)
    if nx == 6:
        x0 = np.asarray([4, 2, 20, -3, 2, -4.5]) * rng.uniform(0.9, 1.2,
                                                               (B, 1))
    else:
        x0 = rng.uniform(-0.3, 0.3, (B, nx))
    a = rng.integers(0, n_sys, B)
    a[:5] = n_sys - 1
    return x0.astype(np.float32), a


def _hold(sol_t, res_t, sol_j, res_j, held=None):
    """tests/test_batch.py's bar: counts within 1, at least 90% equal,
    equal solved masks, 5e-5 on x and u of the lanes whose counts agree
    (and on ``held``); the residuals there at
    tests/test_torch_admm_fused.py's 1e-4 against the JAX kernel (the dual
    rows are scaled by rho = 5, so a 1e-5 step in the slacks shows as
    5e-5). Returns the agreeing lanes."""
    it_t, it_j = sol_t.iter.numpy(), np.asarray(sol_j.iter)
    assert np.abs(it_t - it_j).max() <= 1
    same = it_t == it_j
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))
    keep = same if held is None else same & held
    for a, b in ((sol_t.x, sol_j.x), (sol_t.u, sol_j.u)):
        np.testing.assert_allclose(np.compress(keep, a.numpy(), axis=1),
                                   np.compress(keep, np.asarray(b), axis=1),
                                   rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.compress(keep, res_t.numpy(), axis=1),
                               np.compress(keep, np.asarray(res_j), axis=1),
                               rtol=0, atol=1e-4)
    return same


def test_solve_fused_multi_matches_the_jax_launch():
    pj = _quads()
    x0, _ = _inputs(4)
    sol_j, res_j = jax_solve_fused_multi(pj, jnp.asarray(x0), tile=16,
                                         interpret=True)
    sol_t, res_t = solve_fused_multi(_port(pj), torch.as_tensor(x0))
    _hold(sol_t, res_t, sol_j, res_j)
    ref = solve_fused_multi_reference(_port(pj), torch.as_tensor(x0))
    assert torch.equal(ref[0].x, sol_t.x) and torch.equal(ref[1], res_t)


@pytest.mark.parametrize("family", ["box", "cones"])
def test_cold_fleet_matches_the_jax_fleet(family):
    pj = _quads() if family == "box" else _rockets()
    x0, a = _inputs(len(pj), pj[0].spec.nx)
    sol_j, res_j = jax_make_fleet_solver(pj, tile=64, interpret=True)(
        a, jnp.asarray(x0))
    sol_t, res_t = make_fleet_solver(_port(pj))(a, torch.as_tensor(x0))
    assert sol_t.x.shape == (N, B, pj[0].spec.nx)
    _hold(sol_t, res_t, sol_j, res_j)


def _plant(probs, a, x, u0):
    """Each lane's plant stepped with its own system: x+ = A x + B u0 + f
    in float32 numpy."""
    out = np.empty_like(x)
    for s, p in enumerate(probs):
        idx = np.flatnonzero(a == s)
        A, Bm, f = (np.asarray(getattr(p, k), np.float32)
                    for k in ("A", "B", "f"))
        out[idx] = x[idx] @ A.T + u0[idx] @ Bm.T + f
    return out


def test_warm_fleet_matches_the_jax_fleet_over_three_solves():
    """Each side carries its own fleet-order carry; the plants step with
    the port's u[0], each with its own system. Held at test_batch.py's bar
    on the lanes whose counts agreed at every step, the carry's vnew, g, y
    too."""
    pj = _quads(max_iter=30)
    pt = _port(pj)
    x, a = _inputs(4, seed=1)
    solve_j = jax_make_fleet_solver(pj, tile=64, warm=True, interpret=True)
    solve_t = make_fleet_solver(pt, warm=True)
    cj, ct = jax_init_carry(pj[0], B), init_carry(pt[0], B)
    held = np.ones(B, bool)
    for _ in range(3):
        sol_j, res_j, cj = solve_j(a, jnp.asarray(x), cj)
        sol_t, res_t, ct = solve_t(a, torch.as_tensor(x), ct)
        held &= _hold(sol_t, res_t, sol_j, res_j, held)
        for k in ("vnew", "g", "y"):
            np.testing.assert_allclose(
                np.compress(held, getattr(ct, k).numpy(), axis=-1),
                np.compress(held, np.asarray(getattr(cj, k)), axis=-1),
                rtol=0, atol=5e-5, err_msg=k)
        x = _plant(pj, a, x, sol_t.u[0].numpy())


def test_adaptive_fleet_matches_the_jax_fleet():
    """Adaptive rho: 5 residual rows, the last each lane's final rho; held
    at tests/test_fused_adaptive.py's bar (atol 5e-4 on x and u, counts
    within 2, final rho rtol 1e-3)."""
    pj = _quads(scales=(1.0, 1.01), adaptive=True)
    x0, a = _inputs(2, seed=5)
    sol_j, res_j = jax_make_fleet_solver(pj, tile=64, interpret=True)(
        a, jnp.asarray(x0))
    sol_t, res_t = make_fleet_solver(_port(pj))(a, torch.as_tensor(x0))
    assert res_t.shape == (5, B)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=5e-4)
    assert np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)).max() <= 2
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)


CASES = {"box": lambda: _quads(), "cones": lambda: _rockets(),
         "adaptive": lambda: _quads(scales=(1.0, 1.01, 0.99),
                                    adaptive=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_is_bitwise_each_buckets_solve_fused(case):
    """Each system's lanes are bitwise those of the port's solve_fused (and
    over two warm solves solve_fused_warm) of the gathered bucket, carries
    included: on the CPU every bucket here has at least 2 lanes."""
    pt = _port(CASES[case]())
    x0, a = _inputs(len(pt), pt[0].spec.nx, seed=2)
    x0 = torch.as_tensor(x0)
    sol, res = solve_fused_fleet(pt, a, x0)
    solve = make_fleet_solver(pt, warm=True)
    carry = init_carry(pt[0], B)
    bucket_carries = [init_carry(p, int((a == s).sum()))
                      for s, p in enumerate(pt)]
    for step in range(3):
        if step:
            sol, res, carry = solve(a, x0, carry)
        for s, p in enumerate(pt):
            idx = torch.as_tensor(np.flatnonzero(a == s))
            assert idx.numel() >= 2
            if step:
                sd, rd, bucket_carries[s] = solve_fused_warm(
                    p, None, None, x0[idx], bucket_carries[s])
                for k, v in vars(bucket_carries[s]).items():
                    if v is not None:
                        assert torch.equal(getattr(carry, k)[..., idx], v), k
            else:
                sd, rd = solve_fused(p, None, None, x0[idx])
            for f in ("x", "u"):
                assert torch.equal(getattr(sol, f)[:, idx], getattr(sd, f))
            assert torch.equal(sol.iter[idx], sd.iter)
            assert torch.equal(sol.solved[idx], sd.solved)
            assert torch.equal(res[:, idx], rd)
        if step:
            x0 = torch.as_tensor(_plant(pt, a, x0.numpy(),
                                        sol.u[0].numpy()))


def _launch_on_blocks(calls):
    """A stand-in for the multi-system launch: each block of 128 lanes
    solved by the plain version with its system's table, as the kernel
    does."""
    def launch(tables, x0, N, nx, nu, fam, adapt, cons, carry, max_iter, ct,
               rho, tol_pri, tol_dua, block_sys=None):
        calls.append(block_sys.tolist())
        stride = admm_fused._table_floats(nx, nu, N, fam, adapt)
        assert tables.numel() % stride == 0
        assert x0.shape[0] == admm_fused.BLOCK * block_sys.numel()
        outs = []
        for k, s in enumerate(block_sys.tolist()):
            lanes = torch.arange(k * admm_fused.BLOCK,
                                 (k + 1) * admm_fused.BLOCK)
            outs.append(admm_fused._solve_plain(
                tables[s * stride:(s + 1) * stride], x0[lanes], N, nx, nu,
                carry=admm_fused._take_lanes(carry, lanes), max_iter=max_iter,
                ct=ct, rho=rho, tol_pri=tol_pri, tol_dua=tol_dua, fam=fam,
                adapt=adapt, cons=cons)[:3])
        parts = [admm_fused._lane_tensors(o) for o in outs]
        return admm_fused._rebuild(outs[0], [
            torch.cat([p[i][0] for p in parts], dim=ax)
            for i, (_, ax) in enumerate(parts[0])])
    return launch


@pytest.mark.parametrize("warm", [False, True])
def test_kernel_path_pads_gathers_and_scatters(warm, monkeypatch):
    """The kernel path (gather into the padded system-major layout, one
    launch with a system a block, scatter back) against a stand-in launch
    that solves each block with its system's table: bitwise the plain path
    on a ragged fleet (3 systems, B=300, random assignments), and one
    multi-system launch counted."""
    pt = _port(_quads(scales=(1.0, 1.01, 0.99), max_iter=20))
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.uniform(-0.3, 0.3, (300, 12)),
                         dtype=torch.float32)
    a = rng.integers(0, 3, 300)
    calls = []
    monkeypatch.setattr(admm_fused, "_launch", _launch_on_blocks(calls))
    monkeypatch.setattr(admm_fused, "multi_launch_count", 0)
    monkeypatch.setattr(admm_fused, "multi_warm_launch_count", 0)
    bk = admm_fused.buckets(a, 3, "cpu")
    counts = np.bincount(a, minlength=3)
    assert calls == [] and bk.block_sys.tolist() == sum(
        ([s] * -(-int(c) // 128) for s, c in enumerate(counts)), [])
    tables = admm_fused.system_tables(pt)
    x0c, params = admm_fused._x0_params(pt[0], x0)
    carry = None
    if warm:
        carry = admm_fused._carry_tensors(
            pt[0], admm_fused.solve_systems(tables, x0c, bk, N, 12, 4,
                                            init_carry(pt[0], 300),
                                            **params)[2], 300)
    got = admm_fused._solve_systems_kernel(tables, x0c, bk, N, 12, 4, carry,
                                           **params)
    want = admm_fused.solve_systems(tables, x0c, bk, N, 12, 4, carry,
                                    plain=True, **params)
    assert calls == [bk.block_sys.tolist()]
    for (g, _), (w, _) in zip(admm_fused._lane_tensors(got),
                              admm_fused._lane_tensors(want)):
        assert torch.equal(g, w)
    assert (admm_fused.multi_warm_launch_count if warm
            else admm_fused.multi_launch_count) == 1


def test_launch_passes_the_block_systems_to_the_multi_entry(monkeypatch):
    """The launch glue against a stand-in for the box solve's entry,
    tinympc_admm_group (csrc/admm_group.cu), which takes the multi-system
    launch too: the single-system arguments, then the systems of the
    128-lane tiles and the stride of one table, then the saved columns
    (none at this horizon) and the stream; no other entry is called."""
    pt = _port(_quads(scales=(1.0, 1.01)))
    seen = []

    def fn(*args):
        seen.append((True, len(args), args[20:23]))
        return 0

    monkeypatch.setattr(admm_fused, "_group_fn", lambda: fn)
    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda multi=False: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_fused, "multi_launch_count", 0)
    bk = admm_fused.buckets(np.repeat([0, 1], [3, 200]), 2, "cpu")
    tables = admm_fused.system_tables(pt)
    x0, params = admm_fused._x0_params(pt[0], torch.zeros((203, 12)))
    admm_fused._solve_systems_kernel(tables, x0, bk, N, 12, 4, **params)
    stride = admm_fused._table_floats(12, 4, N)
    assert tables.shape == (2, stride)
    assert seen == [(True, 24, (bk.block_sys.data_ptr(), stride, None))]
    assert bk.block_sys.tolist() == [0, 1, 1]
    assert admm_fused.multi_launch_count == 1


def test_refusals_and_their_messages():
    """solve_fused_multi keeps the JAX package's messages
    (tests/test_fused_kernel.py:458-481); the fleet solver its own
    (tests/test_batch.py:216-231, :284-291) and the setup-rho rule that
    the JAX fleet documents but does not check."""
    p1, p2 = _port(_quads(scales=(1.0,), max_iter=10) + _quads(
        scales=(1.0,), max_iter=20))
    p3 = _port(_quads(scales=(1.0,), max_iter=10, rho=7.7))[0]
    x0 = torch.zeros((8, 12))
    with pytest.raises(ValueError, match="empty system list"):
        solve_fused_multi([], x0)
    with pytest.raises(ValueError, match="spec/settings"):
        solve_fused_multi([p1, p2], x0)
    with pytest.raises(ValueError, match="rho"):
        solve_fused_multi([p1, p3], x0)
    tree = tt.with_consensus(p1, rho_c=10.0)
    with pytest.raises(ValueError, match="consensus"):
        solve_fused_multi([tree, tree], torch.zeros((2, 4, 12)))
    with pytest.raises(ValueError, match="equal"):
        solve_fused_multi([p1, p1, p1], x0)
    with pytest.raises(ValueError, match="empty fleet"):
        make_fleet_solver([])
    with pytest.raises(ValueError, match="spec/settings"):
        make_fleet_solver([p1, p2])
    with pytest.raises(ValueError, match="consensus"):
        make_fleet_solver([tree])
    with pytest.raises(ValueError, match="rho"):
        make_fleet_solver([p1, p3])
    solver = make_fleet_solver([p1])
    with pytest.raises(ValueError, match="assignments"):
        solver(np.zeros(3, int), torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="out of range"):
        solver(np.full(4, 2), torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="integers"):
        solver(np.zeros(4), torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="init_carry"):
        make_fleet_solver([p1], warm=True)(np.zeros(4, int),
                                           torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="carry"):
        make_fleet_solver([p1], warm=True)(np.zeros(4, int),
                                           torch.zeros((4, 12)),
                                           init_carry(p1, 5))


def test_references_are_written_into_tables_packed_once():
    """A fleet packs its systems' tables once; a tick's references go into
    each table's reference slots only: the same bits as packing each system
    with its references, per-system lists (None for zeros) and shared
    arrays alike; no references leave the tables as they are."""
    pt = _port(_quads(scales=(1.0, 1.01, 0.99)))
    rng = np.random.default_rng(5)
    Xrefs = [torch.as_tensor(rng.uniform(-1, 1, (N, 12)),
                             dtype=torch.float32) for _ in pt]
    Uref = rng.uniform(-0.1, 0.1, (N - 1, 4))       # float64, shared
    static = admm_fused.system_tables(pt)
    assert admm_fused.with_references(static, pt[0].spec) is static
    for xr, ur in ((Xrefs, Uref), ([Xrefs[0], None, Xrefs[2]], None),
                   (None, [Uref, Uref, None])):
        got = admm_fused.with_references(static, pt[0].spec, xr, ur)
        xs = xr if isinstance(xr, list) else [xr] * len(pt)
        us = ur if isinstance(ur, list) else [ur] * len(pt)
        want = torch.stack([admm_fused._pack_tables(p, x, u)
                            for p, x, u in zip(pt, xs, us)])
        assert torch.equal(got, want)
    assert torch.equal(static, torch.stack([admm_fused._pack_tables(
        p, None, None) for p in pt]))
    with pytest.raises(ValueError, match="references for 3 systems"):
        admm_fused.with_references(static, pt[0].spec, Xrefs[:2])
    with pytest.raises(ValueError, match="expected shape"):
        admm_fused.with_references(static, pt[0].spec, None,
                                   np.zeros((N, 4)))
