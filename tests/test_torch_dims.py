"""The (nx, nu) pairs that only the one-thread kernels instantiate:
cartpole's (4, 1) and the degenerate pairs (2, 2), (2, 1), (3, 3) and
(1, 1) of tests/test_degenerate_dims.py, through the port's entry points on
CPU tensors (the kernels' plain PyTorch versions) against the JAX package's
fused and streamed kernels in interpret mode and against the port's own
``admm.solve``; the routes that send every launch at these pairs to
``csrc/admm_fused.cu`` and the one-thread entries of
``csrc/admm_stream.cu``, against stand-in C entries; the refusals off the
list; and the reference's cartpole golden replayed through the port in
float64.

The CUDA kernels themselves cannot run here; chip_smoke.py holds them
against the plain versions on the GPU."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_streamed as jax_streamed
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (admm_fused, admm_stream, compact,
                                       fused_supported, init_carry,
                                       solve_fused, solve_fused_streamed,
                                       solve_fused_warm, stream_supported)

from helpers import assert_cache_close, golden_cache, load_golden, \
    steps_array

torch.set_num_threads(1)

RES = ("pri_res_state", "pri_res_input", "dua_res_state", "dua_res_input")
# The random systems at tests/test_degenerate_dims.py's (nx, nu, N) and
# seeds, the same builder at (4, 1), and cartpole at bench_all.py:128-129's
# N; each case's max_iter.
CASES = {"2x2": (2, 2, 3, 50), "2x1": (2, 1, 3, 50), "3x3": (3, 3, 4, 50),
         "1x1": (1, 1, 3, 50), "4x1": (4, 1, 10, 50),
         "cartpole": (4, 1, 10, 100)}


def _random_system(nx, nu):
    """tests/test_degenerate_dims.py:29-41's random stable system, seed
    nx * 100 + nu (its fused test's): A at spectral radius 0.9."""
    rng = np.random.default_rng(nx * 100 + nu)
    A = rng.uniform(-1.0, 1.0, (nx, nx))
    A *= 0.9 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-9)
    B = rng.uniform(-1.0, 1.0, (nx, nu))
    return dict(A=A, B=B, Qdiag=rng.uniform(1.0, 5.0, nx),
                Rdiag=rng.uniform(0.1, 1.0, nu), rho=1.0, f=np.zeros(nx))


def _jax_problem(case, dtype=jnp.float32, max_iter=None, N=None, ct=1):
    """The case's JAX problem: the random systems with that test's bounds
    (x in [-3, 3], u in [-2, 2]); cartpole with bench_all.py's (x +-5, u
    +-0.5)."""
    nx, nu, n, mi = CASES[case]
    s = systems.cartpole() if case == "cartpole" else _random_system(nx, nu)
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N or n, f=s["f"], dtype=dtype)
    lim = (5.0, 0.5) if case == "cartpole" else (3.0, 2.0)
    prob = tm.with_bounds(prob, x_min=-lim[0], x_max=lim[0], u_min=-lim[1],
                          u_max=lim[1])
    return tm.with_settings(prob, max_iter=max_iter or mi,
                            check_termination=ct)


def _port(pj, dtype=torch.float32):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", dtype)


def _inputs(case, B, seed=3, N=None):
    """x0 ~ U[-0.5, 0.5]^nx and the reference: zero, or cartpole's
    Xref[:, 2] = 1 (bench_all.py:132)."""
    nx, _, n, _ = CASES[case]
    x0 = np.random.default_rng(seed).uniform(-0.5, 0.5, (B, nx))
    Xref = np.zeros((N or n, nx))
    if case == "cartpole":
        Xref[:, 2] = 1.0
    return x0.astype(np.float32), Xref.astype(np.float32)


def _cartpole(**settings):
    """The float32 cartpole problem of the witnesses below, JAX side."""
    return tm.with_settings(_jax_problem("cartpole"), **settings)


def _close(sol_t, sol_j, atol=1e-4, slack=1):
    """tests/test_degenerate_dims.py's bar: x and u to ``atol``, counts
    within ``slack``."""
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=atol)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                  <= slack)


# ------------------------------------------------- against the JAX kernel

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_cold_matches_jax_fused_kernel(case):
    """solve_fused on CPU tensors (the plain version) against the JAX
    kernel in interpret mode, B=8: x / u to 1e-4, counts within 1."""
    pj = _jax_problem(case)
    x0, Xref = _inputs(case, 8)
    sol_j, _ = jax_solve_fused(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                               tile=8, interpret=True)
    sol_t, res_t = solve_fused(_port(pj), torch.as_tensor(Xref), None,
                               torch.as_tensor(x0))
    nx, nu, N, _ = CASES[case]
    assert sol_t.x.shape == (N, 8, nx) and sol_t.u.shape == (N - 1, 8, nu)
    assert res_t.shape == (4, 8)
    _close(sol_t, sol_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_cold_matches_port_admm_solve(case):
    """The kernel-layout plain version against the port's admm.solve on
    the same float32 problem, B=16: the same operations, the products
    summed in another layout, so exact counts and solved flags, and 1e-6
    on x, u and the residuals."""
    pt = _port(_jax_problem(case))
    x0, Xref = (torch.as_tensor(a) for a in _inputs(case, 16, seed=2))
    sol_f, res_f = solve_fused(pt, Xref, None, x0)
    sol_s, st, _ = tt.solve(pt, tt.init_state(pt, (16,)), Xref, None, x0)
    np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
    np.testing.assert_array_equal(sol_f.solved.numpy(), sol_s.solved.numpy())
    np.testing.assert_allclose(sol_f.x.numpy(), sol_s.x.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sol_f.u.numpy(), sol_s.u.numpy(), rtol=1e-6,
                               atol=1e-6)
    res_s = torch.stack([getattr(st, k) for k in RES])
    np.testing.assert_allclose(res_f.numpy(), res_s.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_solve_matches_jax(case):
    """The port's admm.solve in float64 against tinympc_tpu.solve at
    tests/test_parity.py's bar: exact counts and solved flags, 1e-6 on x,
    u and the four residuals."""
    pj = _jax_problem(case, jnp.float64)
    pt = _port(pj, torch.float64)
    x0, Xref = (a.astype(np.float64) for a in _inputs(case, 16, seed=4))
    sol_j, st_j, _ = tm.solve(pj, tm.init_state(pj, (16,)),
                              Xref=jnp.asarray(Xref), x0=jnp.asarray(x0))
    sol_t, st_t, _ = tt.solve(pt, tt.init_state(pt, (16,)),
                              torch.as_tensor(Xref), None,
                              torch.as_tensor(x0))
    np.testing.assert_array_equal(sol_t.iter.numpy(), np.asarray(sol_j.iter))
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=1e-6)
    for k in RES:
        np.testing.assert_allclose(getattr(st_t, k).numpy(),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_cartpole_warm_sequence_matches_jax_warm_kernel():
    """Three warm solves of an external plant (x+ = A x + B u0, the JAX
    solve's u0), each package with its own carry, the last with
    final=True: u and the carry's slacks and duals to 1e-4, counts within
    1. The box-only carry holds no x/u on either side."""
    pj = _cartpole(max_iter=40)
    pt = _port(pj)
    B = 8
    x0, Xref = _inputs("cartpole", B, seed=5)
    cj, ct_ = jax_init_carry(pj, B), init_carry(pt, B)
    assert ct_.x is None and cj.x is None
    A, Bm = (np.asarray(getattr(pj, k), np.float32) for k in ("A", "B"))
    for step in range(3):
        final = step == 2
        sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(Xref), None,
                                            jnp.asarray(x0), cj, tile=B,
                                            final=final, interpret=True)
        sol_t, _, ct_ = solve_fused_warm(pt, torch.as_tensor(Xref), None,
                                         torch.as_tensor(x0), ct_,
                                         final=final)
        _close(sol_t, sol_j)
        for k in ("vnew", "znew", "g", "y", "v", "z"):
            np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                       np.asarray(getattr(cj, k)), rtol=0,
                                       atol=1e-4, err_msg=k)
        x0 = (x0 @ A.T + np.asarray(sol_j.u[0]) @ Bm.T).astype(np.float32)


@pytest.mark.parametrize("apply_c", [False, True])
def test_cartpole_adaptive_matches_jax_fused_kernel(apply_c):
    """Adaptive rho from cartpole's rho of 1 (its sensitivities from
    compute_sensitivities), a batch of 8 (batched witnesses only: the
    JAX package's unbatched float64 adaptive solve at nx=4 corrupts its
    carry, ROADMAP Queue 3), cold: tests/test_fused_adaptive.py's bar --
    x and u to 5e-4, final rho rtol 1e-3, counts within 2 -- and rho has
    moved."""
    pj = tm.with_sensitivities(_cartpole(max_iter=40))
    pj = tm.with_settings(pj, adaptive_rho=True, adaptive_rho_min=0.05,
                          adaptive_rho_apply_c=apply_c)
    x0, Xref = _inputs("cartpole", 8, seed=6)
    sol_j, res_j = jax_solve_fused(pj, jnp.asarray(Xref), None,
                                   jnp.asarray(x0), tile=8, interpret=True)
    sol_t, res_t = solve_fused(_port(pj), torch.as_tensor(Xref), None,
                               torch.as_tensor(x0))
    assert res_t.shape == (5, 8)
    _close(sol_t, sol_j, atol=5e-4, slack=2)
    np.testing.assert_allclose(res_t[4].numpy(), np.asarray(res_j[4]),
                               rtol=1e-3)
    assert np.any(np.abs(res_t[4].numpy() - 1.0) > 1e-3)


def test_cartpole_consensus_matches_jax_fused_kernel():
    """Consensus at tests/test_diff.py:171's rho_c = 20, 2 groups of 4,
    cold and one warm solve: x and u to 2e-4, counts within 1
    (tests/test_torch_consensus_fused.py's bar), and each group whose
    lanes all converged within 2 abs_pri_tol + 1e-5 on u[0]."""
    pj = tm.with_consensus(_cartpole(max_iter=60), rho_c=20.0)
    pt = _port(pj)
    x0 = np.random.default_rng(7).uniform(-0.3, 0.3, (2, 4, 4)) \
        .astype(np.float32)
    Xref = _inputs("cartpole", 8)[1]
    sol_j, _ = jax_solve_fused(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                               tile=8, interpret=True)
    sol_t, _ = solve_fused(pt, torch.as_tensor(Xref), None,
                           torch.as_tensor(x0))
    assert sol_t.x.shape == (10, 2, 4, 4) and sol_t.iter.shape == (2, 4)
    _close(sol_t, sol_j, atol=2e-4)
    u0 = sol_t.u[0].numpy()
    done = sol_t.solved.numpy().all(axis=1)
    assert np.all(np.ptp(u0, axis=1).max(-1)[done]
                  < 2 * pt.settings.abs_pri_tol + 1e-5)
    cj, ct_ = jax_init_carry(pj, 8), init_carry(pt, 8)
    sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(Xref), None,
                                        jnp.asarray(x0), cj, tile=8,
                                        interpret=True)
    sol_t, _, ct_ = solve_fused_warm(pt, torch.as_tensor(Xref), None,
                                     torch.as_tensor(x0), ct_)
    _close(sol_t, sol_j, atol=2e-4)
    for k in ("zc0", "yc0", "x", "u"):
        np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                   np.asarray(getattr(cj, k)), rtol=0,
                                   atol=2e-4, err_msg=k)


def test_cartpole_hyperplane_matches_jax_fused_kernel():
    """A state hyperplane on the cart position, x[0] <= 0.2, that binds on
    the lanes starting past it, cold then one warm solve: x and u to 1e-4,
    counts within 1; the plane's dual and the carried x / u too."""
    pj = tm.with_linear_constraints(_cartpole(max_iter=40),
                                    np.array([[1.0, 0, 0, 0]]), [0.2])
    pt = _port(pj)
    x0, Xref = _inputs("cartpole", 8, seed=8)
    assert (x0[:, 0] > 0.2).any()
    sol_j, _ = jax_solve_fused(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                               tile=8, interpret=True)
    sol_t, _ = solve_fused(pt, torch.as_tensor(Xref), None,
                           torch.as_tensor(x0))
    _close(sol_t, sol_j)
    cj, ct_ = jax_init_carry(pj, 8), init_carry(pt, 8)
    sol_j, _, cj = jax_solve_fused_warm(pj, jnp.asarray(Xref), None,
                                        jnp.asarray(x0), cj, tile=8,
                                        interpret=True)
    sol_t, _, ct_ = solve_fused_warm(pt, torch.as_tensor(Xref), None,
                                     torch.as_tensor(x0), ct_)
    _close(sol_t, sol_j)
    assert np.abs(ct_.gl.numpy()).max() > 0
    for k in ("gl", "x", "u"):
        np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                   np.asarray(getattr(cj, k)), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_cartpole_streamed_plain_matches_jax_streamed_kernel():
    """solve_fused_streamed on CPU tensors (its plain versions through the
    host loop) against the JAX streamed kernels in interpret mode, N=16,
    B=8: x and u to 1e-4, counts within 1; and bitwise the resident plain
    version on the same inputs."""
    pj = _jax_problem("cartpole", N=16, max_iter=60)
    pt = _port(pj)
    x0, Xref = _inputs("cartpole", 8, seed=9, N=16)
    sol_j, _ = jax_streamed(pj, jnp.asarray(Xref), None, jnp.asarray(x0),
                            tile=8, chunk=8, interpret=True)
    sol_t, res_t = solve_fused_streamed(pt, torch.as_tensor(Xref), None,
                                        torch.as_tensor(x0))
    _close(sol_t, sol_j)
    sol_r, res_r = solve_fused(pt, torch.as_tensor(Xref), None,
                               torch.as_tensor(x0))
    for a, b in ((sol_t.x, sol_r.x), (sol_t.u, sol_r.u),
                 (sol_t.iter, sol_r.iter), (res_t, res_r)):
        assert torch.equal(a, b)


# --------------------------------------------------------------- routes

def _families(**kw):
    return admm_fused.Families(*(kw.get(k, 0) for k in admm_fused.Families
                                 ._fields))


@pytest.mark.parametrize("dims", admm_fused.THREAD_KERNEL_DIMS)
def test_new_pairs_route_to_the_one_thread_kernels(dims):
    """At each pair: no thread-group kind for any mix, rho or consensus (a
    box-only problem runs the families instantiation, counted as such);
    fused_supported and stream_supported hold, at fixed and adaptive rho;
    compaction's "auto" picks the resident kernel."""
    nx, nu = dims
    adapt = admm_fused.Adaptive(False, False, 0.05, 100.0, 1.0)
    for fam in (admm_fused.NO_FAMILIES, _families(nlx=1)):
        for a in (None, adapt):
            assert admm_fused.group_kind(nx, nu, fam, a, None) is None
            assert admm_fused.group_route(10, nx, nu, fam, a, None,
                                          False) is None
        cons = admm_fused.Consensus(4, 20.0)
        assert admm_fused.group_kind(nx, nu, fam, None, cons) is None
    assert admm_fused._instantiation(nx, nu, admm_fused.NO_FAMILIES, None,
                                     None) == "families"
    s = tt.systems.synthetic(nx, nu)
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=10,
                 device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    for q in (p, tt.with_settings(p, adaptive_rho=True),
              tt.with_consensus(p, rho_c=20.0)):
        assert fused_supported(q) and stream_supported(q)
        assert compact._backend(q, "auto") == "resident"


class _StreamEntries:
    """Stand-ins for the one-thread entries tinympc_stream_backward /
    tinympc_stream_forward: they record each launch's (nx, nu) and whether
    it had consensus arguments, and clear the flag on check iterations."""

    def __init__(self):
        self.calls = []

    def backward(self, *args):
        assert len(args) == 18
        self.calls.append(("bwd", args[0], args[1], args[15] is not None))
        return 0

    def forward(self, *args):
        assert len(args) == 29
        self.calls.append(("fwd", args[1], args[2], args[26] is not None))
        if (args[5] + 1) % args[6] == 0:
            ctypes.c_int.from_address(args[22]).value = 0
        return 0


def _no_team():
    raise AssertionError("a team entry was loaded at a one-thread pair")


@pytest.fixture
def stand_ins(monkeypatch):
    """The one-thread stream entries and csrc/admm_fused.cu's entries as
    stand-ins; the team and group entries raise if anything loads them."""
    e = _StreamEntries()
    monkeypatch.setattr(admm_stream, "_kernel_fns",
                        lambda: (e.backward, e.forward))
    for name in ("_team_fns", "_team_families_fns", "_team_consensus_fns"):
        monkeypatch.setattr(admm_stream, name, _no_team)
    monkeypatch.setattr(admm_fused, "_group_fn", _no_team)
    monkeypatch.setattr(admm_fused, "_group_policy_fn",
                        lambda kind: _no_team())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(admm_stream, "launch_counts",
                        dict.fromkeys(admm_stream.launch_counts, 0))
    monkeypatch.setattr(admm_fused, "entry_counts",
                        dict.fromkeys(admm_fused.entry_counts, 0))
    return e


@pytest.mark.parametrize("consensus", [False, True])
def test_streamed_launches_take_the_one_thread_entries(consensus,
                                                       stand_ins):
    """A cartpole box problem, and one with consensus, through the host
    loop's kernel launchers: every launch on the one-thread entries at
    (4, 1), counted as theirs, no team entry loaded."""
    pt = _port(_cartpole(max_iter=4, check_termination=2))
    x0 = torch.zeros((8, 4))
    if consensus:
        pt = tt.with_consensus(pt, rho_c=20.0)
        x0 = x0.reshape(2, 4, 4)
    tables, x0c, _, params = admm_stream._prepare(pt, None, None, x0)
    s = admm_stream._init(x0c, 10, 4, 1, None, params["fam"],
                          params["cons"])
    k = admm_stream._KERNELS(tables, x0c, s, None, 10, 4, 1,
                             **{n: params[n] for n in (
                                 "rho", "ct", "tol_pri", "tol_dua", "fam",
                                 "cons")})
    assert k.team is None and k.kind is None
    admm_stream._loop(tables, x0c, None, pt.spec, admm_stream._KERNELS,
                      **params)
    assert stand_ins.calls == [("bwd", 4, 1, consensus),
                               ("fwd", 4, 1, consensus)] * 2
    sfx = "_consensus" if consensus else ""
    assert {k: v for k, v in admm_stream.launch_counts.items() if v} == {
        f"backward{sfx}": 2, f"forward{sfx}": 2}


@pytest.mark.parametrize("warm", [False, True])
def test_resident_and_fleet_launches_take_admm_fused(warm, stand_ins,
                                                     monkeypatch):
    """A cartpole box solve and a fleet of two cartpole variants, cold and
    warm, against a stand-in of csrc/admm_fused.cu's entries: the solve on
    tinympc_admm_fused, the fleet's one launch on tinympc_admm_fused_multi
    (its systems and table stride before the stream), (nx, nu) = (4, 1),
    zero family counts; a warm box-only solve hands the families
    instantiation scratch x/u in and out."""
    seen = []

    def entry(multi=False):
        def fn(*args):
            counts = [args[7][k] for k in range(6)]
            fam = [args[24][k] for k in range(22)]
            seen.append((multi, len(args), args[1:3], counts,
                         [p is not None for p in fam[18:]]))
            return 0
        return fn

    monkeypatch.setattr(admm_fused, "_kernel_fn", entry)
    pj = _cartpole(max_iter=5)
    pt = _port(pj)
    x0 = torch.zeros((200, 4))
    carry = init_carry(pt, 200) if warm else None
    if warm:
        tables, x0c, params = admm_fused._prepare(pt, None, None, x0)
        admm_fused._solve_kernel_warm(
            tables, x0c, admm_fused._carry_tensors(pt, carry, 200), 10, 4, 1,
            **params)
    else:
        tables, x0c, params = admm_fused._prepare(pt, None, None, x0)
        admm_fused._solve_kernel(tables, x0c, 10, 4, 1, **params)
    variant = pj.replace(A=pj.A * 1.001)
    probs = [pt, _port(variant)]
    bk = admm_fused.buckets(np.repeat([0, 1], [72, 128]), 2, "cpu")
    admm_fused._solve_systems_kernel(
        admm_fused.system_tables(probs), x0c, bk, 10, 4, 1,
        None if carry is None else admm_fused._carry_tensors(pt, carry, 200),
        **params)
    xu = [warm] * 4
    assert seen == [(False, 28, (4, 1), [0] * 6, xu),
                    (True, 30, (4, 1), [0] * 6, xu)]
    assert admm_fused.entry_counts == dict(
        dict.fromkeys(admm_fused.entry_counts, 0), tinympc_admm_fused=1,
        tinympc_admm_fused_multi=1)


# ------------------------------------------------------------ refusals

def _synthetic(nx, nu, **settings):
    s = tt.systems.synthetic(nx, nu)
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=10,
                 device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, **settings)


def test_refusals_name_the_roadmap_item():
    """(32, 8) and a pair off the list, at fixed and adaptive rho, are
    refused by the resident and streamed solves and by the closed loop,
    with the lists and the ROADMAP item that will add them; the closed loop
    takes cartpole (on the one-thread loop). Nothing falls back to the
    plain version."""
    for nx, nu in ((32, 8), (5, 2)):
        for p in (_synthetic(nx, nu), _synthetic(nx, nu, adaptive_rho=True)):
            assert not fused_supported(p) and not stream_supported(p)
            assert not tt.kernels.closed_loop_fused_supported(p)
            x0 = torch.zeros((2, nx))
            for solve in (solve_fused, solve_fused_streamed):
                with pytest.raises(ValueError, match=r"\(4, 1\).*Queue 2 "
                                   r"item 1c"):
                    solve(p, None, None, x0)
        with pytest.raises(ValueError, match=rf"\(nx, nu\) = \({nx}, {nu}\)"
                           r".*\(4, 1\).*Queue 2 item 1c"):
            tt.kernels.closed_loop_fused(_synthetic(nx, nu),
                                         torch.zeros((10, nx)),
                                         torch.zeros((2, nx)), 3)
    assert tt.kernels.closed_loop_fused_supported(_port(_cartpole()))


# --------------------------------------------------------------- golden

def test_cartpole_golden_replays_through_the_port():
    """examples/scenarios.py:run_cartpole through the port's float64
    admm.solve, all 390 steps, unbatched, the warm state carried across
    steps (tests/test_compat.py:14-47's drive: N=10, max_iter 100, bounds
    +-1e17, Xref x = 1, x0 = [0.5, 0, 0, 0]): tests/test_parity.py's bar --
    exact counts and solved flags, 1e-6 on x0, u0 and the residuals --,
    and the golden cache (tests/helpers.py:assert_cache_close)."""
    g = load_golden("cartpole")
    s = tt.systems.cartpole()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=10, dtype=torch.float64, device="cpu")
    gc = golden_cache(g)
    np.testing.assert_allclose(prob.Qdiag.numpy(), gc["Q_aug"], atol=1e-12)
    np.testing.assert_allclose(prob.Rdiag.numpy(), gc["R_aug"], atol=1e-12)
    assert_cache_close(types.SimpleNamespace(**{
        k: getattr(prob.cache, k).numpy() for k in (
            "Kinf", "Pinf", "Quu_inv", "AmBKt", "APf", "BPf")}), gc,
        atol=1e-6)
    prob = tt.with_bounds(prob, x_min=-1e17, x_max=1e17, u_min=-1e17,
                          u_max=1e17)
    prob = tt.with_settings(prob, max_iter=100)
    state = tt.init_state(prob)
    x0 = torch.tensor([0.5, 0.0, 0.0, 0.0], dtype=torch.float64)
    Xref = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64).repeat(10, 1)
    rec = {k: [] for k in ("x0", "u0", "iter", "solved") + RES}
    for _ in range(len(g["steps"])):
        sol, state, _ = tt.solve(prob, state, Xref, None, x0)
        u0 = state.u[0]
        rec["x0"].append(x0.numpy().copy())
        rec["u0"].append(u0.numpy().copy())
        rec["iter"].append(int(sol.iter))
        rec["solved"].append(int(sol.solved))
        for k in RES:
            rec[k].append(float(getattr(state, k)))
        x0 = prob.A @ x0 + prob.B @ u0
    assert len(rec["iter"]) == 390
    for k in ("x0", "u0") + RES:
        np.testing.assert_allclose(np.asarray(rec[k]), steps_array(g, k),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(rec["iter"], steps_array(g, "iter"))
    np.testing.assert_array_equal(rec["solved"], steps_array(g, "solved"))
