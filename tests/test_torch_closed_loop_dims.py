"""The fused closed loop at the pairs of the one-thread-a-plant kernel
(csrc/closed_loop_thread.cu): the rocket's (6, 3) with the reference's
rocket-landing loop (its ``f``, ``Uref``, per-state bounds and sliding
reference; its cones configured but off), cartpole's (4, 1) and the
degenerate (2, 2), (2, 1), (3, 3), (1, 1). The loop's plain PyTorch version
(what ``closed_loop_fused`` runs on CPU tensors, and what the kernel is held
against on the card) against the JAX package's fused Pallas loop in
interpret mode and against the port's own float32 ``closed_loop``; the
route that sends (12, 4) to the thread-group loop and these pairs (or the
private pin) to the one-thread loop, through stand-in launches; the launch
glue, through a stand-in C entry; the refusals.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the GPU."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.kernels import closed_loop_fused as jax_closed_loop_fused

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.kernels import (closed_loop_fused,
                                       closed_loop_fused_reference,
                                       closed_loop_fused_supported)
from tinympc_tpu_torch.kernels import closed_loop_kernel as cl

from test_torch_dims import _port, _random_system
from test_torch_group_consensus import _view

torch.set_num_threads(1)

B, T, N = 8, 10, 10
XINIT = np.asarray([4.0, 2.0, 20.0, -3.0, 2.0, -4.5])
# (nx, nu) of each case; the rocket and cartpole are the reference's demos,
# the rest tests/test_degenerate_dims.py's random stable systems.
PAIRS = {"rocket": (6, 3), "cartpole": (4, 1), "2x2": (2, 2),
         "2x1": (2, 1), "3x3": (3, 3), "1x1": (1, 1)}
OPTIONS = {"fixed": {}, "reset": dict(reset_duals=True),
           "shift": dict(shift_warm=True)}


def _jax_problem(case, ct=1, dtype=jnp.float32):
    """The case's JAX problem. The rocket as examples/scenarios.py:
    run_rocket_landing builds it (per-state box, cones configured but off,
    max_iter 100, abs_pri_tol 2e-3); cartpole at bench_all.py:128-131's box
    (x +-5, u +-0.5), max_iter 100; the random systems at their test's box
    (x in [-3, 3], u in [-2, 2]), max_iter 50."""
    if case == "rocket":
        s = systems.rocket_landing_20hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                        N=N, f=s["f"], dtype=dtype)
        prob = tm.with_bounds(
            prob, x_min=np.tile([-5.0, -5.0, -0.5, -10.0, -10.0, -20.0],
                                (N, 1)),
            x_max=np.tile([5.0, 5.0, 100.0, 10.0, 10.0, 20.0], (N, 1)),
            u_min=-10.0, u_max=105.0)
        prob = tm.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)], enable=False)
        return tm.with_settings(prob, max_iter=100, abs_pri_tol=2e-3,
                                check_termination=ct)
    s = systems.cartpole() if case == "cartpole" else \
        _random_system(*PAIRS[case])
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, f=s["f"], dtype=dtype)
    lim = (5.0, 0.5) if case == "cartpole" else (3.0, 2.0)
    prob = tm.with_bounds(prob, x_min=-lim[0], x_max=lim[0], u_min=-lim[1],
                          u_max=lim[1])
    return tm.with_settings(prob, max_iter=100 if case == "cartpole" else 50,
                            check_termination=ct)


def _inputs(case, dtype=np.float32):
    """x0, Xref_total and Uref of the case. The rocket as
    run_rocket_landing: x0 = xinit U[0.9, 1.2], the sliding reference
    xinit + (0 - xinit) k / 99 for k = 0 .. T + N - 2, Uref[:, 2] = 10;
    cartpole as run_cartpole: x0 = [0.5, 0, 0, 0] + U[-0.3, 0.3]^4, x = 1
    held fixed; the random systems x0 ~ U[-0.5, 0.5]^nx and a zero
    reference."""
    rng = np.random.default_rng(0)
    nx, nu = PAIRS[case]
    Uref = None
    if case == "rocket":
        x0 = XINIT * rng.uniform(0.9, 1.2, (B, 6))
        k = np.arange(T + N - 1)[:, None]
        xref = XINIT + (0.0 - XINIT) * k / 99.0
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
    elif case == "cartpole":
        x0 = np.asarray([0.5, 0.0, 0.0, 0.0]) + rng.uniform(-0.3, 0.3,
                                                            (B, 4))
        xref = np.zeros((N, 4))
        xref[:, 0] = 1.0
    else:
        x0 = rng.uniform(-0.5, 0.5, (B, nx))
        xref = np.zeros((N, nx))
    cast = lambda a: None if a is None else a.astype(dtype)
    return cast(x0), cast(xref), cast(Uref)


# ----------------------------------------------- against the JAX kernel

@pytest.mark.parametrize("case,option", [
    ("rocket", "fixed"), ("rocket", "shift"), ("cartpole", "fixed"),
    ("cartpole", "shift"), ("2x1", "fixed"), ("1x1", "shift")])
def test_plain_loop_matches_jax_fused_kernel(case, option):
    """The plain fused loop against the JAX package's fused loop in
    interpret mode on the same float32 problem, at
    tests/test_closed_loop_fused.py's bar (as
    tests/test_torch_closed_loop.py holds (12, 4)): atol 1e-4 on xs and
    us, at least 90% equal iteration counts. The fixed window runs at
    check_termination 5, the shifted one at the rocket example's 1: at 1
    the rocket's fixed window meets a float32 termination tie between the
    two sides' summation orders (step 6, lane 1 stops at 29 iterations
    here, 28 there), and one iteration moves that step's u by ~3e-4."""
    pj = _jax_problem(case, ct=5 if option == "fixed" else 1)
    x0, xref, Uref = _inputs(case)
    opts = OPTIONS[option]
    ju = None if Uref is None else jnp.asarray(Uref)
    xs_j, us_j, it_j, sv_j = jax_closed_loop_fused(
        pj, jnp.asarray(xref), jnp.asarray(x0), T, ju, tile=B,
        interpret=True, **opts)
    tu = None if Uref is None else torch.as_tensor(Uref)
    xs_t, us_t, it_t, sv_t = closed_loop_fused_reference(
        _port(pj), torch.as_tensor(xref), torch.as_tensor(x0), T, tu, **opts)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-4)
    assert np.mean(it_t.numpy() == np.asarray(it_j)) >= 0.9
    assert np.mean(sv_t.numpy() == np.asarray(sv_j)) >= 0.9
    nx, nu = PAIRS[case]
    assert xs_t.shape == (T, B, nx) and us_t.shape == (T, B, nu)


# ------------------------------------- against the port's own closed_loop

@pytest.mark.parametrize("case,option", [
    (c, o) for c in sorted(PAIRS) for o in sorted(OPTIONS)
    if c != "cartpole" or o == "shift"])
def test_plain_loop_matches_port_closed_loop(case, option):
    """The fused loop's plain version against the port's own float32
    closed_loop (admm.solve step by step), at check_termination 5: the same
    float32 operations on the CPU, only the layout differs, so exact counts
    and solved flags, and xs and us to 1e-6 -- scaled by the largest row
    sum of |Kinf| where that passes 1, relative as well as absolute.
    torch's CPU matmul picks its kernel by shape, so Kinf x sums in another
    order in each layout at these pairs; the feedback gain carries a
    one-ulp difference in x into u (cartpole's gain 28.3: up to 1.05e-5 in
    u; the rocket's 16.0 with |u| near 80, where an ulp is 7.6e-6: up to
    3.05e-5), and 100 iterations add up what a step leaves."""
    pt = _port(_jax_problem(case, ct=5))
    tol = 1e-6 * max(1.0, pt.cache.Kinf.abs().sum(1).max().item())
    x0, xref, Uref = (None if a is None else torch.as_tensor(a)
                      for a in _inputs(case))
    opts = OPTIONS[option]
    xs_f, us_f, it_f, sv_f = closed_loop_fused_reference(pt, xref, x0, T,
                                                         Uref, **opts)
    xs_r, us_r, it_r, sv_r, _ = tt.closed_loop(
        pt, tt.init_state(pt, (B,)), x0, xref, T, Uref, **opts)
    np.testing.assert_array_equal(it_f.numpy(), it_r.numpy())
    np.testing.assert_array_equal(sv_f.numpy(), sv_r.numpy())
    np.testing.assert_allclose(xs_f.numpy(), xs_r.numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(us_f.numpy(), us_r.numpy(), rtol=tol,
                               atol=tol)


# ---------------------------------------------------- support, refusals

def _synthetic(nx, nu, **settings):
    s = tt.systems.synthetic(nx, nu)
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, **settings)


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_supported_at_the_thread_pairs_box_only_fixed_rho(case):
    """Box-only fixed-rho problems are taken at the six pairs; adaptive rho
    and an enabled cone are still refused there, as in the JAX loop."""
    pt = _port(_jax_problem(case))
    assert closed_loop_fused_supported(pt)
    assert (pt.spec.nx, pt.spec.nu) in cl.THREAD_LOOP_DIMS
    assert not closed_loop_fused_supported(
        tt.with_settings(pt, adaptive_rho=True))
    nx = pt.spec.nx
    cone = tt.with_cones(pt, state_cones=[(0, nx, 0.5)])
    assert not closed_loop_fused_supported(cone)
    with pytest.raises(ValueError, match="box-constraint"):
        closed_loop_fused(cone, torch.zeros((N, nx)), torch.zeros((2, nx)),
                          2)


@pytest.mark.parametrize("dims", [(32, 8), (5, 2)])
def test_pairs_off_both_lists_are_refused(dims):
    """(32, 8) and a pair off both lists are refused with both lists and
    the ROADMAP item that will add them; nothing falls back to the plain
    version."""
    p = _synthetic(*dims)
    assert not closed_loop_fused_supported(p)
    for run in (closed_loop_fused, closed_loop_fused_reference):
        with pytest.raises(ValueError, match=r"closed-loop kernels' "
                           r"instantiations: \(\(12, 4\),\) on thread "
                           r"groups, \(\(6, 3\),.*\(1, 1\)\) on one thread "
                           r"a plant.*Queue 2 item 1c"):
            run(p, torch.zeros((N, dims[0])), torch.zeros((2, dims[0])), 2)


# ------------------------------------------------------------ the route

class _OnCard:
    """A CPU tensor that reports a CUDA device: the route reads only the
    device of x0 before it hands the launch its arguments."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda")


@pytest.fixture
def on_card(monkeypatch):
    """closed_loop_fused with x0 on a (reported) CUDA device: both launches
    recorded by stand-ins, the plain version forbidden."""
    calls = []
    prepare = cl._prepare_loop

    def prepare_on_card(*a):
        tables, xtot, x0, T_, params = prepare(*a)
        return tables, xtot, _OnCard(x0), T_, params

    def launch(kind):
        def fn(tables, xtot, x0, T_, N_, nx, nu, **opts):
            assert isinstance(x0, _OnCard)
            calls.append((kind, nx, nu))
            return "launched"
        return fn

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(cl, "_prepare_loop", prepare_on_card)
    monkeypatch.setattr(cl, "_loop_kernel", launch("group"))
    monkeypatch.setattr(cl, "_loop_thread_kernel", launch("thread"))
    monkeypatch.setattr(cl, "_loop_plain", plain)
    return calls


def _quad():
    s = tt.systems.quadrotor_20hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=20, check_termination=5)


def test_route_takes_each_pairs_kernel(on_card):
    """(12, 4) reaches the thread-group entry, the six pairs the
    one-thread entry, and the private pin the one-thread entry at (12, 4);
    nothing falls back to the plain version on a CUDA tensor."""
    probs = [("quad", _quad())] + [(c, _port(_jax_problem(c)))
                                   for c in sorted(PAIRS)]
    for case, p in probs:
        nx = p.spec.nx
        assert closed_loop_fused(p, torch.zeros((N, nx)),
                                 torch.zeros((3, nx)), 2) == "launched"
    assert on_card == [("group", 12, 4)] + [
        ("thread",) + PAIRS[c] for c in sorted(PAIRS)]
    on_card.clear()
    cl._closed_loop_fused(_quad(), torch.zeros((N, 12)),
                          torch.zeros((3, 12)), 2, thread=True)
    assert on_card == [("thread", 12, 4)]


# ------------------------------------------------------- the launch glue

@pytest.fixture
def no_device(monkeypatch):
    """The launch glue's CUDA calls stubbed for CPU tensors, the counters
    this process's own."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(cl, "launch_count", 0)
    monkeypatch.setattr(cl, "launch_counts", dict.fromkeys(cl.launch_counts,
                                                           0))


def _thread_stand_in(calls):
    """A stand-in for tinympc_closed_loop_thread_box: the plain loop run on
    the inputs it reads through its pointers, the outputs written through
    theirs; the seven scratch arrays must be distinct buffers."""
    def fn(nx, nu, N_, B_, T_, max_iter, ct, rho, tol_pri, tol_dua, reset,
           shift, tables, xref, x0, *rest):
        scratch, outs, stream = rest[:7], rest[7:11], rest[11]
        calls.append(dict(nx=nx, nu=nu, N=N_, B=B_, T=T_, reset=reset,
                          shift=shift, scratch=len(set(scratch)),
                          stream=stream))
        from tinympc_tpu_torch.kernels.admm_fused import _table_slice
        n_tab = _table_slice("umax", nx, nu, N_).stop
        got = cl._loop_plain(
            _view(tables, (n_tab,)).clone(),
            _view(xref, (T_ + N_ - 1, nx)).clone(),
            _view(x0, (B_, nx)).clone(), T_, N_, nx, nu,
            reset_duals=bool(reset), shift_warm=bool(shift),
            max_iter=max_iter, ct=ct, rho=rho, tol_pri=tol_pri,
            tol_dua=tol_dua)
        shapes = [((T_, B_, nx), ctypes.c_float), ((T_, B_, nu),
                                                   ctypes.c_float),
                  ((T_, B_), ctypes.c_int32), ((T_, B_), ctypes.c_bool)]
        for ptr, (shape, ctype), value in zip(outs, shapes, got):
            _view(ptr, shape, ctype).copy_(value)
        return 0
    return fn


@pytest.mark.parametrize("case,option", [("rocket", "shift"),
                                         ("1x1", "reset"),
                                         ("cartpole", "fixed")])
def test_thread_launch_glue_matches_the_plain_loop(case, option, no_device,
                                                   monkeypatch):
    """The one-thread launch, its arguments in
    tinympc_closed_loop_thread_box's order, against the stand-in: the
    outputs bitwise the plain loop's, the seven lane-last scratch arrays
    allocated ((2, N, nx, B) and (2, N-1, nu, B) slack halves, g and the
    stale slack (N, nx, B), y, the stale slack and d (N-1, nu, B)), one
    launch counted on the thread kernel."""
    calls = []
    monkeypatch.setattr(cl, "_thread_kernel_fn",
                        lambda: _thread_stand_in(calls))
    pt = _port(_jax_problem(case, ct=5))
    nx, nu = PAIRS[case]
    x0, xref, Uref = (None if a is None else torch.as_tensor(a)
                      for a in _inputs(case))
    args = cl._prepare_loop(pt, xref, x0, T, Uref)
    tables, xtot, x0c, T_, params = args
    seen = []
    empty = torch.empty

    def record(*shape, **kw):
        t = empty(*shape, **kw)
        seen.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", record)
    opts = dict(params, reset_duals=option == "reset",
                shift_warm=option == "shift")
    got = cl._loop_thread_kernel(tables, xtot, x0c, T_, N, nx, nu, **opts)
    monkeypatch.setattr(torch, "empty", empty)
    want = cl._loop_plain(tables, xtot, x0c, T_, N, nx, nu, **opts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert seen == [(2, N, nx, B), (2, N - 1, nu, B), (N, nx, B),
                    (N - 1, nu, B), (N, nx, B), (N - 1, nu, B),
                    (N - 1, nu, B), (T, B, nx), (T, B, nu), (T, B), (T, B)]
    assert calls == [dict(nx=nx, nu=nu, N=N, B=B, T=T,
                          reset=int(option == "reset"),
                          shift=int(option == "shift"), scratch=7,
                          stream=None)]
    assert cl.launch_count == 1
    assert cl.launch_counts == {cl.KERNEL: 0, cl.THREAD_KERNEL: 1}


def test_a_failed_build_or_launch_raises(no_device, monkeypatch):
    """On the card a failed build or launch raises: nothing falls back to
    the plain version or counts a launch."""
    pt = _port(_jax_problem("2x1"))
    x0, xref, _ = (None if a is None else torch.as_tensor(a)
                   for a in _inputs("2x1"))
    tables, xtot, x0c, T_, params = cl._prepare_loop(pt, xref, x0, T, None)
    opts = dict(params, reset_duals=False, shift_warm=False)
    load = cl._thread_kernel_fn.__wrapped__
    monkeypatch.setattr(cl, "_thread_kernel_fn", lambda: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cl._loop_thread_kernel(tables, xtot, x0c, T_, N, 2, 1, **opts)

    def no_nvcc(name):
        raise RuntimeError("nvcc failed for " + name)

    monkeypatch.setattr(cl, "_thread_kernel_fn", load)
    monkeypatch.setattr(cl._build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed for "
                       "closed_loop_thread"):
        cl._loop_thread_kernel(tables, xtot, x0c, T_, N, 2, 1, **opts)
    assert cl.launch_count == 0 and not any(cl.launch_counts.values())


class _Library:
    """A stand-in for the loaded csrc/closed_loop_thread.cu library."""

    def __init__(self, block=cl.THREAD_BLOCK, missing=()):
        self.tinympc_closed_loop_thread_block = lambda: block
        self.tinympc_closed_loop_thread_has = \
            lambda nx, nu: int((nx, nu) not in missing)
        self.tinympc_closed_loop_thread_box = lambda *a: 0


@pytest.mark.parametrize("lib,error", [
    (_Library(), None), (_Library(block=64), "block size"),
    (_Library(missing=((6, 3),)), r"instantiate \[\(6, 3\)\]"),
    (_Library(missing=((12, 4),)), r"instantiate \[\(12, 4\)\]")])
def test_loading_holds_the_library_to_the_wrapper(lib, error, monkeypatch):
    """The loader holds the library's block and its pairs (the six and the
    A/B's (12, 4)) against the wrapper's before any launch."""
    monkeypatch.setattr(cl._build, "load", lambda name: lib)
    load = cl._thread_kernel_fn.__wrapped__
    if error is None:
        assert load() is lib.tinympc_closed_loop_thread_box
    else:
        with pytest.raises(RuntimeError, match=error):
            load()
