"""The port's closed loops: the plain ``closed_loop`` (on ``admm.solve``)
against ``tinympc_tpu.closed_loop`` in float64 and against the reference
goldens, and the fused closed loop's plain PyTorch version (what
``closed_loop_fused`` runs on CPU tensors, and what the CUDA kernel is held
against on the card) against the JAX package's fused Pallas kernel in
interpret mode and against the port's own ``closed_loop``.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the GPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.closed_loop import closed_loop as jax_closed_loop
from tinympc_tpu.kernels import closed_loop_fused as jax_closed_loop_fused

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import problem_from_numpy, problem_to_numpy
from tinympc_tpu_torch.kernels import (closed_loop_fused,
                                       closed_loop_fused_reference,
                                       closed_loop_fused_supported)

from helpers import load_golden, steps_array

torch.set_num_threads(1)

N = 10
LINE = "quadrotor_20hz_y_axis_line"


def _jax_problem(dtype, max_iter, ct=1):
    s = systems.quadrotor_20hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype)
    prob = tm.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tm.with_settings(prob, max_iter=max_iter, check_termination=ct)


def _port(pj, dtype):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", dtype)


def _hover(z):
    return np.tile([0, 0, z] + [0.0] * 9, (N, 1))


# The four closed loops of tests/test_closed_loop_fused.py: (name, max_iter,
# check_termination, Xref_total, x0 seed and spread, reset_duals,
# shift_warm). "mixed" starves the budget so every step mixes converged and
# max-iter lanes.
def _case(name):
    line = np.asarray(systems.trajectory(LINE))
    return {
        "fixed": (25, 1, _hover(0.5), 0, 0.2, np.zeros(12), False, False),
        "mixed": (8, 1, line, 3, 0.3, line[0], False, False),
        "reset": (20, 1, line, 1, 0.05, line[0], True, False),
        "shift": (25, 5, _hover(0.5), 0, 0.2, np.zeros(12), False, True),
    }[name]


def _case_inputs(name, B, dtype):
    mi, ct, xref, seed, spread, centre, reset, shift = _case(name)
    x0 = centre + np.random.default_rng(seed).uniform(-spread, spread,
                                                      (B, 12))
    return (mi, ct, xref.astype(dtype), x0.astype(dtype),
            dict(reset_duals=reset, shift_warm=shift))


@pytest.mark.parametrize("case", ["fixed", "reset", "shift", "clamped"])
def test_closed_loop_matches_jax_closed_loop_float64(case):
    """float64 both sides, the same problem arrays: exact per-step
    iteration counts and solved flags, 1e-6 on xs and us (the parity bar
    of tests/test_parity.py). "clamped" hands in a trajectory of N+3 rows
    for 10 steps, so the window's start clamps at 3 from step 3 on."""
    B, T = 4, 10
    if case == "clamped":
        mi, ct, xref, x0, opts = _case_inputs("reset", B, np.float64)
        xref, opts = xref[:N + 3], {}
    else:
        mi, ct, xref, x0, opts = _case_inputs(case, B, np.float64)
    pj = _jax_problem(jnp.float64, max(mi, 40), ct)
    pt = _port(pj, torch.float64)
    xs_j, us_j, it_j, sv_j, _ = jax_closed_loop(
        pj, tm.init_state(pj, (B,)), jnp.asarray(x0), jnp.asarray(xref), T,
        **opts)
    xs_t, us_t, it_t, sv_t, st = tt.closed_loop(
        pt, tt.init_state(pt, (B,)), torch.as_tensor(x0),
        torch.as_tensor(xref), T, **opts)
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-6)
    assert xs_t.shape == (T, B, 12) and us_t.shape == (T, B, 4)
    assert it_t.dtype == torch.int32 and sv_t.dtype == torch.bool


def _check_golden(rec, name):
    """tests/test_parity.py:_check's bar on the first n steps: 1e-6 on the
    states and first inputs, exact iteration counts and solved flags."""
    g = load_golden(name)
    n = len(rec["iter"])
    np.testing.assert_allclose(rec["x0"], steps_array(g, "x0")[:n],
                               atol=1e-6, err_msg=f"{name}: x0")
    np.testing.assert_allclose(rec["u0"], steps_array(g, "u0")[:n],
                               atol=1e-6, err_msg=f"{name}: u0")
    np.testing.assert_array_equal(rec["iter"], steps_array(g, "iter")[:n])
    np.testing.assert_array_equal(rec["solved"],
                                  steps_array(g, "solved")[:n])


def _port_quadrotor():
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=torch.float64, device="cpu")
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=100)


@pytest.mark.parametrize("name", ["quadrotor_hovering", "quadrotor_tracking"])
def test_closed_loop_replays_golden_prefix(name):
    """The reference demos (examples/quadrotor_hovering.cpp and
    quadrotor_tracking.cpp, as examples/scenarios.py replays them) through
    the port's closed_loop, unbatched float64, first 40 steps."""
    prob = _port_quadrotor()
    if name == "quadrotor_hovering":
        x0 = torch.tensor([0, 1, 0, 0.2, 0, 0, 0.1, 0, 0, 0, 0, 0],
                          dtype=torch.float64)
        xref, opts = torch.as_tensor(_hover(2.0)), {}
    else:
        xref = torch.as_tensor(np.asarray(systems.trajectory(LINE)))
        x0, opts = xref[0], dict(reset_duals=True)
    xs, us, it, sv, _ = tt.closed_loop(prob, tt.init_state(prob), x0, xref,
                                       40, **opts)
    _check_golden(dict(x0=xs.numpy(), u0=us.numpy(), iter=it.numpy(),
                       solved=sv.numpy()), name)


def test_shift_state_semantics():
    """Time rows roll by one with the last repeated; per-problem scalars
    pass through (tests/test_closed_loop_fused.py:119-144)."""
    prob = _port_quadrotor()
    st = tt.init_state(prob, (3,))
    marked = st.replace(x=torch.arange(N * 3 * 12, dtype=torch.float64)
                        .reshape(N, 3, 12),
                        y=torch.arange((N - 1) * 3 * 4, dtype=torch.float64)
                        .reshape(N - 1, 3, 4),
                        iter=torch.tensor([1, 2, 3], dtype=torch.int32))
    sh = tt.shift_state(marked)
    for k in ("x", "y"):
        a, b = getattr(marked, k), getattr(sh, k)
        assert torch.equal(b[:-1], a[1:]) and torch.equal(b[-1], a[-1])
    assert sh.iter is marked.iter


@pytest.mark.parametrize("case", ["fixed", "shift"])
def test_plain_fused_loop_matches_jax_fused_kernel(case):
    """The fixed-window and shift-warm loops of
    tests/test_closed_loop_fused.py through both fused closed loops on the
    same float32 problem. That file's bar: atol 1e-4 on xs and us (float32
    sums in another order on each side, fed back through the plant over
    the steps), at least 90% equal iteration counts."""
    B, T = 8, 10
    mi, ct, xref, x0, opts = _case_inputs(case, B, np.float32)
    pj = _jax_problem(jnp.float32, mi, ct)
    xs_j, us_j, it_j, sv_j = jax_closed_loop_fused(
        pj, jnp.asarray(xref), jnp.asarray(x0), T, tile=B, interpret=True,
        **opts)
    xs_t, us_t, it_t, sv_t = closed_loop_fused_reference(
        _port(pj, torch.float32), torch.as_tensor(xref),
        torch.as_tensor(x0), T, **opts)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-4)
    assert np.mean(it_t.numpy() == np.asarray(it_j)) >= 0.9


@pytest.mark.parametrize("case", ["fixed", "mixed", "reset", "shift"])
def test_plain_fused_loop_matches_port_closed_loop(case):
    """The fused loop's plain version against the port's own float32
    closed_loop (admm.solve step by step): the same float32 operations in
    the same order on the CPU, only the layout differs, so exact counts and
    solved flags and 1e-6 -- including the starved max_iter=8 loop whose
    steps mix converged and max-iter lanes."""
    B, T = 8, 10
    mi, ct, xref, x0, opts = _case_inputs(case, B, np.float32)
    pt = _port(_jax_problem(jnp.float32, mi, ct), torch.float32)
    xref, x0 = torch.as_tensor(xref), torch.as_tensor(x0)
    xs_f, us_f, it_f, sv_f = closed_loop_fused_reference(pt, xref, x0, T,
                                                         **opts)
    xs_r, us_r, it_r, sv_r, _ = tt.closed_loop(
        pt, tt.init_state(pt, (B,)), x0, xref, T, **opts)
    np.testing.assert_array_equal(it_f.numpy(), it_r.numpy())
    np.testing.assert_array_equal(sv_f.numpy(), sv_r.numpy())
    np.testing.assert_allclose(xs_f.numpy(), xs_r.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(us_f.numpy(), us_r.numpy(), rtol=0,
                               atol=1e-6)
    if case == "mixed":
        assert sv_r.any() and not sv_r.all()


def test_closed_loop_fused_on_cpu_runs_the_plain_version_in_public_layout():
    pt = _port(_jax_problem(jnp.float32, 20, 5), torch.float32)
    B, T = 5, 4
    _, _, xref, x0, _ = _case_inputs("fixed", B, np.float32)
    xref, x0 = torch.as_tensor(xref), torch.as_tensor(x0)
    out = closed_loop_fused(pt, xref, x0, T, shift_warm=True)
    ref = closed_loop_fused_reference(pt, xref, x0, T, shift_warm=True)
    xs, us, it, sv = out
    assert xs.shape == (T, B, 12) and us.shape == (T, B, 4)
    assert it.shape == (T, B) and it.dtype == torch.int32
    assert sv.shape == (T, B) and sv.dtype == torch.bool
    assert xs.dtype == us.dtype == torch.float32
    assert torch.equal(xs[0], x0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_closed_loop_fused_checks_its_inputs():
    pt = _port(_jax_problem(jnp.float32, 20, 5), torch.float32)
    assert closed_loop_fused_supported(pt)
    x0 = torch.zeros((3, 12))
    line = torch.as_tensor(np.asarray(systems.trajectory(LINE)),
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="n_steps"):
        closed_loop_fused(pt, line[:N + 2], x0, 4)      # needs N + 3 rows
    closed_loop_fused(pt, line[:N + 3], x0, 4)
    with pytest.raises(ValueError):
        closed_loop_fused(tt.with_settings(pt, max_iter=0), line, x0, 4)
    soc = pt.replace(spec=dataclasses.replace(
        pt.spec, en_state_soc=True, state_cones=((0, 3),)))
    adaptive = tt.with_settings(pt, adaptive_rho=True)
    for bad in (soc, adaptive):
        assert not closed_loop_fused_supported(bad)
        with pytest.raises(ValueError):
            closed_loop_fused(bad, line, x0, 4)
