"""Problem construction of the PyTorch port against the JAX package:
fixtures, the Riccati cache, and the tables of setup/with_bounds/
with_settings. Everything in float64 on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinympc_tpu as tm
from tinympc_tpu import systems
from tinympc_tpu.riccati import precompute_cache as jax_precompute_cache

import tinympc_tpu_torch as tt

torch.set_num_threads(1)

CACHE_KEYS = ("Kinf", "Pinf", "Quu_inv", "AmBKt", "APf", "BPf")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("name", ["cartpole", "quadrotor_20hz",
                                  "quadrotor_50hz", "rocket_landing_20hz"])
def test_port_fixtures_equal_jax_fixtures(name):
    mine, ref = getattr(tt.systems, name)(), getattr(systems, name)()
    assert mine.keys() == ref.keys()
    for k in ("A", "B", "f", "Qdiag", "Rdiag"):
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    assert mine["rho"] == ref["rho"]


@pytest.mark.parametrize("name", ["cartpole", "quadrotor_20hz",
                                  "rocket_landing_20hz", "quadrotor_50hz"])
def test_precompute_cache_matches_jax(name):
    """Both packages iterate the same float64 recursion (LU solves in
    both), so the caches agree to round-off: 1e-10 absolute on entries up
    to ~2e4 (Pinf)."""
    s = getattr(systems, name)()
    rho = s["rho"]
    args = (s["A"], s["B"], s["f"], s["Qdiag"] + rho, s["Rdiag"] + rho)
    ref = jax_precompute_cache(*(jnp.asarray(a) for a in args), rho)
    mine = tt.precompute_cache(*(_t(a) for a in args), rho)
    for k in CACHE_KEYS:
        np.testing.assert_allclose(getattr(mine, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=1e-10, err_msg=k)
    assert float(mine.rho) == float(ref.rho)
    # C1/C2 alias Quu_inv/AmBKt (tiny_api.cpp:375-376)
    np.testing.assert_array_equal(mine.C1.numpy(), mine.Quu_inv.numpy())
    np.testing.assert_array_equal(mine.C2.numpy(), mine.AmBKt.numpy())


def _both(N=8, **bounds):
    s = systems.quadrotor_20hz()
    ref = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                   N=N, dtype=jnp.float64)
    mine = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=torch.float64, device="cpu")
    if bounds:
        ref = tm.with_bounds(ref, **bounds)
        mine = tt.with_bounds(mine, **bounds)
    return ref, mine


def _assert_tables_equal(ref, mine):
    for k in ("A", "B", "f", "Qdiag", "Rdiag"):
        np.testing.assert_allclose(getattr(mine, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    for k in ("x_min", "x_max", "u_min", "u_max"):
        np.testing.assert_array_equal(getattr(mine.cons, k).numpy(),
                                      np.asarray(getattr(ref.cons, k)),
                                      err_msg=k)
    assert dataclasses.asdict(mine.spec) == dataclasses.asdict(ref.spec)
    assert dataclasses.asdict(mine.settings) == \
        dataclasses.asdict(ref.settings)


def test_setup_defaults_match_jax():
    """Default bounds are +-inf; Qdiag/Rdiag hold Q+rho / R+rho."""
    ref, mine = _both()
    _assert_tables_equal(ref, mine)
    assert torch.isinf(mine.cons.x_min).all() and (mine.cons.x_min < 0).all()
    assert mine.dtype == torch.float64 and mine.device.type == "cpu"


@pytest.mark.parametrize("bounds", [
    dict(x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5),
    dict(x_min=np.linspace(-6, -1, 12), u_max=np.full(4, 0.25)),
    dict(x_max=np.tile(np.arange(12.0), (8, 1)),
         u_min=-np.ones((7, 4))),
], ids=["scalars", "rows", "tables"])
def test_with_bounds_matches_jax(bounds):
    """Scalars and (nx,) rows broadcast over the horizon like the JAX
    package; full (N, nx) tables pass through."""
    ref, mine = _both(**bounds)
    _assert_tables_equal(ref, mine)


def test_with_settings_round_trips():
    ref, mine = _both(x_min=-5.0, x_max=5.0)
    kw = dict(max_iter=37, check_termination=5, abs_pri_tol=2e-3,
              matmul_precision="high", coarse_iters=3)
    ref, mine = tm.with_settings(ref, **kw), tt.with_settings(mine, **kw)
    _assert_tables_equal(ref, mine)
    with pytest.raises(ValueError):
        tt.with_settings(mine, coarse_iters=-1)


def test_init_state_shapes_and_device():
    _, mine = _both()
    st = tt.init_state(mine, (2, 3))
    assert st.x.shape == (8, 2, 3, 12) and st.u.shape == (7, 2, 3, 4)
    assert st.iter.shape == (2, 3) and st.iter.dtype == torch.int32
    assert st.solved.dtype == torch.bool
    assert st.x.dtype == torch.float64 and st.x.device.type == "cpu"
