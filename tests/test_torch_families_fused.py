"""The fused solve with the constraint families beyond the box, cold and
warm: its plain PyTorch version (what ``solve_fused`` and
``solve_fused_warm`` run on CPU tensors, and what the families CUDA kernel
is held against on the card) against the JAX package's fused Pallas kernel
in interpret mode, as tests/test_fused_kernel.py:57-135 and :172 run it,
and against the port's own ``admm.solve``.

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
from tinympc_tpu.kernels import init_carry as jax_init_carry
from tinympc_tpu.kernels import solve_fused as jax_solve_fused
from tinympc_tpu.kernels import solve_fused_warm as jax_solve_fused_warm

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                       problem_from_numpy, problem_to_numpy)
from tinympc_tpu_torch.kernels import (fused_supported, init_carry,
                                       shift_carry, solve_fused,
                                       solve_fused_reference,
                                       solve_fused_warm,
                                       solve_fused_warm_reference)
from tinympc_tpu_torch.kernels import admm_fused
from tinympc_tpu_torch.kernels.admm_fused import (_pack_tables,
                                                  _table_slice,
                                                  _unpack_tables)
from tinympc_tpu_torch.projections import project_hyperplane_if_violated

torch.set_num_threads(1)

N = 10
XINIT = np.array([4, 2, 20, -3, 2, -4.5])


# Ceilings on z lower than the demos' (3, and 1.1 .. 3), so that the state
# hyperplanes bite within the first iterations, as the thrust limit does.
ZMAX = 1.1
TV_ZMAX = 1.02 + 0.01 * np.arange(N)


def _jax_problem(case, max_iter):
    """The float32 configurations of tests/test_fused_kernel.py:57-135:
    the rocket with cones and box ("soc"), the quadrotor demos' static
    ("linear") and time-varying ("tv") hyperplanes with the box off, with
    the ceilings lowered to ZMAX and TV_ZMAX."""
    if case == "soc":
        s = systems.rocket_landing_20hz()
        prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                        N=N, f=s["f"], dtype=jnp.float32)
        prob = tm.with_bounds(
            prob, x_min=np.tile([-5, -5, -0.5, -10, -10, -20.], (N, 1)),
            x_max=np.tile([5, 5, 100, 10, 10, 20.], (N, 1)), u_min=-10.0,
            u_max=105.0)
        prob = tm.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
        return tm.with_settings(prob, max_iter=max_iter, abs_pri_tol=2e-3)
    s = systems.quadrotor_50hz()
    prob = tm.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=jnp.float32)
    if case == "linear":
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        prob = tm.with_linear_constraints(prob, Ax, [ZMAX], np.ones((1, 4)),
                                          [6.0])
    else:
        Ax = np.zeros((N, 1, 12))
        Ax[:, 0, 2] = 1.0
        prob = tm.with_tv_linear_constraints(
            prob, Ax, TV_ZMAX.reshape(N, 1), np.ones((N - 1, 1, 4)),
            np.full((N - 1, 1), 6.0))
    prob = tm.with_settings(prob, max_iter=max_iter)
    return prob.replace(spec=dataclasses.replace(
        prob.spec, en_state_bound=False, en_input_bound=False))


def _port(pj):
    return problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float32)


def _inputs(case, B, seed, t=0):
    """x0s (B, nx), Xref, Uref as float32 numpy; ``t`` moves the rocket's
    reference window t steps along."""
    rng = np.random.default_rng(seed)
    if case == "soc":
        x0 = XINIT * (1 + 0.1 * rng.uniform(-1, 1, (B, 6)))
        Xref = XINIT * (1 - (np.arange(N)[:, None] + t) / 99.0)
        Uref = np.zeros((N - 1, 3))
        Uref[:, 2] = 10.0
    else:
        start = np.asarray([-2.0, -2.0, 1.0] + [0.0] * 9)
        x0 = start + 0.1 * rng.uniform(-1, 1, (B, 12))
        # The demo's step-0 window (examples/scenarios.py:157-158).
        alpha = np.arange(N)[:, None] / 49.0
        Xref = (1 - alpha) * start + alpha * np.asarray([2.0, 2.0, 4.0]
                                                        + [0.0] * 9)
        Uref = None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(x0), f32(Xref), f32(Uref)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


BAR = {"soc": 2e-4, "linear": 1e-4, "tv": 1e-4}


@pytest.mark.parametrize("case", ["soc", "linear", "tv"])
def test_plain_cold_matches_jax_fused_kernel(case):
    """The same float32 problem through both fused cold solves, B=8,
    max_iter 20. Bar of tests/test_fused_kernel.py: atol 1e-4 on x, u and
    the residuals (2e-4 on the rocket), counts within 1, equal solved
    flags. Witness that the difference is rounding: the
    port's float32 solve is no further from a float64 solve of the same
    problem than the JAX kernel's is, less 1e-5."""
    pj = _jax_problem(case, 20)
    x0, Xref, Uref = _inputs(case, 8, seed=1)
    sol_j, res_j = jax_solve_fused(pj, _j(Xref), _j(Uref), _j(x0), tile=8,
                                   interpret=True)
    sol_t, res_t = solve_fused_reference(_port(pj), _t(Xref), _t(Uref),
                                         _t(x0))
    atol = BAR[case]
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=0,
                               atol=atol)
    p64 = problem_from_numpy(problem_to_numpy(pj), "cpu", torch.float64)
    d64 = lambda a: None if a is None else torch.as_tensor(a, dtype=torch
                                                           .float64)
    x64 = tt.solve(p64, tt.init_state(p64, (8,)), d64(Xref), d64(Uref),
                   d64(x0))[0].x.numpy()
    assert np.abs(sol_t.x.numpy() - x64).max() \
        <= np.abs(np.asarray(sol_j.x) - x64).max() + 1e-5
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=0,
                               atol=atol)
    assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter)) <= 1)
    np.testing.assert_array_equal(sol_t.solved.numpy(),
                                  np.asarray(sol_j.solved))


@pytest.mark.parametrize("case", ["soc", "linear", "tv"])
def test_plain_cold_matches_port_admm_solve(case):
    """The kernel-layout plain version against the port's admm.solve on the
    same float32 problem: the same float32 operations, the family sums in
    the same order, only the layout (and so the matrix products' summation
    order) differs, so exact counts and 1e-6 -- relative to the value
    where it is above 1, as the rocket's thrust of ~60 is."""
    pt = _port(_jax_problem(case, 60))
    x0, Xref, Uref = (_t(a) for a in _inputs(case, 16, seed=2))
    sol_f, res_f = solve_fused_reference(pt, Xref, Uref, x0)
    sol_s, st, _ = tt.solve(pt, tt.init_state(pt, (16,)), Xref, Uref, x0)
    np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
    np.testing.assert_array_equal(sol_f.solved.numpy(), sol_s.solved.numpy())
    np.testing.assert_allclose(sol_f.x.numpy(), sol_s.x.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sol_f.u.numpy(), sol_s.u.numpy(), rtol=1e-6,
                               atol=1e-6)
    res_s = torch.stack([st.pri_res_state, st.pri_res_input,
                         st.dua_res_state, st.dua_res_input])
    np.testing.assert_allclose(res_f.numpy(), res_s.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["soc", "tv"])
def test_plain_warm_matches_jax_warm_kernel(case):
    """A warm sequence of 2 solves (B=8, max_iter 20, the rocket's
    reference sliding a step each solve) through both fused warm solves,
    each with its own carry: the family duals and x/u ride the carry. Bar
    of tests/test_fused_kernel.py: atol 1e-4 (2e-4 on the rocket) on u and
    on the carry's g, family duals, x and u, counts within 1, equal solved
    flags."""
    pj = _jax_problem(case, 20)
    pt = _port(pj)
    B = 8
    x0 = _inputs(case, B, seed=3)[0]
    cj, ct_ = jax_init_carry(pj, B), init_carry(pt, B)
    dual = "gc" if case == "soc" else "gtv"
    assert getattr(ct_, dual) is not None and ct_.x is not None
    atol = BAR[case]
    A, Bm, f = (np.asarray(getattr(pj, k), np.float32) for k in ("A", "B",
                                                                  "f"))
    for t in range(2):
        _, Xref, Uref = _inputs(case, B, seed=3, t=t)
        sol_j, _, cj = jax_solve_fused_warm(pj, _j(Xref), _j(Uref), _j(x0),
                                            cj, tile=B, interpret=True)
        sol_t, _, ct_ = solve_fused_warm_reference(pt, _t(Xref), _t(Uref),
                                                   _t(x0), ct_)
        np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u),
                                   rtol=0, atol=atol)
        assert np.all(np.abs(sol_t.iter.numpy() - np.asarray(sol_j.iter))
                      <= 1)
        np.testing.assert_array_equal(sol_t.solved.numpy(),
                                      np.asarray(sol_j.solved))
        for k in ("g", dual, "x", "u"):
            np.testing.assert_allclose(getattr(ct_, k).numpy(),
                                       np.asarray(getattr(cj, k)),
                                       rtol=0, atol=atol, err_msg=k)
        x0 = (x0 @ A.T + np.asarray(sol_j.u[0]) @ Bm.T + f).astype(
            np.float32)


@pytest.mark.parametrize("case,max_iter", [("soc", 15), ("tv", 20)])
def test_plain_warm_matches_port_admm_solve_sequence(case, max_iter):
    """The warm sequence against a warm-started admm.solve sequence: exact
    counts, and 1e-6 absolute or 5e-6 relative (the rocket's thrust of ~60
    drifts a dozen float32 ulps over three solves of products summed in
    two orders) on u and on every carry field against the state's (the
    family duals, and x/u against the state's x/u). The rocket's max_iter
    mixes converged and max-iter lanes; the quadrotor under its low tv
    ceiling runs every lane to max_iter."""
    pt = _port(_jax_problem(case, max_iter))
    B = 8
    x0 = _t(_inputs(case, B, seed=4)[0])
    state, carry = tt.init_state(pt, (B,)), init_carry(pt, B)
    names = dict(gc="gc", yc="yc", gtv="gl_tv", ytv="yl_tv")
    saw_mixed = False
    for t in range(3):
        _, Xref, Uref = (_t(a) for a in _inputs(case, B, seed=4, t=t))
        sol_s, state, _ = tt.solve(pt, state, Xref, Uref, x0)
        sol_f, _, carry = solve_fused_warm_reference(pt, Xref, Uref, x0,
                                                     carry)
        np.testing.assert_array_equal(sol_f.iter.numpy(), sol_s.iter.numpy())
        np.testing.assert_allclose(sol_f.u.numpy(), sol_s.u.numpy(),
                                   rtol=5e-6, atol=1e-6)
        fields = [("vnew", "vnew"), ("g", "g"), ("v", "v"), ("x", "x"),
                  ("u", "u")] + [(k, v) for k, v in names.items()
                                 if getattr(carry, k) is not None]
        for ck, sk in fields:
            np.testing.assert_allclose(
                getattr(carry, ck).permute(0, 2, 1).numpy(),
                getattr(state, sk).numpy(), rtol=5e-6, atol=1e-6, err_msg=ck)
        sv = sol_s.solved.numpy()
        saw_mixed |= sv.any() and not sv.all()
        x0 = x0 @ pt.A.T + state.u[0] @ pt.B.T + pt.f
    assert saw_mixed or case == "tv"


def test_solve_fused_on_cpu_runs_the_plain_version_in_public_layout():
    """solve_fused and solve_fused_warm on CPU tensors are the plain
    versions, in the JAX package's layout; the carry carries exactly the
    problem's family fields and is not modified."""
    pt = _port(_jax_problem("soc", 15))
    x0, Xref, Uref = (_t(a) for a in _inputs("soc", 5, seed=5))
    sol, res = solve_fused(pt, Xref, Uref, x0)
    ref, ref_res = solve_fused_reference(pt, Xref, Uref, x0)
    assert sol.x.shape == (N, 5, 6) and sol.u.shape == (N - 1, 5, 3)
    for a, b in ((sol.x, ref.x), (sol.u, ref.u), (res, ref_res),
                 (sol.iter, ref.iter), (sol.solved, ref.solved)):
        assert torch.equal(a, b)
    c0 = init_carry(pt, 5)
    assert c0.gl is None and c0.gtv is None and c0.yl is None
    assert c0.gc.shape == (N, 6, 5) and c0.yc.shape == (N - 1, 3, 5)
    assert c0.x.shape == (N, 6, 5) and c0.u.shape == (N - 1, 3, 5)
    sol, _, c1 = solve_fused_warm(pt, Xref, Uref, x0, c0)
    ref, _, r1 = solve_fused_warm_reference(pt, Xref, Uref, x0, c0)
    for k in ("vnew", "g", "gc", "yc", "x", "u"):
        assert torch.equal(getattr(c1, k), getattr(r1, k))
        assert getattr(c1, k).dtype == torch.float32
    assert torch.equal(c1.x[0], x0.T)
    assert not c0.gc.any() and not c0.x.any()


def test_max_iter_zero_hands_the_families_carry_back():
    """max_iter=0 runs no iteration: the duals come back unchanged, the
    carried u unchanged and x with the new x0 in row 0 (the seed)."""
    pt = _port(_jax_problem("soc", 0))
    x0, Xref, Uref = (_t(a) for a in _inputs("soc", 4, seed=6))
    rng = np.random.default_rng(7)
    d = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in carry_to_numpy(init_carry(pt, 4)).items()}
    _, _, c1 = solve_fused_warm(pt, Xref, Uref, x0, carry_from_numpy(d, "cpu"))
    for k in ("gc", "yc", "g", "y", "u", "vnew"):
        np.testing.assert_array_equal(getattr(c1, k).numpy(), d[k],
                                      err_msg=k)
    np.testing.assert_array_equal(c1.x[1:].numpy(), d["x"][1:])
    assert torch.equal(c1.x[0], x0.T)


def test_shift_carry_shifts_the_family_fields():
    pt = _port(_jax_problem("tv", 5))
    c = init_carry(pt, 3)
    marked = c.replace(**{
        k: torch.arange(getattr(c, k).numel(), dtype=torch.float32)
        .reshape(getattr(c, k).shape) for k in ("gtv", "ytv", "x", "u")})
    sh = shift_carry(marked)
    for k in ("gtv", "ytv", "x", "u"):
        a, b = getattr(marked, k), getattr(sh, k)
        assert torch.equal(b[:-1], a[1:]) and torch.equal(b[-1], a[-1])
    assert sh.gc is None and sh.yl is None


def test_family_tables_follow_the_box_tables():
    """The box prefix of the packed table is byte for byte the box-only
    table (the closed loop sizes its table by the box part), and the family
    tables follow it."""
    pt = _port(_jax_problem("soc", 5))
    box = pt.replace(spec=dataclasses.replace(pt.spec, en_state_soc=False,
                                              en_input_soc=False))
    full, plain = _pack_tables(pt, None, None), _pack_tables(box, None, None)
    stop = _table_slice("umax", 6, 3, N).stop
    assert plain.numel() == stop
    assert torch.equal(full[:stop], plain)
    assert full[stop:].tolist() == [0.0, 3.0, 0.25, 0.0, 3.0, 0.5]


def test_hyperplane_norms_are_packed_once():
    """Each hyperplane's ||a||^2 sits in the packed table (asq_x, tv_asq_x,
    ...), summed in feature order from zero, and projecting with it gives
    the bits of projecting with the norm summed on the spot."""
    pt = _port(_jax_problem("linear", 5))
    lin = tt.with_tv_linear_constraints(
        pt, np.random.default_rng(8).normal(size=(N, 2, 12)),
        np.ones((N, 2)), np.random.default_rng(9).normal(size=(N - 1, 1, 4)),
        np.ones((N - 1, 1)))
    fam = admm_fused._families(lin.spec)
    assert fam[2:] == (1, 1, 2, 1)
    t = _unpack_tables(_pack_tables(lin, None, None), 12, 4, N, fam)
    for A, asq in (("Alin_x", "asq_x"), ("Alin_u", "asq_u"),
                   ("tv_Alin_x", "tv_asq_x"), ("tv_Alin_u", "tv_asq_u")):
        a = t[A]
        want = torch.zeros(a.shape[:-1])
        for j in range(a.shape[-1]):
            want = want + a[..., j] * a[..., j]
        assert torch.equal(t[asq], want), asq
    z = torch.as_tensor(np.random.default_rng(10).normal(size=(N, 7, 12)),
                        dtype=torch.float32)
    a, b = t["tv_Alin_x"][:, 1, None], t["tv_blin_x"][:, 1, None]
    assert torch.equal(
        project_hyperplane_if_violated(z, a, b, t["tv_asq_x"][:, 1, None]),
        project_hyperplane_if_violated(z, a, b))


@pytest.mark.parametrize("case", ["box", "soc", "tv"])
def test_launch_passes_each_family_its_arrays(case, monkeypatch):
    """The launch glue, against stand-ins for the C entry points of
    csrc/admm_group.cu: a problem with families takes
    tinympc_admm_group_families, with the family counts, the carried dual
    in and out of each family that is on (null for the others) and x/u in
    and out on a warm solve only, the box carry on a warm solve only, and
    the new carry with exactly the problem's fields. All zero counts at
    (12, 4) select the box-only solve's own entry, tinympc_admm_group,
    which takes the carry and no family arrays. No launch reaches
    csrc/admm_fused.cu."""
    if case == "box":
        s = tt.systems.quadrotor_20hz()
        pt = tt.with_bounds(tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"],
                                     rho=s["rho"], N=N, device="cpu"),
                            u_min=-0.5, u_max=0.5)
    else:
        pt = _port(_jax_problem(case, 5))
    seen = []

    def entry(*args):
        assert len(args) == 26
        assert args[24] is None            # fixed rho: no adaptive arguments
        assert args[20] is None            # one system
        warm = args[0]
        a = args[23]._obj
        counts = [getattr(a, n) for n in admm_fused.Families._fields]
        for f, (c, d) in enumerate(zip(counts, admm_fused._FAMILY_DUALS)):
            on = c > 0 and bool(warm)
            assert (getattr(a, d + "_in") is not None) == on
            assert (getattr(a, d + "_out") is not None) == on
        xu = bool(warm) and any(counts)
        assert all((getattr(a, k) is not None) == xu
                   for k in ("x_in", "u_in", "x_out", "u_out"))
        assert all((args[19][k] is not None) == bool(warm)
                   for k in range(12))
        seen.append((warm, counts))
        return 0

    def group_entry(*args):
        assert len(args) == 24
        warm = args[0]
        assert all((args[19][k] is not None) == bool(warm)
                   for k in range(12))
        seen.append((warm, [0] * 6))
        return 0

    def fused(*args):
        raise AssertionError("a launch reached csrc/admm_fused.cu")

    monkeypatch.setattr(admm_fused, "_kernel_fn", lambda multi=False: fused)
    monkeypatch.setattr(admm_fused, "_group_fn", lambda: group_entry)
    monkeypatch.setattr(admm_fused, "_group_policy_fn", lambda kind: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    spec = pt.spec
    tables, x0, params = admm_fused._prepare(
        pt, None, None, torch.zeros((3, spec.nx)))
    admm_fused._solve_kernel(tables, x0, spec.N, spec.nx, spec.nu, **params)
    carry = admm_fused._carry_tensors(pt, init_carry(pt, 3), 3)
    _, _, out = admm_fused._solve_kernel_warm(tables, x0, carry, spec.N,
                                              spec.nx, spec.nu, **params)
    for f in dataclasses.fields(carry):
        assert (getattr(out, f.name) is None) == \
            (getattr(carry, f.name) is None), f.name
    counts = list(admm_fused._families(spec))
    assert seen == [(0, counts), (1, counts)]
    assert any(counts) == (case != "box")


def test_fused_supported_and_checks_for_the_families():
    """The families are fused-supported at the instantiated (nx, nu);
    consensus, an uninstantiated (nx, nu), a cone that does not fit, a
    missing table and a carry whose fields do not match are refused."""
    soc, lin = _port(_jax_problem("soc", 5)), _port(_jax_problem("linear", 5))
    assert fused_supported(soc) and fused_supported(lin)
    s = tt.systems.synthetic(5, 2)       # (nx, nu) = (5, 2): not built
    odd = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=5,
                   device="cpu")
    bad = [
        soc.replace(spec=dataclasses.replace(soc.spec, en_consensus=True)),
        tt.with_cones(odd, state_cones=[(0, 2, 1.0)]),
        soc.replace(spec=dataclasses.replace(soc.spec,
                                             state_cones=((4, 3),))),
        lin.replace(cons=dataclasses.replace(lin.cons, blin_x=None)),
    ]
    for p in bad:
        assert not fused_supported(p)
        with pytest.raises(ValueError):
            solve_fused(p, None, None, torch.zeros((2, p.spec.nx)))
    box = lin.replace(spec=dataclasses.replace(
        lin.spec, en_state_linear=False, en_input_linear=False))
    x0 = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="carry fields"):
        solve_fused_warm(lin, None, None, x0, init_carry(box, 2))
    with pytest.raises(ValueError, match="carry fields"):
        solve_fused_warm(box, None, None, x0, init_carry(lin, 2))
