"""The box-only fixed-rho solve and the fused closed loop on their thread
group kernels (csrc/admm_group.cu, csrc/closed_loop_fused.cu): the launch
geometry, the launch glue against stand-ins for the C entries that run
the plain version block by block, the fleet's tiles, and the buffers a
launch allocates. CPU only: the kernels themselves run on the card
(chip_smoke.py); here the stand-ins read and write the launch's tensors
through the pointers the glue passes."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import tinympc_tpu_torch as tt
from tinympc_tpu_torch.kernels import admm_fused, closed_loop_kernel
from tinympc_tpu_torch.kernels.admm_fused import (
    BLOCK, PLACE_SAVED_GLOBAL, PLACE_SHARED, PLACE_TABLE_GLOBAL, FusedCarry,
    group_arena_floats, group_geometry, group_grid)


def _quad(N=10, max_iter=20, ct=5, scale=1.0):
    s = tt.systems.quadrotor_20hz()
    A = np.asarray(s["A"], dtype=np.float64)
    off = ~np.eye(12, dtype=bool)
    A[off] *= scale
    p = tt.setup(A, s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device="cpu")
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct)


def _x0(B, seed=0, spread=0.5):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -spread, spread, (B, 12)), dtype=torch.float32)


def _view(ptr, shape, ctype=ctypes.c_float):
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * n).from_address(ptr))).reshape(shape)


@pytest.fixture
def no_device(monkeypatch):
    """The launch glue's CUDA calls stubbed for CPU tensors."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=None))


def _group_stand_in(calls):
    """A stand-in for tinympc_admm_group: the grid of ceil(B / P) blocks,
    each block's P problems solved by the plain version with the table of
    its 128-lane tile (block_sys[first lane // 128]), the outputs and carry
    written through the pointers it is given."""
    def fn(warm, nx, nu, P, place, N, B, max_iter, ct, rho, tol_pri,
           tol_dua, tables, x0, out_x, out_u, iters, solved, res, carry,
           block_sys, stride, saved, stream):
        calls.append(dict(warm=warm, P=P, place=place, B=B,
                          block_sys=block_sys, stride=stride, saved=saved))
        x0v = _view(x0, (B, nx))
        ox, ou = _view(out_x, (N, B, nx)), _view(out_u, (N - 1, B, nu))
        oi = _view(iters, (B,), ctypes.c_int32)
        osv = _view(solved, (B,), ctypes.c_bool)
        orr = _view(res, (4, B))
        shapes = [(N, nx, B), (N - 1, nu, B)] * 3
        cin = [_view(carry[k], shapes[k]) for k in range(6)] if warm else None
        cout = [_view(carry[6 + k], s) for k, s in enumerate(
            [(N, nx, B), (N - 1, nu, B)] * 3)] if warm else None
        systems = None if block_sys is None else _view(
            block_sys, (-(-B // BLOCK),), ctypes.c_int32)
        for k in range(group_grid(B, P)):
            lanes = torch.arange(k * P, min(B, (k + 1) * P))
            s = 0 if systems is None else int(systems[k * P // BLOCK])
            table = _view(tables + 4 * s * stride, (stride,)).clone()
            c = None if not warm else FusedCarry(**{
                f: cin[i][..., lanes].clone() for i, f in enumerate(
                    ("vnew", "znew", "g", "y", "v", "z"))})
            sol, r, c2, _ = admm_fused._solve_plain(
                table, x0v[lanes].clone(), N, nx, nu, carry=c,
                max_iter=max_iter, ct=ct, rho=rho, tol_pri=tol_pri,
                tol_dua=tol_dua)
            ox[:, lanes], ou[:, lanes] = sol.x, sol.u
            oi[lanes], osv[lanes], orr[:, lanes] = sol.iter, sol.solved, r
            if warm:
                for i, f in enumerate(("vnew", "znew", "v", "z", "g", "y")):
                    cout[i][..., lanes] = getattr(c2, f)
        return 0
    return fn


def _equal(got, want):
    for (g, _), (w, _) in zip(admm_fused._lane_tensors(got),
                              admm_fused._lane_tensors(want)):
        assert torch.equal(g, w)


def test_geometry_of_the_main_path_and_the_serving_loop():
    """The main path (N=20) and the serving loop (N=10) launch 8 problems a
    block of 128 threads with the packed table in shared memory; the bytes
    are the table, 16-byte aligned, and the arena."""
    table = admm_fused._table_floats(12, 4, 20)
    for warm in (False, True):
        P, place, smem = group_geometry(20, warm)
        assert (P, place) == (8, PLACE_SHARED)
        assert P * admm_fused.GROUP == 128
        assert smem == 4 * (-(-table // 4) * 4
                            + group_arena_floats(20, 8, warm))
    # slots of 20 floats, slack and dual (and saved) columns of 16 rows,
    # the inputs' feedforward
    assert group_arena_floats(20, 8, False) == 8 * 20 + 2 * 20 * 128 \
        + 19 * 32
    assert group_arena_floats(20, 8, True) - group_arena_floats(
        20, 8, False) == 20 * 128
    P, place, smem = closed_loop_kernel.loop_geometry(10, 50)
    assert (P, place) == (8, PLACE_SHARED) and smem <= admm_fused.SMEM_LIMIT


@pytest.mark.parametrize("N,warm,want", [
    (256, False, (4, PLACE_SHARED)), (256, True, (2, PLACE_SHARED)),
    (512, False, (1, PLACE_SHARED)), (700, False, (2, PLACE_TABLE_GLOBAL)),
    (1110, True, (1, PLACE_TABLE_GLOBAL)),
    (1117, True, (1, PLACE_TABLE_GLOBAL)),
    (1118, True, (1, PLACE_SAVED_GLOBAL)),
    (1196, False, (1, PLACE_TABLE_GLOBAL)),
    (1196, True, (1, PLACE_SAVED_GLOBAL))])
def test_geometry_halves_the_block_then_moves_the_table(N, warm, want):
    """Past the main path's horizons the block halves while the table
    still fits beside the arena; then the table stays in device memory and
    the arena alone takes shared memory; past N=1117 a warm solve's saved
    columns go to device memory too. P always divides the fleet's 128-lane
    tile, so a block never straddles two systems."""
    P, place, smem = group_geometry(N, warm)
    assert (P, place) == want
    assert smem <= admm_fused.SMEM_LIMIT and BLOCK % P == 0


@pytest.mark.parametrize("T", [1, 50, 100000])
def test_geometry_takes_every_horizon_the_predicates_take(T):
    """The support predicates and the launch geometry agree at the limit:
    every horizon fused_supported and closed_loop_fused_supported take (to
    N=1196 at (12, 4)) has a launch, cold, warm and in the closed loop at
    any T; N=1197 is refused by both predicates. The closed loop moves its
    table and reference to device memory where they do not fit (a long
    T), and its saved columns past N=1117."""
    horizons = list(admm_fused._supported_horizons(12, 4))
    assert horizons == list(range(2, 1197))
    for N in (1196, 1197):
        prob = _quad(N=N)
        assert admm_fused.fused_supported(prob) == (N == 1196)
        assert closed_loop_kernel.closed_loop_fused_supported(prob) == (
            N == 1196)
    for N in horizons:
        for warm in (False, True):
            P, place, smem = group_geometry(N, warm)
            assert smem <= admm_fused.SMEM_LIMIT
            assert (place == PLACE_SAVED_GLOBAL) == (warm and N > 1117)
        P, place, smem = closed_loop_kernel.loop_geometry(N, T)
        assert smem <= admm_fused.SMEM_LIMIT
        assert (place == PLACE_SAVED_GLOBAL) == (N > 1117)
    assert closed_loop_kernel.loop_geometry(10, 100000)[:2] == (
        8, PLACE_TABLE_GLOBAL)
    with pytest.raises(ValueError, match="more than"):
        group_geometry(1614, False)


def test_geometry_check_catches_a_layout_that_disagrees():
    """check_group_geometry, which the wrappers run when they load a
    library, passes a kernel whose count of shared memory is the
    wrapper's, and raises where one float of the arena differs."""
    def count(N, P, place, warm, extra=0):
        save = warm and place != PLACE_SAVED_GLOBAL
        table = admm_fused._table_floats(12, 4, N)
        return 4 * ((-(-table // 4) * 4 if place == PLACE_SHARED else 0)
                    + group_arena_floats(N, P, save) + extra)

    admm_fused.check_group_geometry(count)
    with pytest.raises(RuntimeError, match="arena layouts disagree"):
        admm_fused.check_group_geometry(
            lambda N, P, place, warm: count(N, P, place, warm,
                                            extra=4 * (N > 600)))
    loop = closed_loop_kernel._table_floats
    admm_fused.check_group_geometry(
        lambda N, P, place, T: admm_fused.group_smem(
            N, P, place, True, loop(N, T)), loop, kinds=(1, 50))


@pytest.mark.parametrize("B,P,blocks", [(1, 8, 1), (8, 8, 1), (9, 8, 2),
                                        (1000, 8, 125), (32768, 8, 4096),
                                        (300, 4, 75), (301, 4, 76)])
def test_grid_covers_a_ragged_batch(B, P, blocks):
    assert group_grid(B, P) == blocks
    assert (blocks - 1) * P < B <= blocks * P


@pytest.mark.parametrize("B,ct", [(300, 5), (37, 1)])
def test_cold_launch_glue_matches_the_plain_solve(B, ct, no_device,
                                                  monkeypatch):
    """The box solve's launch (tinympc_admm_group's arguments) against the
    stand-in: bitwise the plain solve of the whole batch, the ragged last
    block included; one launch counted on the group entry."""
    calls = []
    monkeypatch.setattr(admm_fused, "_group_fn",
                        lambda: _group_stand_in(calls))
    monkeypatch.setattr(admm_fused, "launch_count", 0)
    monkeypatch.setattr(admm_fused, "entry_counts",
                        dict.fromkeys(admm_fused.entry_counts, 0))
    prob = _quad(ct=ct)
    X = torch.zeros((10, 12))
    X[:, 2] = 1.0
    tables, x0, params = admm_fused._prepare(prob, X, None, _x0(B))
    got = admm_fused._solve_kernel(tables, x0, 10, 12, 4, **params)
    want = admm_fused._solve_plain(tables, x0, 10, 12, 4, **params)[:2]
    _equal(got + (None,), want + (None,))
    assert calls == [dict(warm=0, P=8, place=PLACE_SHARED, B=B,
                          block_sys=None, stride=tables.numel(),
                          saved=None)]
    assert admm_fused.launch_count == 1
    assert admm_fused.entry_counts == dict(
        tinympc_admm_group=1, tinympc_admm_fused=0,
        tinympc_admm_fused_multi=0, tinympc_admm_group_adaptive=0,
        tinympc_admm_group_consensus=0, tinympc_admm_group_families=0)


def test_warm_launch_glue_hands_the_carry_back(no_device, monkeypatch):
    """Three warm solves through the launch glue: the carry in and out
    pointers in tinympc_admm_group's order, each solve and carry bitwise
    the plain version's."""
    calls = []
    monkeypatch.setattr(admm_fused, "_group_fn",
                        lambda: _group_stand_in(calls))
    prob = _quad(ct=1)
    x = _x0(40, spread=0.3)
    c_k = c_p = tt.init_carry(prob, 40)
    for _ in range(3):
        tables, x0, ck, params = admm_fused._prepare_warm(prob, None, None, x,
                                                          c_k, False)
        got = admm_fused._solve_kernel_warm(tables, x0, ck, 10, 12, 4,
                                            **params)
        want = admm_fused._solve_plain(tables, x0, 10, 12, 4, carry=c_p,
                                       **params)[:3]
        _equal(got, want)
        c_k, c_p = got[2], want[2]
        x = x @ prob.A.T + got[0].u[0] @ prob.B.T + prob.f
    assert [c["warm"] for c in calls] == [1, 1, 1]


def test_fleet_blocks_take_their_tiles_systems(no_device, monkeypatch):
    """The fleet's padding (each system's lanes to whole 128-lane tiles)
    and each block's system (block_sys[first lane // 128]) under the group
    kernel's block of 8: through the stand-in, every lane of a ragged
    3-system fleet bitwise solve_fused_multi_reference's per-lane
    results."""
    calls = []
    monkeypatch.setattr(admm_fused, "_group_fn",
                        lambda: _group_stand_in(calls))
    probs = [_quad(scale=s) for s in (1.0, 1.01, 0.99)]
    x0 = _x0(3 * 70, seed=4)
    tables, x0c, bk, spec, params = admm_fused._prepare_multi(probs, x0,
                                                              None, None)
    assert bk.block_sys.tolist() == [0, 1, 2]          # 70 lanes: one tile
    assert bk.gather.numel() == 3 * BLOCK
    got = admm_fused._solve_systems_kernel(tables, x0c, bk, 10, 12, 4,
                                           **params)
    want = tt.kernels.solve_fused_multi_reference(probs, x0)
    for f in ("x", "u", "iter", "solved"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f))
    assert torch.equal(got[1], want[1])
    (call,) = calls
    assert call["B"] == 3 * BLOCK and call["block_sys"] is not None
    assert call["stride"] == admm_fused._table_floats(12, 4, 10)
    # every block of P lanes lies in one tile: its system is that tile's
    P = call["P"]
    sys_of_lane = bk.block_sys.repeat_interleave(BLOCK)
    for k in range(group_grid(call["B"], P)):
        assert sys_of_lane[k * P:(k + 1) * P].unique().numel() == 1


def test_box_launch_allocates_no_trajectory_scratch(no_device, monkeypatch):
    """A box fixed-rho launch allocates its outputs (and, warm, the carry
    out) and nothing a lane: no (2, N, nx, B) / (2, N-1, nu, B) slack
    halves, no dual or feedforward scratch. The same for the closed loop:
    its outputs alone."""
    B, N = 24, 10
    seen = []
    empty = torch.empty

    def record(*shape, **kw):
        t = empty(*shape, **kw)
        seen.append(tuple(t.shape))
        return t

    monkeypatch.setattr(admm_fused, "_group_fn", lambda: lambda *a: 0)
    prob = _quad()
    tables, x0, params = admm_fused._prepare(prob, None, None, _x0(B))
    monkeypatch.setattr(torch, "empty", record)
    admm_fused._solve_kernel(tables, x0, N, 12, 4, **params)
    assert seen == [(N, B, 12), (N - 1, B, 4), (B,), (B,), (4, B)]
    assert set(admm_fused._group_buffers(x0, N, 12, 4, True)) == {
        "out_x", "out_u", "iters", "solved", "res", "carry_vnew",
        "carry_znew", "carry_v", "carry_z", "carry_g", "carry_y"}
    seen.clear()
    T = 3
    loop_args = []
    monkeypatch.setattr(closed_loop_kernel, "_kernel_fn",
                        lambda: lambda *a: loop_args.append(a) or 0)
    tables, xtot, x0c, T, lp = closed_loop_kernel._prepare_loop(
        prob, torch.zeros((N, 12)), x0, T, None)
    seen.clear()
    closed_loop_kernel._loop_kernel(tables, xtot, x0c, T, N, 12, 4,
                                    reset_duals=False, shift_warm=False,
                                    **lp)
    assert seen == [(T, B, 12), (T, B, 4), (T, B), (T, B)]
    (args,) = loop_args
    # nx nu plants place N B T ..., then 9 pointers: no saved columns
    assert args[:7] == (12, 4, 8, PLACE_SHARED, N, B, T)
    assert len(args) == 23 and args[-2] is None


@pytest.mark.parametrize("N", [1117, 1118, 1196])
def test_long_horizons_keep_only_the_saved_columns_in_device_memory(
        N, no_device, monkeypatch):
    """Past N=1117 a warm box launch and the closed loop allocate one
    scratch buffer, a block's saved columns each ((blocks, N, P * 16)),
    and pass it to the kernel; below that, none. The cold solve never
    does."""
    B = 20
    seen, args = [], []
    empty = torch.empty

    def record(*shape, **kw):
        t = empty(*shape, **kw)
        seen.append(tuple(t.shape))
        return t

    monkeypatch.setattr(admm_fused, "_group_fn",
                        lambda: lambda *a: args.append(a) or 0)
    monkeypatch.setattr(closed_loop_kernel, "_kernel_fn",
                        lambda: lambda *a: args.append(a) or 0)
    prob = _quad(N=N, max_iter=1, ct=1)
    tables, x0, params = admm_fused._prepare(prob, None, None, _x0(B))
    carry = admm_fused._carry_tensors(prob, tt.init_carry(prob, B), B)
    tl, xtot, x0c, T, lp = closed_loop_kernel._prepare_loop(
        prob, torch.zeros((N, 12)), x0, 2, None)
    monkeypatch.setattr(torch, "empty", record)
    saved = (group_grid(B, 1) * N * 16,) if N > 1117 else None
    admm_fused._solve_kernel(tables, x0, N, 12, 4, **params)
    assert args[-1][3:5] == (1, PLACE_TABLE_GLOBAL) and args[-1][-2] is None
    assert (N * 16,) not in seen
    # (P, place) are arguments 3-4 of the box entry, 2-3 of the loop's
    for at, run in ((3, lambda: admm_fused._solve_kernel_warm(
            tables, x0, carry, N, 12, 4, **params)),
                    (2, lambda: closed_loop_kernel._loop_kernel(
                        tl, xtot, x0c, T, N, 12, 4, reset_duals=False,
                        shift_warm=False, **lp))):
        seen.clear()
        run()
        place = PLACE_SAVED_GLOBAL if saved else PLACE_TABLE_GLOBAL
        assert args[-1][at:at + 2] == (1, place)
        assert (args[-1][-2] is None) == (saved is None)
        assert (saved in seen) == (saved is not None)
