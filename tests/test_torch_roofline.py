"""The roofline probes of the port: their plain PyTorch versions (what
``kernels.dot_probe`` and ``kernels.elementwise_probe`` run on CPU tensors,
and what the CUDA kernels of csrc/roofline.cu are held against on the card)
against the JAX package's Pallas probes of tools/roofline.py in interpret
mode, the float32 chain against a float64 chain, the launch glue against a
stand-in C entry, the port's ``systems.synthetic`` against the JAX
package's, and the tool's configs.

The CUDA kernels themselves cannot run here; chip_smoke.py holds them
against the plain versions on the GPU."""
import contextlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tinympc_tpu import systems as jax_systems

import tinympc_tpu_torch as tt
from tinympc_tpu_torch import roofline as tool
from tinympc_tpu_torch.kernels import roofline as rf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    """tools/roofline.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_tool", REPO / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


@pytest.mark.parametrize("chained,L,reps", [(True, 4, 2), (False, 4, 2),
                                            (True, 7, 1), (False, 3, 3)],
                         ids=["chained", "independent", "chained-L7",
                              "independent-reps3"])
def test_dot_probe_matches_the_jax_probe(jax_tool, chained, L, reps):
    """bf16 operands, float32 accumulation, at the quadrotor's depth 36:
    the independent dots to rtol 1e-5 (the summation order), the chained
    ones to rtol 8e-3 (two bf16 ulps: each dot re-rounds its operand, so
    an order difference can move one rounding)."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.dot_kernel(L, 36, 128, chained, reps)())
    got = tt.kernels.dot_probe(L, 36, 128, chained, reps, device="cpu")
    assert got.shape == (36, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0,
                               rtol=8e-3 if chained else 1e-5)


def mma_dot_emulation(Ms, v, reps):
    """The independent bf16 dots in the tile order of csrc/roofline.cu's
    dot_independent_mma_kernel, on the CPU: depth padded with zeros to a
    multiple of 16; each rep's operand bf16(v + r); each matrix's dot
    formed from zero over its k16 chunks (a chunk's 16 products, exact in
    float64, added to the dot so far and rounded to float32, as the tensor
    core's accumulate rounds to within its own last bits), then added to
    the float32 sum with an IEEE add, rep then matrix."""
    L, D, _ = Ms.shape
    P = -(-D // 16) * 16
    Mp = torch.zeros((L, P, P), dtype=torch.float64)
    Mp[:, :D, :D] = Ms.double()
    acc = torch.zeros((P, v.shape[1]))
    for r in range(reps):
        y = torch.zeros((P, v.shape[1]), dtype=torch.float64)
        y[:D] = (v + r).to(torch.bfloat16).double()
        for k in range(L):
            dot = torch.zeros_like(acc)
            for c in range(0, P, 16):
                dot = (dot.double() + Mp[k, :, c:c + 16] @ y[c:c + 16]).float()
            acc = acc + dot
    return acc[:D]


@pytest.mark.parametrize("depth,L,reps", [(36, 95, 1), (36, 7, 3),
                                          (96, 95, 1), (96, 4, 2)])
def test_mma_tile_order_holds_to_the_plain_version(depth, L, reps):
    """The tensor-core kernel's order (zero padding to 16, each matrix's
    dot from zero in k16 chunks, then the sum) against the plain version
    on the inputs chip_smoke.py holds the kernel on, at the TPU probe's
    full L = 95 and short ones, depths 36 (padded to 48) and 96: rtol
    1e-5, chip_smoke.py's bar, with no absolute floor."""
    M, Ms, v = rf.held_dot_inputs(L, depth, 200, "bf16", device="cpu")
    got = mma_dot_emulation(Ms, v, reps)
    want = rf.dot_probe_reference(M, Ms, v, False, reps).double()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=0,
                               rtol=1e-5)


@pytest.mark.parametrize("L,reps", [(4, 2), (3, 3)])
def test_mma_tile_order_matches_the_jax_probe(jax_tool, L, reps):
    """The same order on the TPU probe's own inputs against tools/roofline.
    py's dot_kernel in interpret mode, independent dots at depth 36: rtol
    1e-5, as the plain version is held."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.dot_kernel(L, 36, 128, False, reps)())
    _, Ms, v = rf.dot_inputs(L, 36, 128, "bf16", "cpu")
    np.testing.assert_allclose(mma_dot_emulation(Ms, v, reps).numpy(), want,
                               atol=0, rtol=1e-5)


@pytest.mark.parametrize("passes,reductions,reps", [(8, 4, 2), (8, 0, 2),
                                                    (0, 4, 2), (3, 1, 1)])
def test_elementwise_probe_matches_the_jax_probe_bitwise(
        jax_tool, passes, reductions, reps):
    """Add, clip and max round exactly and in no order: bitwise."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.elementwise_kernel(
            20, 16, 128, passes, reductions, reps)())
    got = tt.kernels.elementwise_probe(20, 16, 128, passes, reductions,
                                       reps, device="cpu")
    assert got.shape == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inputs_are_the_jax_probes_inputs(jax_tool):
    """M, Ms and v as tools/roofline.py:85-88 builds them (bf16 rounding of
    the float32 sums), and a, b of :115-116."""
    import jax.numpy as jnp
    L, d = 3, 36
    M, Ms, v = rf.dot_inputs(L, d, 128, "bf16", "cpu")
    want = (0.01 + jnp.arange(L * d * d, dtype=jnp.float32)
            .reshape(L, d, d) * 1e-6).astype(jnp.bfloat16)
    np.testing.assert_array_equal(Ms.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(
        M.float().numpy(), np.asarray(jnp.full((d, d), 0.01, jnp.bfloat16)
                                      .astype(jnp.float32)))
    assert M.dtype == Ms.dtype == torch.bfloat16
    assert torch.equal(v, torch.ones((d, 128)))
    M32, Ms32, _ = rf.dot_inputs(L, d, 128, "f32", "cpu")
    assert M32.dtype == Ms32.dtype == torch.float32
    np.testing.assert_array_equal(Ms32.numpy(), np.asarray(
        0.01 + jnp.arange(L * d * d, dtype=jnp.float32).reshape(L, d, d)
        * 1e-6))
    a, b = rf.elementwise_inputs(20, 16, 128, "cpu")
    assert torch.equal(a, torch.ones((20, 16, 128)))
    assert torch.equal(b, torch.full((20, 16, 128), 0.1))


@pytest.mark.parametrize("depth,chained", [(12, True), (12, False),
                                           (32, True)])
def test_f32_chain_matches_a_float64_chain(depth, chained):
    """The card's own chain (float32, no cast) at depth nx and the tool's
    chain length 2 (N-1) = 38, against the same chain in float64: rtol
    1e-5."""
    L = tool.chain_length(20)
    assert L == 38
    M, Ms, v = rf.dot_inputs(L, depth, 128, "f32", "cpu")
    got = rf.run_dot(M, Ms, v, chained, 2)
    want = rf.dot_probe_reference(M.double(), Ms.double(), v.double(),
                                  chained, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0, rtol=1e-5)


@pytest.mark.parametrize("operand,depth,L", [("bf16", 36, 95),
                                             ("bf16", 96, 95),
                                             ("f32", 12, 38),
                                             ("f32", 32, 38)])
def test_held_inputs_keep_a_long_chain_of_order_one(operand, depth, L):
    """The inputs chip_smoke.py holds the kernels on, at the full-size
    chains (the TPU probe's L = 95 at depths 36 and 96, the float32 chain's
    38 at 12 and 32): the chained and independent outputs stay of order one
    on every lane, lanes differ, the matrices are distinct and rounded as
    the probe's, and the float32 plain version holds to float64 at rtol
    1e-5 with no absolute floor."""
    M, Ms, v = rf.held_dot_inputs(L, depth, 256, operand, device="cpu")
    dtype = torch.bfloat16 if operand == "bf16" else torch.float32
    assert M.dtype == Ms.dtype == dtype and v.dtype == torch.float32
    assert (M.shape, Ms.shape, v.shape) == ((depth, depth), (L, depth, depth),
                                            (depth, 256))
    assert not torch.equal(Ms[0], Ms[1]) and not torch.equal(v[:, 0], v[:, 1])
    for chained, lo, hi in ((True, 0.1, 10.0), (False, 0.1 * L, 10.0 * L)):
        out = rf.dot_probe_reference(M, Ms, v, chained, 1)
        assert lo < out.abs().min() and out.abs().max() < hi
        if operand == "f32":
            want = rf.dot_probe_reference(M.double(), Ms.double(),
                                          v.double(), chained, 1)
            np.testing.assert_allclose(out.numpy(), want.numpy(), atol=0,
                                       rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_is_the_jax_packages_bitwise(seed):
    for nx, nu in ((32, 8), (5, 2)):
        a = tt.systems.synthetic(nx, nu, seed=seed)
        b = jax_systems.synthetic(nx, nu, seed=seed)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def _stand_in(monkeypatch, calls):
    """A stand-in for the library of csrc/roofline.cu: records the
    arguments of each C call and writes nothing."""
    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn
    lib = types.SimpleNamespace(
        tinympc_roofline_block=lambda: rf.BLOCK,
        tinympc_roofline_dot=entry("dot"),
        tinympc_roofline_elementwise=entry("elementwise"))
    monkeypatch.setattr(rf._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    for k in rf.launch_counts:
        monkeypatch.setitem(rf.launch_counts, k, 0)


def test_launch_glue_against_a_stand_in(monkeypatch):
    """Each probe passes its sizes, flags and the matrix the variant reads
    (M chained, Ms independent) to the C entry, and counts its launch."""
    calls = []
    _stand_in(monkeypatch, calls)
    M, Ms, v = rf.dot_inputs(5, 36, 256, "bf16", "cpu")
    rf._dot_kernel(M, Ms, v, True, 3)
    rf._dot_kernel(M, Ms, v, False, 3)
    M32, Ms32, v32 = rf.dot_inputs(38, 12, 100, "f32", "cpu")
    rf._dot_kernel(M32, Ms32, v32, True, 1)
    a, b = rf.elementwise_inputs(20, 16, 300, "cpu")
    rf._elementwise_kernel(a, b, 8, 4, 2)
    assert [c[1][:6] for c in calls[:3]] == [
        (36, 1, 1, 5, 256, 3), (36, 1, 0, 5, 256, 3), (12, 0, 1, 38, 100, 1)]
    assert calls[0][1][6] == M.data_ptr() and calls[1][1][6] == Ms.data_ptr()
    assert calls[2][1][6] == M32.data_ptr()
    assert calls[3] == ("elementwise", (320, 300, 8, 4, 2, a.data_ptr(),
                                        b.data_ptr(), calls[3][1][7], 0))
    assert rf.launch_counts == {"dot_chained": 2, "dot_independent": 1,
                                "elementwise": 1}


def test_the_kernels_refuse_what_they_do_not_take(monkeypatch):
    calls = []
    _stand_in(monkeypatch, calls)
    M, Ms, v = rf.dot_inputs(2, 20, 128, "bf16", "cpu")
    with pytest.raises(ValueError, match="instantiations"):
        rf._dot_kernel(M, Ms, v, True, 1)           # depth 20: not built
    M, Ms, v = rf.dot_inputs(2, 36, 128, "f32", "cpu")
    with pytest.raises(ValueError, match="instantiations"):
        rf._dot_kernel(M, Ms, v, True, 1)           # float32 at 36: not built
    M, Ms, v = rf.dot_inputs(2, 36, 128, "bf16", "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        rf._dot_kernel(M, Ms, v.double(), True, 1)  # v not float32
    with pytest.raises(ValueError, match="contiguous"):
        rf._dot_kernel(M, Ms.float(), v, False, 1)  # Ms not M's bf16
    with pytest.raises(ValueError, match="operand"):
        rf.dot_inputs(2, 12, 128, "fp8", "cpu")
    assert calls == []
    # No entry point runs on another device type.
    with pytest.raises(ValueError, match="cuda or cpu"):
        rf.dot_probe(2, 12, 128, True, 1, device="meta")


def test_the_tool_measures_the_jax_tools_configs_and_needs_a_card(
        monkeypatch, capsys):
    """The three configs of tools/roofline.py:main (quadrotor N=20 at ct 1
    and 25, synthetic (32, 8)), at the JAX tool's batches; without a CUDA
    device the tool exits non-zero and prints no result."""
    assert [c[2:] for c in tool.CONFIGS] == [(12, 4, 20, 32768, 1),
                                            (12, 4, 20, 32768, 25),
                                            (32, 8, 20, 16384, 25)]
    assert tool.iteration_flops(20, 12, 4) == 19 * (2 * 16 * 12 + 32 + 96) \
        + 19 * (2 * 16 * 12 + 96) + 15 * 20 * 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() != 0
    assert capsys.readouterr().out == ""
    # The (32, 8) point has no fused-kernel instantiation: no solve.
    assert tool.solve_time(tt.systems.synthetic(32, 8), 32, 8, 20, 256, 25,
                           device="cpu") is None
