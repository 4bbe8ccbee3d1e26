"""Roofline probes on the GPU (counterpart of the Pallas probes in
``tools/roofline.py``).

:func:`dot_probe` runs ``reps`` times L (depth, depth) x (depth, lanes)
dots, chained (each consumes the previous result) or independent (L
distinct matrices against one operand a rep), and :func:`elementwise_probe`
runs ``passes`` add+clip passes and ``reductions`` max-abs lane reductions
over an (N, F, lanes) array, in one launch each of the hand-written CUDA
kernels of ``csrc/roofline.cu`` (they replace ``tools/roofline.py``'s
``dot_kernel`` and ``elementwise_kernel``). Each builds the TPU probe's own
inputs (``tools/roofline.py:85-88``, ``:115-116``) on ``device`` and returns
what the TPU probe writes: (depth, lanes) and (1, lanes) float32. The dot's
operand is ``"bf16"`` -- the TPU function: matrices in bf16, each dot's
operand rounded to bf16, float32 accumulation; the independent dots on the
tensor cores (mma.sync), the chained ones on the CUDA cores -- or
``"f32"``, the card's own chain: float32 matrices and operands, no cast,
on the CUDA cores.

On CPU tensors the wrappers run the plain PyTorch versions,
:func:`dot_probe_reference` and :func:`elementwise_probe_reference`; on
CUDA tensors they launch the kernels or raise. :mod:`tinympc_tpu_torch.
roofline` drives them beside the fused solve.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .admm_fused import _check_arg

KERNEL = "roofline"
BLOCK = 128                          # threads (= lanes) per block
# Depths csrc/roofline.cu instantiates, by operand: the TPU probe's 3 nx in
# bf16 and the card's own chain at nx in float32, for the quadrotor (nx=12)
# and the synthetic (32, 8) system.
DOT_DEPTHS = {"bf16": (36, 96), "f32": (12, 32)}
OPERANDS = ("bf16", "f32")

# Launches of the CUDA kernels in this process, by probe; chip_smoke.py
# resets and reads them to show that the probes went through the kernels.
launch_counts = dict.fromkeys(("dot_chained", "dot_independent",
                               "elementwise"), 0)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {dev}")
    return dev


def dot_inputs(L: int, depth: int, lanes: int, operand: str = "bf16",
               device="cuda"):
    """The TPU probe's inputs on ``device``: M = 0.01 (depth, depth), Ms =
    0.01 + 1e-6 * arange (L, depth, depth) summed in float32, both rounded
    to bf16 for ``operand="bf16"`` (float32 for ``"f32"``), and v = ones
    (depth, lanes) float32."""
    if operand not in OPERANDS:
        raise ValueError(f"operand must be one of {OPERANDS}, got "
                         f"{operand!r}")
    if L < 1 or depth < 1 or lanes < 1:
        raise ValueError("the dot probe needs L, depth and lanes >= 1")
    dev = _device(device)
    dtype = torch.bfloat16 if operand == "bf16" else torch.float32
    Ms = np.float32(0.01) + np.arange(L * depth * depth, dtype=np.float32) \
        .reshape(L, depth, depth) * np.float32(1e-6)
    M = torch.full((depth, depth), 0.01, dtype=torch.float32)
    return (M.to(dtype).to(dev), torch.as_tensor(Ms).to(dtype).to(dev),
            torch.ones((depth, lanes), dtype=torch.float32, device=dev))


def held_dot_inputs(L: int, depth: int, lanes: int, operand: str = "bf16",
                    seed: int = 0, device="cuda"):
    """Inputs on which a long chain stays of order one, for holding the
    kernel against its plain version: M and each Ms[k] = (1 + 0.25 u) /
    depth with u ~ U[-1, 1] (distinct entries, row sums near 1), v ~
    U[0.5, 1.5] (distinct lanes), from ``default_rng(seed)``; matrices
    rounded as :func:`dot_inputs` rounds them. On the TPU probe's own
    inputs each chained product scales the operand by 0.01 depth, which
    at depth 36 leaves float32's normal range after ~90 products."""
    if operand not in OPERANDS:
        raise ValueError(f"operand must be one of {OPERANDS}, got "
                         f"{operand!r}")
    dev = _device(device)
    dtype = torch.bfloat16 if operand == "bf16" else torch.float32
    rng = np.random.default_rng(seed)
    mats = (1.0 + 0.25 * rng.uniform(-1.0, 1.0, (L + 1, depth, depth))) \
        / depth
    mats = torch.as_tensor(mats, dtype=torch.float32).to(dtype).to(dev)
    v = torch.as_tensor(rng.uniform(0.5, 1.5, (depth, lanes)),
                        dtype=torch.float32, device=dev)
    return mats[0].contiguous(), mats[1:].contiguous(), v


def elementwise_inputs(N: int, F: int, lanes: int, device="cuda"):
    """The TPU probe's inputs on ``device``: a = ones and b = 0.1, both
    (N, F, lanes) float32."""
    if N < 1 or F < 1 or lanes < 1:
        raise ValueError("the elementwise probe needs N, F and lanes >= 1")
    dev = _device(device)
    kw = dict(dtype=torch.float32, device=dev)
    return torch.ones((N, F, lanes), **kw), torch.full((N, F, lanes), 0.1,
                                                        **kw)


def dot_probe(L: int, depth: int, lanes: int, chained: bool, reps: int,
              operand: str = "bf16", device="cuda") -> torch.Tensor:
    """The dot probe on its own inputs (:func:`dot_inputs`): (depth, lanes)
    float32, the sum over reps of the chain's last product (chained) or of
    every product (independent)."""
    M, Ms, v = dot_inputs(L, depth, lanes, operand, device)
    return run_dot(M, Ms, v, chained, reps)


def elementwise_probe(N: int, F: int, lanes: int, passes: int,
                      reductions: int, reps: int,
                      device="cuda") -> torch.Tensor:
    """The elementwise probe on its own inputs (:func:`elementwise_inputs`):
    (1, lanes) float32."""
    a, b = elementwise_inputs(N, F, lanes, device)
    return run_elementwise(a, b, passes, reductions, reps)


def run_dot(M, Ms, v, chained: bool, reps: int) -> torch.Tensor:
    """The dot probe on given inputs (shapes and types as
    :func:`dot_inputs` makes them): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if v.device.type == "cpu":
        return dot_probe_reference(M, Ms, v, chained, reps)
    if v.device.type != "cuda":
        raise ValueError(f"the dot probe runs on cuda or cpu, not "
                         f"{v.device}")
    return _dot_kernel(M, Ms, v, chained, reps)


def run_elementwise(a, b, passes: int, reductions: int,
                    reps: int) -> torch.Tensor:
    """The elementwise probe on given (N, F, lanes) inputs: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if a.device.type == "cpu":
        return elementwise_probe_reference(a, b, passes, reductions, reps)
    if a.device.type != "cuda":
        raise ValueError(f"the elementwise probe runs on cuda or cpu, not "
                         f"{a.device}")
    return _elementwise_kernel(a, b, passes, reductions, reps)


def dot_probe_reference(M, Ms, v, chained: bool, reps: int) -> torch.Tensor:
    """The dot probe's plain PyTorch version, on the inputs' device. A bf16
    operand is rounded with ``.to(torch.bfloat16).float()`` and multiplied
    in float32 (a bf16 matmul would accumulate otherwise): the products of
    bf16 values are exact in float32, so only the summation order parts it
    from the kernel's."""
    bf16 = M.dtype == torch.bfloat16
    cast = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    acc = torch.zeros_like(v)
    for r in range(reps):
        if chained:
            x, Mf = v, M.to(v.dtype)
            for _ in range(Ms.shape[0]):
                x = Mf @ cast(x)
            acc = acc + x
        else:
            y = cast(v + r)
            for k in range(Ms.shape[0]):
                acc = acc + Ms[k].to(v.dtype) @ y
    return acc


def elementwise_probe_reference(a, b, passes: int, reductions: int,
                                reps: int) -> torch.Tensor:
    """The elementwise probe's plain PyTorch version, on the inputs' device
    (add, clip and max round exactly and in no order, so it is bitwise the
    kernel's)."""
    acc = torch.zeros((1, a.shape[-1]), dtype=torch.float32, device=a.device)
    for _ in range(reps):
        x = a
        for _ in range(passes):
            x = torch.clamp(x + b, -5.0, 5.0)
        for _ in range(reductions):
            acc = torch.maximum(acc, torch.amax(x.abs(), dim=(0, 1))[None])
        acc = acc + x[0, :1]
    return acc


# ------------------------------------------------------------ CUDA kernels

def _fns():
    """The C entry points of csrc/roofline.cu, built and loaded on first
    use: (dot, elementwise)."""
    lib = _build.load(KERNEL)
    if lib.tinympc_roofline_block() != BLOCK:
        raise RuntimeError("csrc/roofline.cu and roofline.BLOCK disagree on "
                           "the block size")
    dot, ew = lib.tinympc_roofline_dot, lib.tinympc_roofline_elementwise
    dot.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    ew.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    dot.restype = ew.restype = ctypes.c_int
    return dot, ew


def _dot_kernel(M, Ms, v, chained: bool, reps: int) -> torch.Tensor:
    dev = v.device
    depth, lanes = v.shape
    L = Ms.shape[0]
    bf16 = M.dtype == torch.bfloat16
    operand = "bf16" if bf16 else "f32"
    if depth not in DOT_DEPTHS[operand]:
        raise ValueError(f"depth {depth} is not one of the dot kernel's "
                         f"{operand} instantiations {DOT_DEPTHS[operand]}")
    mdt = torch.bfloat16 if bf16 else torch.float32
    _check_arg(v, (depth, lanes), torch.float32, dev)
    mat = _check_arg(M, (depth, depth), mdt, dev) if chained \
        else _check_arg(Ms, (L, depth, depth), mdt, dev)
    out = torch.empty((depth, lanes), dtype=torch.float32, device=dev)
    dot, _ = _fns()
    with torch.cuda.device(dev):
        err = dot(depth, int(bf16), int(chained), L, lanes, int(reps),
                  mat.data_ptr(), v.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roofline dot kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["dot_chained" if chained else "dot_independent"] += 1
    return out


def _elementwise_kernel(a, b, passes, reductions, reps) -> torch.Tensor:
    dev = a.device
    shape = tuple(a.shape)
    _check_arg(a, shape, torch.float32, dev)
    _check_arg(b, shape, torch.float32, dev)
    out = torch.empty((1, shape[-1]), dtype=torch.float32, device=dev)
    _, ew = _fns()
    with torch.cuda.device(dev):
        err = ew(shape[0] * shape[1], shape[-1], int(passes),
                 int(reductions), int(reps), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roofline elementwise kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["elementwise"] += 1
    return out
