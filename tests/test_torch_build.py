"""kernels/_build.py names each library by a hash of everything that goes
into it, so an edited source or shared header never loads a stale build.
Runs without nvcc: only the names are computed."""
from tinympc_tpu_torch.kernels import _build


def test_library_name_follows_source_and_every_shared_header(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "sweep.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "sweep.cuh"\n// b\n')
    (tmp_path / "sweep.cuh").write_text("// v1\n")
    first = {n: _build.library_path(n) for n in ("a", "b")}
    assert first["a"] != first["b"]
    assert _build.library_path("a") == first["a"]      # deterministic
    (tmp_path / "sweep.cuh").write_text("// v2\n")
    second = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(second[n] != first[n] for n in first)
    (tmp_path / "extra.cuh").write_text("// new header\n")
    assert _build.library_path("a") != second["a"]
    (tmp_path / "a.cu").write_text('#include "sweep.cuh"\n// edited\n')
    assert _build.library_path("a").parent == _build.BUILD_DIR


def test_package_ships_its_kernel_sources():
    """Every kernel the wrappers load has its source and the shared header
    in the package."""
    from tinympc_tpu_torch.kernels import admm_fused, closed_loop_kernel
    for name in (admm_fused.KERNEL, closed_loop_kernel.KERNEL):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "admm_sweep.cuh"' in src
    assert (_build.CSRC_DIR / "admm_sweep.cuh").exists()


def test_kernels_build_without_fma_contraction(tmp_path, monkeypatch):
    """The kernels are built with -fmad=false, so only their explicit fmaf
    chains fuse and every elementwise term rounds as the plain versions'
    PyTorch operations round it; the flags are part of the library name,
    so a build with other flags is never loaded in its place."""
    assert "-fmad=false" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text("// a\n")
    name = _build.library_path("a")
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(
        f for f in _build.NVCC_FLAGS if f != "-fmad=false"))
    assert _build.library_path("a") != name
