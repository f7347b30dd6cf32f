"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in `mafrixraytracing_torch/csrc/*.cu` (shared device code
in `*.cuh`) behind a plain C interface. At first use they are compiled with
`nvcc` for `sm_90a`, one process per source and all started together, and
linked into one shared library under `build/torch_kernels/` at the
repository root, named by a hash of the sources (an edited source gets a
fresh build), and loaded with `ctypes`. No fast math: the kernels keep IEEE
division and separate multiply/add rounding, so they agree with their plain
PyTorch versions.

`LAUNCHES` counts, per kernel, how many times a wrapper launched it; a run
resets it with `reset_launches()` and reads it afterwards to show that the
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false"]

LAUNCHES: dict[str, int] = {"closest": 0, "anyhit": 0, "unpack": 0,
                            "closest_super": 0, "anyhit_super": 0, "scatter": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmfx_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns the library's path. Raises if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, sources = _nvcc(), _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[1] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({p.returncode}):\n{log}")
            if verbose:
                print(log, end="")
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
        handle.mfx_closest.argtypes = [P, P, P, P, P, I, I, F, P, P, P]
        handle.mfx_anyhit.argtypes = [P, P, P, P, P, I, I, F, P, P]
        handle.mfx_unpack.argtypes = [P, P, I, I, P, P]
        handle.mfx_closest_super.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F, P, P, P]
        handle.mfx_anyhit_super.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F, P, P]
        handle.mfx_scatter.argtypes = [P, L, L, P, P, P, I, I, I, P, P, P]
        for fn in (handle.mfx_closest, handle.mfx_anyhit, handle.mfx_unpack,
                   handle.mfx_closest_super, handle.mfx_anyhit_super,
                   handle.mfx_scatter):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel operand: CUDA, dtype, contiguity, optional shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
