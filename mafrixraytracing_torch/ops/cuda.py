"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in `mafrixraytracing_torch/csrc/*.cu` (shared device code
in `*.cuh`) behind a plain C interface. At first use they are compiled with
`nvcc` for `sm_90a`, one process per source and all started together, and
linked into one shared library under `build/torch_kernels/` at the
repository root, named by a hash of the sources (an edited source gets a
fresh build), and loaded with `ctypes`. No fast math: the kernels keep IEEE
division and separate multiply/add rounding, so they agree with their plain
PyTorch versions.

Every wrapper launches through `launch(name, ...)`: it refuses operands that
lie on different devices, makes their device the current one for the call and
passes that device's current stream, so a tensor on a card other than the
current one launches there. `LAUNCHES` counts, per kernel, how many times it
was launched; a run resets it with `reset_launches()` and reads it afterwards
to show that the path went through the kernels.
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
                            "closest_super": 0, "anyhit_super": 0, "scatter": 0,
                            "fused_closest": 0, "fused_anyhit": 0,
                            "fused_closest_super": 0, "fused_anyhit_super": 0,
                            "cull": 0, "closest_dbg": 0, "closest_full": 0,
                            "rng_fold": 0, "rng_uniform": 0}

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
        handle.mfx_closest.argtypes = [P, P, P, P, P, P, P, I, I, F, F, F, P, P, P]
        handle.mfx_anyhit.argtypes = [P, P, P, P, P, P, P, I, I, F, F, F, P, P]
        handle.mfx_unpack.argtypes = [P, P, I, I, P, P]
        handle.mfx_closest_super.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F, P, P, P]
        handle.mfx_anyhit_super.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F, P, P]
        handle.mfx_scatter.argtypes = [P, L, L, P, P, P, I, I, I, P, P, P, I, P]
        handle.mfx_fused_closest.argtypes = [P, P, P, I, I, F, F, F, P, P, P]
        handle.mfx_fused_anyhit.argtypes = [P, P, P, I, I, F, F, F, P, P]
        handle.mfx_fused_closest_super.argtypes = [P, P, P, P, I, I, I, F, F, F, P, P, P]
        handle.mfx_fused_anyhit_super.argtypes = [P, P, P, P, I, I, I, F, F, F, P, P]
        handle.mfx_cull.argtypes = [P, P, P, I, I, P, P, P, P, P]
        handle.mfx_closest_dbg.argtypes = [P, P, P, P, P, P, P, I, I, F, F, F, P, P, P, P]
        handle.mfx_closest_full.argtypes = [P, P, P, P, P, P, P, I, I, F, F, F, P, P, P]
        handle.mfx_rng_fold.argtypes = [P, L, P, L, L, L, L, L, P, P]
        handle.mfx_rng_uniform.argtypes = [P, L, L, L, P, P]
        for fn in (handle.mfx_closest, handle.mfx_anyhit, handle.mfx_unpack,
                   handle.mfx_closest_super, handle.mfx_anyhit_super,
                   handle.mfx_scatter, handle.mfx_fused_closest,
                   handle.mfx_fused_anyhit, handle.mfx_fused_closest_super,
                   handle.mfx_fused_anyhit_super, handle.mfx_cull,
                   handle.mfx_closest_dbg, handle.mfx_closest_full,
                   handle.mfx_rng_fold, handle.mfx_rng_uniform):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device that all `tensors` lie on; ValueError if they lie on
    several."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("kernel operands lie on different devices: "
                         + ", ".join(sorted(map(str, devices))))
    return devices.pop()


def launch(name: str, *args) -> None:
    """Launch kernel `name` through its C entry point `mfx_<name>`. Tensors
    among `args` go as their data pointers, other values as they are, and the
    current stream of the tensors' device goes last. The tensors must lie on
    one device, which is current during the call. Raises if the launch
    failed; counts it in LAUNCHES."""
    device = same_device(*(a for a in args if isinstance(a, torch.Tensor)))
    fn = getattr(lib(), "mfx_" + name)
    with torch.cuda.device(device):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1


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
