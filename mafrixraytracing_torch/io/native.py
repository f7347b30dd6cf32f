"""ctypes bindings for the native OBJ parser (`native/fastobj.cpp`).

Port of `mafrixraytracing_tpu/io/native.py`: the C++ parser is compiled on
demand with g++ into `native/build/` at the repository root (kept there
between runs, rebuilt when the source is newer) and loaded with ctypes.
`load_obj_native` returns the same `ObjModel` as the Python parser;
`io.obj.load_obj(use_native="auto")` prefers it and parses in Python when no
compiler is found, and `use_native=True` raises instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_build_error: str | None = None

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
# a file of the port's own: the JAX package writes its library in place
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libfastobj_torch.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "fastobj.cpp")


def _build() -> str | None:
    """Compile the parser; returns None, or why it could not be built. The
    library is written under another name and renamed, so a concurrent
    process never loads half a file."""
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.part"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC_PATH, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        return None
    except subprocess.CalledProcessError as e:
        return f"g++ failed ({e.returncode}): {e.stderr.decode(errors='replace')}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ could not be run: {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_SO_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_SO_PATH)
        ):
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.fastobj_load.restype = ctypes.c_void_p
        lib.fastobj_load.argtypes = [ctypes.c_char_p]
        lib.fastobj_free.argtypes = [ctypes.c_void_p]
        for name in ("num_vertices", "num_uvs", "num_normals", "num_faces"):
            fn = getattr(lib, f"fastobj_{name}")
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        for name in ("vertices", "uvs", "normals"):
            fn = getattr(lib, f"fastobj_{name}")
            fn.restype = ctypes.POINTER(ctypes.c_float)
            fn.argtypes = [ctypes.c_void_p]
        for name in ("face_v", "face_t", "face_n", "face_group", "face_material"):
            fn = getattr(lib, f"fastobj_{name}")
            fn.restype = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [ctypes.c_void_p]
        for name in ("group_names", "material_names", "mtllibs"):
            fn = getattr(lib, f"fastobj_{name}")
            fn.restype = ctypes.c_char_p
            fn.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native parser is unavailable, or None."""
    _load()
    return _build_error


def load_obj_native(path: str):
    """Parse an OBJ with the native parser -> `io.obj.ObjModel`, or None if
    the native library is unavailable."""
    from mafrixraytracing_torch.io.mtl import load_mtl
    from mafrixraytracing_torch.io.obj import ObjModel

    lib = _load()
    if lib is None:
        return None
    handle = lib.fastobj_load(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        nv = lib.fastobj_num_vertices(handle)
        nt = lib.fastobj_num_uvs(handle)
        nn = lib.fastobj_num_normals(handle)
        nf = lib.fastobj_num_faces(handle)

        def farr(fn, n, k):
            if n == 0:
                return np.zeros((0, k), np.float32)
            return np.ctypeslib.as_array(fn(handle), shape=(n * k,)).astype(
                np.float32).reshape(n, k)

        def iarr(fn, n, k=1):
            if n == 0:
                return np.zeros((n, k) if k > 1 else (n,), np.int32)
            a = np.ctypeslib.as_array(fn(handle), shape=(n * k,)).astype(np.int32)
            return a.reshape(n, k) if k > 1 else a

        vertices = farr(lib.fastobj_vertices, nv, 3)
        uvs = farr(lib.fastobj_uvs, nt, 2)
        normals = farr(lib.fastobj_normals, nn, 3)
        fv = iarr(lib.fastobj_face_v, nf, 3)
        ft = iarr(lib.fastobj_face_t, nf, 3)
        fn_ = iarr(lib.fastobj_face_n, nf, 3)
        fg = iarr(lib.fastobj_face_group, nf)
        fm = iarr(lib.fastobj_face_material, nf)
        group_names = lib.fastobj_group_names(handle).decode().split("\n")
        mat_names = lib.fastobj_material_names(handle).decode()
        mat_names = mat_names.split("\n") if mat_names else []
        mtllibs = lib.fastobj_mtllibs(handle).decode()
        mtllibs = mtllibs.split("\n") if mtllibs else []
    finally:
        lib.fastobj_free(handle)

    materials = {}
    material_order = []
    base = os.path.dirname(os.path.abspath(path))
    for m in mtllibs:
        mtl_path = os.path.join(base, m)
        if os.path.exists(mtl_path):
            for nm, spec in load_mtl(mtl_path).items():
                if nm not in materials:
                    materials[nm] = spec
                    material_order.append(nm)

    return ObjModel(
        vertices=vertices, uvs=uvs, normals=normals, face_v=fv, face_t=ft,
        face_n=fn_, face_group=fg, face_material=fm, group_names=group_names,
        usemtl_names=mat_names, materials=materials,
        material_order=material_order)
