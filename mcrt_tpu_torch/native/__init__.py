"""ctypes bindings for the native (C++) host runtime.

A copy of the JAX package's host runtime, kept here so the port imports nothing
of it. Builds src/mcrt_native.cpp with g++ into this package's own cached shared
library (`native/_build/`) on first use, behind a C ABI + ctypes. Every entry
point has a pure-Python fallback in accel/bvh_build.py and scene/obj.py, selected
when the toolchain is unavailable or MCRT_NO_NATIVE=1 is set (used by tests to
compare the two implementations).
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np

_SRC = pathlib.Path(__file__).parent / "src" / "mcrt_native.cpp"
_BUILD_DIR = pathlib.Path(__file__).parent / "_build"
_LIB_PATH = _BUILD_DIR / "libmcrt_native.so"

_lib = None
_load_error: str | None = None


def _build_lib() -> pathlib.Path:
    _BUILD_DIR.mkdir(exist_ok=True)
    stamp = _BUILD_DIR / "source.stamp"
    src_sig = f"{_SRC.stat().st_mtime_ns}:{_SRC.stat().st_size}"
    if _LIB_PATH.exists() and stamp.exists() and stamp.read_text() == src_sig:
        return _LIB_PATH
    cmd = [
        "g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-march=native",
        "-fno-math-errno", str(_SRC), "-o", str(_LIB_PATH),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    stamp.write_text(src_sig)
    return _LIB_PATH


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    if os.environ.get("MCRT_NO_NATIVE"):
        _load_error = "disabled via MCRT_NO_NATIVE"
        return None
    try:
        lib = ctypes.CDLL(str(_build_lib()))
    except (OSError, subprocess.CalledProcessError, FileNotFoundError) as e:
        _load_error = f"native build failed: {e}"
        print(f"mcrt_tpu_torch: {_load_error}; using Python fallbacks", file=sys.stderr)
        return None

    c_dp = ctypes.POINTER(ctypes.c_double)
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)

    lib.mcrt_bvh_build.restype = ctypes.c_void_p
    lib.mcrt_bvh_build.argtypes = [c_dp, c_dp, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.mcrt_bvh_num_nodes.restype = ctypes.c_int64
    lib.mcrt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.mcrt_bvh_num_prims.restype = ctypes.c_int64
    lib.mcrt_bvh_num_prims.argtypes = [ctypes.c_void_p]
    lib.mcrt_bvh_max_leaf.restype = ctypes.c_int32
    lib.mcrt_bvh_max_leaf.argtypes = [ctypes.c_void_p]
    lib.mcrt_bvh_export.restype = None
    lib.mcrt_bvh_export.argtypes = [ctypes.c_void_p, c_fp, c_fp, c_i32p, c_i32p,
                                    c_i32p, c_i32p]
    lib.mcrt_bvh_free.restype = None
    lib.mcrt_bvh_free.argtypes = [ctypes.c_void_p]

    lib.mcrt_obj_parse.restype = ctypes.c_void_p
    lib.mcrt_obj_parse.argtypes = [ctypes.c_char_p]
    for fn in ("mcrt_obj_num_vertices", "mcrt_obj_num_normals", "mcrt_obj_num_tris"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.mcrt_obj_has_normal_indices.restype = ctypes.c_int32
    lib.mcrt_obj_has_normal_indices.argtypes = [ctypes.c_void_p]
    lib.mcrt_obj_export.restype = None
    lib.mcrt_obj_export.argtypes = [ctypes.c_void_p, c_dp, c_dp, c_i64p, c_i64p]
    lib.mcrt_obj_free.restype = None
    lib.mcrt_obj_free.argtypes = [ctypes.c_void_p]

    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


_BVH_KINDS = {"binary_sah": 0, "quaternary_sah": 1, "octree": 2, "median": 3}


def build_bvh_native(tri_min, tri_max, kind="binary_sah", bins=16, max_leaf=8,
                     dtype=np.float32, strict_leaf=False):
    """Native FlatBVH build; returns None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from ..accel.bvh_build import FlatBVH

    tri_min = np.ascontiguousarray(tri_min, np.float64)
    tri_max = np.ascontiguousarray(tri_max, np.float64)
    P = len(tri_min)
    h = lib.mcrt_bvh_build(
        tri_min.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tri_max.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        P, bins, max_leaf, 1 if strict_leaf else 0, _BVH_KINDS[kind],
    )
    if not h:
        return None
    try:
        n = lib.mcrt_bvh_num_nodes(h)
        p = lib.mcrt_bvh_num_prims(h)
        bb_min = np.empty((n, 3), np.float32)
        bb_max = np.empty((n, 3), np.float32)
        first = np.empty(n, np.int32)
        count = np.empty(n, np.int32)
        skip = np.empty(n, np.int32)
        prim_order = np.empty(p, np.int32)
        lib.mcrt_bvh_export(
            h,
            bb_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            bb_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            skip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            prim_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        max_leaf_out = int(lib.mcrt_bvh_max_leaf(h))
    finally:
        lib.mcrt_bvh_free(h)
    return FlatBVH(
        bb_min=bb_min.astype(dtype), bb_max=bb_max.astype(dtype),
        first=first, count=count, skip=skip, prim_order=prim_order,
        max_leaf=max_leaf_out,
    )


def parse_obj_native(path):
    """Native OBJ parse; returns None if unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.mcrt_obj_parse(str(path).encode())
    if not h:
        return None  # missing file: let the Python path produce the warning
    try:
        nv = lib.mcrt_obj_num_vertices(h)
        nn = lib.mcrt_obj_num_normals(h)
        nt = lib.mcrt_obj_num_tris(h)
        has_vn = bool(lib.mcrt_obj_has_normal_indices(h))
        v = np.empty((nv, 3), np.float64)
        n = np.empty((nn, 3), np.float64)
        tv = np.empty((nt, 3), np.int64)
        tn = np.empty((nt, 3), np.int64) if has_vn else None
        lib.mcrt_obj_export(
            h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if has_vn else None,
        )
    finally:
        lib.mcrt_obj_free(h)
    return v, n, tv, tn
