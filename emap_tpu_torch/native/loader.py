"""ctypes loader and on-demand build of the native polyline growth
(connect_points.cpp, the port's copy of emap_tpu/native/connect_points.cpp).

The library is compiled by g++ at first use into `emap_tpu_torch/build/`
(listed in .gitignore), named by a hash of the source and flags, with the
JAX package's flags, so the two builds compute the same polylines. A failed
build raises: the native and the Python growth draw different seed
sequences, so quietly taking the Python growth instead would change the
extraction.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "connect_points.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"connect_points-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native polyline growth "
                           "builds with g++") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built if it is missing; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.emap_connect_points.restype = ctypes.c_int
            lib.emap_connect_points.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # pts
                ctypes.c_int64,                   # n
                ctypes.c_double,                  # distance_threshold
                ctypes.c_double,                  # angle_threshold
                ctypes.c_double,                  # nms_factor
                ctypes.c_int,                     # keep_short_lines
                ctypes.c_uint64,                  # seed
                ctypes.POINTER(ctypes.c_int32),   # out_indices
                ctypes.POINTER(ctypes.c_int64),   # out_offsets
                ctypes.POINTER(ctypes.c_int64),   # n_polylines
            ]
            _lib = lib
        return _lib


def connect_points_native(points_wld: np.ndarray, distance_threshold: float,
                          angle_threshold: float, nms_factor: float,
                          keep_short_lines: bool, seed: int = 0):
    """Grid-hashed greedy polyline growth over (N, 6) [xyz, line-direction]
    points; returns a list of index lists. Same attachment/NMS/stop rules as
    fitting.connect_points (the growth seeds differ in RNG sequence only)."""
    lib = load()
    pts = np.ascontiguousarray(points_wld, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 6:
        raise ValueError(f"points must be (N, 6), got {pts.shape}")
    n = len(pts)
    out_indices = np.empty(max(n, 1), dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    n_poly = ctypes.c_int64(0)
    rc = lib.emap_connect_points(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        ctypes.c_double(distance_threshold),
        ctypes.c_double(angle_threshold),
        ctypes.c_double(nms_factor),
        ctypes.c_int(1 if keep_short_lines else 0),
        ctypes.c_uint64(seed),
        out_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(n_poly),
    )
    if rc != 0:
        raise RuntimeError(f"emap_connect_points failed with code {rc}")
    return [out_indices[out_offsets[i]: out_offsets[i + 1]].tolist()
            for i in range(n_poly.value)]
