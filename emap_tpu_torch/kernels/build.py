"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc, at first use, into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes). Libraries land in `emap_tpu_torch/build/` (listed in
.gitignore), named by a hash of the sources, so a changed source rebuilds
and an unchanged one is reused. `build_all` starts one nvcc per source, all
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
SOURCES = ("mlp_query", "mlp_query_tf32", "mlp_query_wgmma", "mlp_train",
           "mlp_train_tf32", "mlp_train_wgmma", "mlp_value", "mlp_value_tf32",
           "mlp_value_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu (by source hash)."""
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel. Returns {name: seconds}
    (0.0 for one already built). Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, times = {}, {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            times[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if it is missing."""
    if name not in _loaded:
        path = lib_path(name)
        if not os.path.exists(path):
            build_all((name,))
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]


def build_log(name: str) -> str:
    """nvcc's output (-Xptxas -v: registers, shared memory, spills)."""
    path = lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def parse_ptxas(log: str) -> dict:
    """Each entry function's registers and spilled bytes (stores + loads)
    from ptxas' report (-Xptxas -v) in nvcc's output: {mangled name:
    {"registers": n, "spill_bytes": m}}."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = props = m.group(1)
            out[entry] = {"registers": 0, "spill_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == entry:
            out[entry]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out
