"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. Libraries are
built at first use into ``my_lidar_graph_slam_tpu_torch/build/`` (ignored
by git), named by a hash of their source, so an edited source is rebuilt
and an unchanged one is reused. :func:`build_all` compiles every source in
parallel, one ``nvcc`` process each.

No JAX counterpart: Pallas kernels compile inside ``jax.jit``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("correlate", "greedy_cost")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each library built by this
# process (empty for a library reused from an earlier build).
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start an nvcc build of ``name`` unless its library exists; returns
    (target, tmp, process) or None."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, job) -> None:
    target, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    ptxas_report[name] = out
    os.replace(tmp, target)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every named source in parallel; raise if any build fails."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
