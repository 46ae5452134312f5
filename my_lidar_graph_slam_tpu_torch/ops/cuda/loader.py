"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. Libraries are
built at first use into ``my_lidar_graph_slam_tpu_torch/build/`` (ignored
by git), named by a hash of their source and of every ``csrc/*.cuh``
header it includes, so an edited source or header is rebuilt and an
unchanged one is reused. :func:`build_all` compiles every source in
parallel, one ``nvcc`` process each.

No JAX counterpart: Pallas kernels compile inside ``jax.jit``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("correlate", "greedy_cost", "raycast", "empty")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)

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


def _digest(path: str, seen: set, h) -> None:
    """Feed ``path`` and, once each, the local headers it includes (and
    theirs) into the hash ``h``."""
    with open(path, "rb") as f:
        text = f.read()
    h.update(text)
    for header in _INCLUDE.findall(text):
        name = header.decode()
        if name not in seen:
            seen.add(name)
            _digest(os.path.join(CSRC, name), seen, h)


def _target(name: str) -> str:
    h = hashlib.sha1()
    _digest(os.path.join(CSRC, name + ".cu"), set(), h)
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


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


# ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
# on every call, a large part of a kernel wrapper's host time; PyTorch's
# own generated code reads the raw handle directly.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(tensor) -> int:
    """The raw handle of the current CUDA stream of ``tensor``'s device."""
    index = tensor.get_device()
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


# Per (kernel, device, stream): a kernel's int32 scratch, zero between its
# launches (each launch leaves it zero for the next one on its stream);
# it grows, zeroed anew, when a call needs more, and two streams never
# share one.
_scratches: Dict[tuple, torch.Tensor] = {}


def zeroed_scratch(kernel: str, device, stream: int,
                   size: int) -> torch.Tensor:
    """At least ``size`` int32 zeros that ``kernel``'s launches on
    ``stream`` share, for a kernel that clears what it uses."""
    key = (kernel, device, stream)
    buf = _scratches.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 4096), dtype=torch.int32, device=device)
        _scratches[key] = buf
    return buf


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
