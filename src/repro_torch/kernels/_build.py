"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes).  All
stale sources are compiled at once, one ``nvcc`` process each, on the first
call that needs a kernel.  Libraries go to ``build/repro_torch_kernels/``
under the repository root, named by a hash of their sources and flags, so
an edited source is rebuilt and an unchanged one is reused.  A failed build
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("color_step", "knn_fuse", "kernel_matvec", "ssd_intra", "gram")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # the same guards as PyTorch's extension builds: half/bf16 values
    # convert only through the intrinsics (__bfloat162float, ...)
    "-D__CUDA_NO_HALF_OPERATORS__", "-D__CUDA_NO_HALF_CONVERSIONS__",
    "-D__CUDA_NO_BFLOAT16_CONVERSIONS__", "-D__CUDA_NO_HALF2_OPERATORS__",
)
BUILD_TIMEOUT_S = 900

_loaded: dict[str, ctypes.CDLL] = {}
builds = 0  # sources compiled by build_all in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing; returns ptxas reports.

    All ``nvcc`` processes start together and are all waited for; any
    failure raises after the others have finished.
    """
    global builds
    todo = [name for name in SOURCES if not lib_path(name).exists()]
    if not todo:
        return {}
    builds += len(todo)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp,
        )
    reports, errors = {}, []
    for name, (proc, tmp) in jobs.items():
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            errors.append(f"{name}: nvcc timed out after {BUILD_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
            reports[name] = err
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(errors))
    return reports


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each exported launcher to its ``argtypes`` (every
    launcher returns a ``cudaError_t`` as int); ``<name>_error_string`` is
    declared here.
    """
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(cond: bool, what: str) -> None:
    """Argument check of a kernel wrapper (raises ValueError)."""
    if not cond:
        raise ValueError(what)


def require_cuda_inputs(device: torch.device, named: dict) -> None:
    """Every tensor of ``named`` lies on ``device`` and is contiguous."""
    for key, t in named.items():
        if t is None:
            continue
        require(t.device == device, f"{key} is on {t.device}, expected {device}")
        require(t.is_contiguous(), f"{key} must be contiguous")
