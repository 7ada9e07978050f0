"""Device resolution and the build and load of the port's CUDA kernels.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU: :func:`resolve_device` turns ``None`` into ``cuda`` and raises
when there is no card, so a missing GPU never turns silently into a CPU run.

The kernels are CUDA C++ sources under ``repro_torch/csrc/``, one shared
library each with a plain C interface, compiled by ``nvcc`` for ``sm_90a``
and loaded through :mod:`ctypes`.  They are built at first use into
``build/repro_torch/`` at the root of the checkout; a library's file name
carries the hash of its source and flags, so an unchanged source is never
rebuilt.  Nothing here runs at import time, and nothing is built for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "repro_torch"

#: One shared library per source; ``-Xptxas -v`` writes each kernel's
#: registers, shared memory and spills into ``build/repro_torch/<name>.log``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: Every kernel source of the port.
SOURCES = ("membench", "decode_attention")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else the named device,
    which must be ``cpu`` or an available ``cuda`` device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together; returns the names actually compiled.
    Raises with the compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = BUILD_DIR / f"{name}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, lib, tmp, log, proc))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [job[0] for job in jobs]


def load(name: str, **signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed).

    ``signatures`` maps each exported function to its ``argtypes``; every
    exported function returns the ``cudaError_t`` of its launch as an int.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never runs
    and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream
