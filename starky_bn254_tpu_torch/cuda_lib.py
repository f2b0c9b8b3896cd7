"""Build and load the hand-written CUDA kernels in csrc/.

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded through ctypes: no PyTorch headers, so the build
takes seconds. It happens at first use (never at import) into `_build/`
next to this file, named by a digest of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused within a checkout.

There is no fallback: a missing nvcc, a failed build or a failed launch
raises. Callers reach this module only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("ntt.cu", "keccak.cu", "poseidon.cu")
HEADERS = ("goldilocks.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_INT = ctypes.c_int

_SIGNATURES = {
    "starky_ntt": (_P, _I64, _P, _I64, _I64, _P, _U64, _INT, _P),
    "starky_keccak_sponge": (_P, _P, _I64, _I64, _I64, _INT, _P, _INT, _P),
    "starky_poseidon_sponge": (_P, _P, _I64, _I64, _I64, _P, _P, _P, _INT, _P),
    "starky_poseidon_grind": (_U64, _U64, _I64, _U64, _P, _P, _P, _P),
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libstarky_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ into the shared library unless it is already built;
    returns its path. Raises on any compiler error."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
    cmd += [os.path.join(CSRC, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = so
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_u64(name: str, *tensors: torch.Tensor) -> None:
    """The kernels read and write int64 storage holding u64 words, with a
    contiguous last axis, all on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64 storage, got {t.dtype}")
        if t.ndim and t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous")
