"""Build and load the hand-written CUDA kernels in csrc/.

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded through ctypes: no PyTorch headers, so the build
takes seconds. Each source compiles in its own nvcc process, all started
together, then one link. It happens at first use (never at import) into
`_build/` next to this file, named by a digest of the sources and flags, so
an edited kernel is rebuilt and an unchanged one is reused within a
checkout. ptxas's register and spill report (-Xptxas -v) is kept beside the
library (`ptxas_report`).

Sources: K1 (ntt.cu), K2 (keccak.cu), K3 (poseidon.cu) and the field
kernels of goldilocks.py's ops on CUDA tensors (field.cu).

`sass_op_counts` compiles csrc/sass_probes.cu (one butterfly, one Keccak
round, one Poseidon round, with the library's flags) and counts their
integer instructions with cuobjdump: the operation counts of the kernels'
bounds.

There is no fallback: a missing nvcc, a failed build or a failed launch
raises. Callers reach this module only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("ntt.cu", "keccak.cu", "poseidon.cu", "field.cu")
HEADERS = ("goldilocks.cuh",)
PROBES = "sass_probes.cu"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = ARCH_FLAGS + ("-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_INT = ctypes.c_int

_SIGNATURES = {
    "starky_ntt_pass": (_P, _I64, _P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _P, _U64, _INT,
                        _INT, _P),
    "starky_keccak_sponge": (_P, _P, _I64, _I64, _I64, _INT, _P, _INT, _P),
    "starky_poseidon_sponge": (_P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _INT, _INT, _INT, _P),
    "starky_poseidon_grind": (_P, _INT, _INT, _U64, _I64, _U64, _P, _P, _P, _INT, _P, _P),
    "starky_field_binary": (_INT, _P, _U64, _P, _U64, _P, ctypes.c_char_p, _INT, _P),
    "starky_field_unary": (_INT, _P, _U64, _P, ctypes.c_char_p, _INT, _P),
    "starky_field_sum": (_P, _P, ctypes.c_char_p, _I64, _I64, _INT, _P, _P),
}

_LIB: ctypes.CDLL | None = None


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built")
    return path


def _digest(names) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in names:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libstarky_kernels-{_digest(SOURCES + HEADERS)}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise on the first failure. Returns
    each one's output (ptxas -v writes its report there)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build() -> str:
    """Compile csrc/ into the shared library unless it is already built;
    returns its path. Raises on any compiler error."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _tool("nvcc")
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                     for s, o in zip(SOURCES, objs)])
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", f"{tmp}.so", *objs]])
    with open(f"{out}.ptxas.txt", "w") as f:
        f.write("".join(logs))
    for o in objs:
        os.remove(o)
    os.replace(f"{tmp}.so", out)
    return out


def ptxas_report() -> dict[str, dict[str, int]]:
    """{mangled kernel name: {registers, stack, spill_stores, spill_loads}}
    from the build's -Xptxas -v log."""
    with open(f"{build()}.ptxas.txt") as f:
        log = f.read()
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


# SASS opcodes that are no integer operation of the arithmetic: memory,
# control, moves and constant/special-register reads
_NOT_OPS = ("LD", "ST", "ATOM", "RED", "BRA", "EXIT", "RET", "CALL", "NOP", "BAR", "S2R", "S2UR",
            "CS2R", "MOV", "IMAD.MOV", "U", "LDC", "BSSY", "BSYNC", "WARPSYNC", "YIELD", "DEPBAR",
            "MEMBAR", "CCTL", "SHFL", "VOTE")


def sass_op_counts() -> dict[str, int]:
    """Integer instructions in the SASS of each probe kernel of
    csrc/sass_probes.cu ({probe name: count}), compiled with the library's
    flags and read back with cuobjdump -sass."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cubin = os.path.join(BUILD_DIR, f"sass_probes-{_digest(SOURCES + HEADERS + (PROBES,))}.cubin")
    if not os.path.exists(cubin):
        _run_all([[_tool("nvcc"), *ARCH_FLAGS, "-cubin", "-o", cubin, os.path.join(CSRC, PROBES)]])
    sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m and not m.group(1).startswith(_NOT_OPS):
            counts[name] += 1
    return {k: v for k, v in counts.items() if k.startswith("probe_")}


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
    """The current stream's handle on t's card, read without building a
    torch.cuda.Stream (as torch's own kernel launchers read it): a field
    op's launch pays this every call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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
