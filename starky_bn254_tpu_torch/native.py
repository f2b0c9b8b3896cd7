"""ctypes bindings for the native witness generator (native/witness.cpp).

The C++ source at the repository root is shared with the JAX package; this
module builds its own copy of the library from it, with
`g++ -O3 -march=native -shared -fPIC -pthread`, at first use (never at
import) into `_build/` next to this file. The library's name carries a
digest of the source, the flags and the host (-march=native code is only
valid where it was built). It is built under a temporary name and moved
into place with `os.replace`, so processes that build at the same moment
each see a whole library.

There is no fallback: a missing compiler, a failed build or a failed load
raises, and so does every call when the library reports a bad input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

from . import goldilocks as gl
from .utils.conversions import N_LIMBS

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "native", "witness.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_I64 = ctypes.c_int64
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)

_POINT_CHAIN = (_I64, _I64,              # n, rows
                _U16P, _U16P, _U16P, _U16P,  # ax0, ay0, bx0, by0
                _U8P, _U8P,              # is_double, bits
                _U64P,                   # main_out
                _I64, _I64, _I64,        # row stride, coord and cells offsets
                _U16P, _U16P)            # final_bx, final_by
_FIELD_CHAIN = (_I64, _I64,              # n, rows
                _U16P, _U16P,            # a0, b0
                _U8P, _U8P,              # is_square, bits
                _U64P,                   # main_out
                _I64, _I64, _I64,        # row stride, coord and cells offsets
                _U16P)                   # final_b
_SIGNATURES = {
    "batch_modular_witness": (_I64, _I64P, ctypes.c_int32, _U16P, _U16P, _U16P, _U16P, _U16P,
                              _U8P),
    "batch_fq_inv": (_I64, _U16P, _U16P),
    "g1_exp_chain": _POINT_CHAIN,
    "g2_exp_chain": _POINT_CHAIN,
    "fq_exp_chain": _FIELD_CHAIN,
    "fq12_exp_chain": _FIELD_CHAIN,
    "hist_u16_cols": (_U64P, _I64, _I64, _I64P, _I64, _I64P),
}

_LIB: ctypes.CDLL | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + (platform.machine(), platform.node())).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwitness-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile native/witness.cpp unless this host already has it; returns
    the library's path. Raises on any compiler error."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native witness generator cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}) building {SOURCE}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int64
        _LIB = so
    return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def batch_modular_witness(pol_inputs: np.ndarray, zero_op: bool) -> dict:
    """pol_inputs: [n, 31] int64 (signed). Returns dict of numpy arrays:
    outputs [n,16], out_aux_red [n,16], quot_abs [n,17], aux_lo [n,31],
    aux_hi [n,31], signs [n] (canonical field values: 1 or p-1), all uint64.
    """
    n = pol_inputs.shape[0]
    if pol_inputs.ndim != 2 or pol_inputs.shape[1] != 2 * N_LIMBS - 1:
        raise ValueError(f"batch_modular_witness: expected [n, 31], got {pol_inputs.shape}")
    pol = np.ascontiguousarray(pol_inputs, dtype=np.int64)
    outputs = np.zeros((n, N_LIMBS), dtype=np.uint16)
    oar = np.zeros((n, N_LIMBS), dtype=np.uint16)
    qabs = np.zeros((n, N_LIMBS + 1), dtype=np.uint16)
    lo = np.zeros((n, 2 * N_LIMBS - 1), dtype=np.uint16)
    hi = np.zeros((n, 2 * N_LIMBS - 1), dtype=np.uint16)
    signs = np.zeros(n, dtype=np.uint8)
    rc = lib().batch_modular_witness(
        n, _ptr(pol, ctypes.c_int64), 1 if zero_op else 0,
        _ptr(outputs, ctypes.c_uint16), _ptr(oar, ctypes.c_uint16),
        _ptr(qabs, ctypes.c_uint16), _ptr(lo, ctypes.c_uint16), _ptr(hi, ctypes.c_uint16),
        _ptr(signs, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"native modular witness failed at row {rc - 1}")
    return {
        "outputs": outputs.astype(np.uint64),
        "out_aux_red": oar.astype(np.uint64),
        "quot_abs": qabs.astype(np.uint64),
        "aux_lo": lo.astype(np.uint64),
        "aux_hi": hi.astype(np.uint64),
        "signs": np.where(signs == 1, np.uint64(1), np.uint64(gl.P - 1)),
    }


def batch_fq_inv(limbs: np.ndarray) -> np.ndarray:
    """limbs: [n, 16] u16 values of nonzero Fq elements; returns inverses."""
    n = limbs.shape[0]
    inp = np.ascontiguousarray(limbs, dtype=np.uint16)
    out = np.zeros((n, N_LIMBS), dtype=np.uint16)
    rc = lib().batch_fq_inv(n, _ptr(inp, ctypes.c_uint16), _ptr(out, ctypes.c_uint16))
    if rc != 0:
        raise ValueError(f"native fq inverse failed at row {rc - 1}")
    return out.astype(np.uint64)


def g1_exp_chain(
    ax: np.ndarray,  # [n, 16] u64 limbs
    ay: np.ndarray,
    bx: np.ndarray,
    by: np.ndarray,
    is_double: np.ndarray,  # [rows] bool/u8
    bits: np.ndarray,  # [n, rows] bool/u8
    main: np.ndarray,  # [n, rows, row_stride] u64 C-contiguous trace block
    coord_off: int,
    cells_off: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Runs the whole G1 double-and-add witness chain in C++, writing the
    per-row coordinates (cells [coord_off, coord_off + 64)) and G1Output
    cells ([cells_off, cells_off + 320)) straight into `main`. Returns
    (final_bx, final_by) u64 limb arrays (the proven outputs)."""
    n, rows, row_stride = main.shape
    if not (main.flags.c_contiguous and main.dtype == np.uint64):
        raise ValueError("g1_exp_chain: main must be a C-contiguous uint64 array")
    if coord_off + 4 * N_LIMBS > row_stride or cells_off + 20 * N_LIMBS > row_stride:
        raise ValueError("g1_exp_chain: cell offsets run past the row")
    if ax.shape != (n, N_LIMBS) or bits.shape != (n, rows) or is_double.shape != (rows,):
        raise ValueError("g1_exp_chain: input shapes disagree with main")
    ax16, ay16, bx16, by16 = (np.ascontiguousarray(v, dtype=np.uint16) for v in (ax, ay, bx, by))
    isd = np.ascontiguousarray(is_double, dtype=np.uint8)
    bts = np.ascontiguousarray(bits, dtype=np.uint8)
    fbx = np.zeros((n, N_LIMBS), dtype=np.uint16)
    fby = np.zeros((n, N_LIMBS), dtype=np.uint16)
    rc = lib().g1_exp_chain(
        n, rows,
        _ptr(ax16, ctypes.c_uint16), _ptr(ay16, ctypes.c_uint16),
        _ptr(bx16, ctypes.c_uint16), _ptr(by16, ctypes.c_uint16),
        _ptr(isd, ctypes.c_uint8), _ptr(bts, ctypes.c_uint8),
        _ptr(main, ctypes.c_uint64),
        row_stride, coord_off, cells_off,
        _ptr(fbx, ctypes.c_uint16), _ptr(fby, ctypes.c_uint16),
    )
    if rc != 0:
        raise ValueError(f"native g1 chain failed at (inst*rows+row)={rc - 1}")
    return fbx.astype(np.uint64), fby.astype(np.uint64)


def g2_exp_chain(
    ax: np.ndarray,  # [n, 2, 16] u64 limbs (Fq2 component-major)
    ay: np.ndarray,
    bx: np.ndarray,
    by: np.ndarray,
    is_double: np.ndarray,  # [rows] bool/u8
    bits: np.ndarray,  # [n, rows] bool/u8
    main: np.ndarray,  # [n, rows, row_stride] u64 C-contiguous trace block
    coord_off: int,
    cells_off: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Fq2 twin of g1_exp_chain: the whole G2 double-and-add witness chain
    in one call, the coordinates (cells [coord_off, coord_off + 128)) and
    G2Output cells ([cells_off, cells_off + 640)) written straight into
    `main`. Returns (final_bx, final_by) as [n, 2, 16] u64 limbs."""
    n, rows, row_stride = main.shape
    if not (main.flags.c_contiguous and main.dtype == np.uint64):
        raise ValueError("g2_exp_chain: main must be a C-contiguous uint64 array")
    if coord_off + 8 * N_LIMBS > row_stride or cells_off + 40 * N_LIMBS > row_stride:
        raise ValueError("g2_exp_chain: cell offsets run past the row")
    if any(v.shape != (n, 2, N_LIMBS) for v in (ax, ay, bx, by)) \
            or bits.shape != (n, rows) or is_double.shape != (rows,):
        raise ValueError("g2_exp_chain: input shapes disagree with main")
    ax16, ay16, bx16, by16 = (np.ascontiguousarray(v, dtype=np.uint16) for v in (ax, ay, bx, by))
    isd = np.ascontiguousarray(is_double, dtype=np.uint8)
    bts = np.ascontiguousarray(bits, dtype=np.uint8)
    fbx = np.zeros((n, 2, N_LIMBS), dtype=np.uint16)
    fby = np.zeros((n, 2, N_LIMBS), dtype=np.uint16)
    rc = lib().g2_exp_chain(
        n, rows,
        _ptr(ax16, ctypes.c_uint16), _ptr(ay16, ctypes.c_uint16),
        _ptr(bx16, ctypes.c_uint16), _ptr(by16, ctypes.c_uint16),
        _ptr(isd, ctypes.c_uint8), _ptr(bts, ctypes.c_uint8),
        _ptr(main, ctypes.c_uint64),
        row_stride, coord_off, cells_off,
        _ptr(fbx, ctypes.c_uint16), _ptr(fby, ctypes.c_uint16),
    )
    if rc != 0:
        raise ValueError(f"native g2 chain failed at (inst*rows+row)={rc - 1}")
    return fbx.astype(np.uint64), fby.astype(np.uint64)


# per chain: the shape of one value's limbs and the cells of one row's
# multiply output block (FqOutput 7*16, Fq12Output 84*16)
_FIELD_CHAINS = {
    "fq_exp_chain": ((N_LIMBS,), 7 * N_LIMBS),
    "fq12_exp_chain": ((12, N_LIMBS), 84 * N_LIMBS),
}


def exp_chain(
    name: str,  # "fq_exp_chain" | "fq12_exp_chain"
    a: np.ndarray,  # [n, 16] (fq) or [n, 12, 16] (fq12) u64 limbs
    b: np.ndarray,
    is_square: np.ndarray,  # [rows] bool/u8
    bits: np.ndarray,  # [n, rows] bool/u8
    main: np.ndarray,  # [n, rows, row_stride] u64 C-contiguous trace block
    coord_off: int,
    cells_off: int,
) -> np.ndarray:
    """Runs a whole square-and-multiply witness chain (Fq or Fq12) in one
    C++ call. Row r of every instance squares `a` where is_square[r] is
    set; elsewhere an instance whose bit is set does b = a * b and the
    others write the zero output block. The per-row a, b (cells
    [coord_off, coord_off + 2 * value cells)) and the multiply's output
    cells ([cells_off, cells_off + output cells)) go straight into `main`.
    Returns final_b (the proven outputs), shaped like `a`."""
    if name not in _FIELD_CHAINS:
        raise ValueError(f"exp_chain: unknown chain {name!r}")
    value_shape, out_cells = _FIELD_CHAINS[name]
    value_cells = int(np.prod(value_shape))
    n, rows, row_stride = main.shape
    if not (main.flags.c_contiguous and main.dtype == np.uint64):
        raise ValueError(f"{name}: main must be a C-contiguous uint64 array")
    if coord_off + 2 * value_cells > row_stride or cells_off + out_cells > row_stride:
        raise ValueError(f"{name}: cell offsets run past the row")
    if a.shape != (n, *value_shape) or b.shape != a.shape or bits.shape != (n, rows) \
            or is_square.shape != (rows,):
        raise ValueError(f"{name}: input shapes disagree with main")
    a16, b16 = (np.ascontiguousarray(v, dtype=np.uint16) for v in (a, b))
    isq = np.ascontiguousarray(is_square, dtype=np.uint8)
    bts = np.ascontiguousarray(bits, dtype=np.uint8)
    fb = np.zeros_like(b16)
    rc = getattr(lib(), name)(
        n, rows,
        _ptr(a16, ctypes.c_uint16), _ptr(b16, ctypes.c_uint16),
        _ptr(isq, ctypes.c_uint8), _ptr(bts, ctypes.c_uint8),
        _ptr(main, ctypes.c_uint64),
        row_stride, coord_off, cells_off,
        _ptr(fb, ctypes.c_uint16),
    )
    if rc != 0:
        raise ValueError(f"native {name} failed at (inst*rows+row)={rc - 1}")
    return fb.astype(np.uint64)


def hist_u16_cols(view: np.ndarray, cols) -> np.ndarray:
    """Counts of each u16 value across `view[:, cols]` (u64 cells < 2^16)
    without materializing the selected columns: view is a [n, C] u64 array
    (any row stride, unit column stride). Returns int64[65536]. Raises on
    any cell >= 2^16."""
    if view.dtype != np.uint64 or view.ndim != 2 or view.strides[1] != 8:
        raise ValueError("hist_u16_cols: expected a [n, C] uint64 view with unit column stride")
    cols64 = np.ascontiguousarray(cols, dtype=np.int64)
    if cols64.size and (cols64.min() < 0 or cols64.max() >= view.shape[1]):
        raise ValueError("hist_u16_cols: column index out of range")
    out = np.zeros(65536, dtype=np.int64)
    rc = lib().hist_u16_cols(
        view.ctypes.data_as(_U64P), view.shape[0], view.strides[0] // 8,
        _ptr(cols64, ctypes.c_int64), cols64.shape[0], _ptr(out, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError(f"hist_u16_cols: cell >= 2^16 at flat index {rc - 1}")
    return out
