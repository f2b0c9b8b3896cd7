"""Goldilocks field arithmetic, elementwise over int64 torch tensors or
numpy uint64 arrays.

Same operations, same constants and the same branchless reduction sequence
as the JAX package's goldilocks.py, so every result is the same canonical
residue bit for bit. Two engines run the one code path (xnp.py):

* torch: a field element's 64 bits live in an int64 tensor. Wrapping add,
  sub and mul give the uint64 bits unchanged; unsigned comparisons flip
  the sign bit first and right shifts are masked after the arithmetic
  shift (`_TorchOps`).
* numpy: uint64 arrays with native unsigned ops (`_NumpyOps`); the
  verifier's host replay runs here.

Mixed operands are brought onto one engine by `_prep`: when any operand is
a tensor, numpy arrays and Python / numpy scalars become int64 tensors on
its device.

On a CUDA tensor, `add`, `sub`, `neg`, `mul`, `mul_const` and `sum_mod`
launch one field kernel each (csrc/field.cu, the same arithmetic on native
uint64_t) instead of the torch engine's chain of 10-46 elementwise kernels;
every op built on them (square, inv, the scans, the extension ops) follows.
A CUDA operand gets the kernel or an exception, never the chain: the
torch engine is the plain version, for CPU tensors (`_add_plain`, ...).

Extension field: GF(p^2) = GF(p)[X]/(X^2 - 7), a trailing dimension of size
2 (a[..., 0] + a[..., 1]*X).
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np
import torch

from . import cuda_lib, xnp

P = (1 << 64) - (1 << 32) + 1  # Goldilocks prime
EPSILON = (1 << 32) - 1  # 2^64 mod p
W = 7  # quadratic extension non-residue: GF(p^2) = GF(p)[X]/(X^2 - W)
TWO_ADICITY = 32
GENERATOR = 7

_FACTORS = [2, 3, 5, 17, 257, 65537]
assert functools.reduce(lambda a, b: a * b, _FACTORS) * 2**31 == P - 1
assert all(pow(GENERATOR, (P - 1) // q, P) != 1 for q in _FACTORS)
assert pow(W, (P - 1) // 2, P) == P - 1

POWER_OF_TWO_GENERATOR = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)


def primitive_root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity as a Python int."""
    assert 0 <= log_n <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - log_n), P)


_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
_U64 = np.dtype(np.uint64)
_SHIFTS = [np.uint64(k) for k in range(64)]  # numpy shift amounts, made once


class _NumpyOps:
    EPS = np.uint64(EPSILON)
    P = np.uint64(P)
    MASK = np.uint64(_MASK32)
    where = staticmethod(np.where)

    @staticmethod
    def shr(a, k: int):
        return a >> _SHIFTS[k]

    @staticmethod
    def shl(a, k: int):
        return a << _SHIFTS[k]

    @staticmethod
    def lt(a, b):
        return a < b

    @staticmethod
    def ge(a, b):
        return a >= b

    @staticmethod
    def from_bool(b):
        return b.astype(np.uint64)

    @staticmethod
    def ones(shape, like):
        return np.ones(shape, dtype=np.uint64)

    @staticmethod
    def zeros(shape, like):
        return np.zeros(shape, dtype=np.uint64)


class _TorchOps:
    EPS = EPSILON
    P = P - (1 << 64)  # the same 64 bits as int64
    MASK = _MASK32
    where = staticmethod(torch.where)

    @staticmethod
    def shr(a, k: int):
        return (a >> k) & ((1 << (64 - k)) - 1)

    @staticmethod
    def shl(a, k: int):
        return a << k

    @staticmethod
    def lt(a, b):
        return (a ^ _SIGN) < (b ^ _SIGN)

    @staticmethod
    def ge(a, b):
        return (a ^ _SIGN) >= (b ^ _SIGN)

    @staticmethod
    def from_bool(b):
        return b.to(torch.int64)

    @staticmethod
    def ones(shape, like):
        return torch.ones(shape, dtype=torch.int64, device=like.device)

    @staticmethod
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.int64, device=like.device)


def _prep(*xs):
    """Bring operands onto one engine; returns (operands, ops)."""
    if all(type(x) is np.ndarray and x.dtype is _U64 for x in xs):  # the host's common case
        return xs, _NumpyOps
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if ref is not None:
        return tuple(xnp.as_tensor_like(x, ref) for x in xs), _TorchOps
    out = tuple(
        x if isinstance(x, (np.ndarray, np.uint64)) and x.dtype == np.uint64
        else np.asarray(x, dtype=np.uint64)
        for x in xs
    )
    return out, _NumpyOps


# ----------------------------------------------------------------------------
# CUDA operands: one launch of csrc/field.cu per op
# ----------------------------------------------------------------------------

LAUNCHES = 0  # field-kernel launches: one per add/sub/mul/neg/mul_const/sum_mod on a CUDA operand

_ADD, _SUB, _MUL = 0, 1, 2  # field.cu's binary ops
_NEG, _MUL_CONST = 0, 1  # its unary ops
_LAYOUT = struct.Struct("<14q")  # field.cu's FieldLayout: dims, words, sizes[4], strides[4] x 2
_MAX_DIMS = 4
_MAX_WORDS = 1 << 31  # the kernels index words in 32 bits
_MASK64 = (1 << 64) - 1
_NO_STRIDES = (0,) * _MAX_DIMS


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _card_operand(x, ref: torch.Tensor):
    """An operand of an op on ref's card: (tensor, 0), or (None, word) for a
    host scalar (a Python or numpy integer, a 0-d array or CPU tensor),
    which the kernel takes by value. A numpy array goes to the card."""
    if isinstance(x, torch.Tensor):
        if x.device != ref.device:
            if x.ndim == 0 and x.device.type == "cpu":
                return None, int(x) & _MASK64
            raise ValueError(f"field op: operands on {x.device} and {ref.device}")
        if x.dtype != torch.int64:
            raise TypeError(f"field op: expected int64 words, got {x.dtype}")
        return x, 0
    if isinstance(x, np.ndarray) and x.ndim:
        return xnp.as_tensor_like(x, ref), 0
    return None, int(x) & _MASK64


def _layout(shape, operands) -> tuple[list[int], list[list[int] | None]]:
    """The kernel's dims of an elementwise walk over `shape` (row-major):
    size-1 dims dropped, and neighbours merged where every operand steps
    through the pair as through one dim. operands: (shape, strides) of
    each tensor, broadcast to `shape` (stride 0 along a broadcast dim), or
    None for a host scalar. Returns (sizes, strides of each operand)."""
    nd = len(shape)
    full = []
    for op in operands:
        if op is None:
            full.append(None)
            continue
        ts, st = op
        off = nd - len(ts)
        full.append([0] * off + [0 if ts[i] == 1 else st[i] for i in range(len(ts))])
    sizes: list[int] = []
    merged: list[list[int] | None] = [None if f is None else [] for f in full]
    for i in range(nd):
        n = shape[i]
        if n == 1:
            continue
        if sizes and all(f is None or m[-1] == f[i] * n for f, m in zip(full, merged)):
            sizes[-1] *= n
            for f, m in zip(full, merged):
                if f is not None:
                    m[-1] = f[i]
        else:
            sizes.append(n)
            for f, m in zip(full, merged):
                if f is not None:
                    m.append(f[i])
    if not sizes:  # one word
        return [1], [None if f is None else [0] for f in full]
    if len(sizes) > _MAX_DIMS:
        raise ValueError(f"field op: {len(sizes)} dims after merging, the kernels take {_MAX_DIMS}")
    return sizes, merged


def _pack(sizes, numel: int, sa, sb) -> bytes:
    pad = (0,) * (_MAX_DIMS - len(sizes))
    return _LAYOUT.pack(len(sizes), numel, *sizes, *pad, *(sa or _NO_STRIDES[: len(sizes)]),
                        *pad, *(sb or _NO_STRIDES[: len(sizes)]), *pad)


@functools.lru_cache(maxsize=4096)
def _packed_layout(a, b) -> tuple[tuple, int, bytes]:
    """(output shape, words, field.cu's layout) of an elementwise op with
    operands a and b, each (shape, strides) or None for a host scalar: kept
    per signature, since an AIR's eval repeats a few hundred of them
    thousands of times."""
    shape = tuple(torch.broadcast_shapes(*(op[0] for op in (a, b) if op is not None)))
    numel = math.prod(shape)
    if numel >= _MAX_WORDS:
        raise ValueError(f"field op: {numel} words, the kernels take fewer than {_MAX_WORDS}")
    sizes, (sa, sb) = _layout(shape, (a, b))
    return shape, numel, _pack(sizes, numel, sa, sb)


def _elementwise_plan(a, b):
    """(out, words, a tensor or None, a word, b tensor or None, b word,
    layout) of a binary op on a card; b None: a unary op."""
    ref = a if _on_card(a) else b
    ta, wa = _card_operand(a, ref)
    tb, wb = (None, 0) if b is None else _card_operand(b, ref)
    shape, numel, layout = _packed_layout(None if ta is None else (ta.shape, ta.stride()),
                                          None if tb is None else (tb.shape, tb.stride()))
    out = torch.empty(shape, dtype=torch.int64, device=ref.device)
    return out, numel, ta, wa, tb, wb, layout


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _sum_layout(shape: tuple, st: tuple, axis: int, sms: int):
    """(output shape, layout, axis length, axis stride, splits) of sum_mod on
    a card with `sms` SMs: splits 0 walks the axis in one thread an output
    word; splits >= 1 cuts it in that many slices of 32 x 8-thread blocks,
    for few outputs over a long axis (fewer than one thread an output on
    every SM)."""
    nd = len(shape)
    if not -nd <= axis < nd:
        raise ValueError(f"sum_mod: axis {axis} of a {nd}-d tensor")
    axis %= nd
    n, red_stride = shape[axis], st[axis]
    out_shape = shape[:axis] + shape[axis + 1 :]
    m = math.prod(out_shape)
    if m >= _MAX_WORDS:
        raise ValueError(f"sum_mod: {m} output words, the kernels take fewer than {_MAX_WORDS}")
    sizes, (sx,) = _layout(out_shape, [(out_shape, st[:axis] + st[axis + 1 :])])
    splits = 0
    if n >= 256 and m < sms * 256:
        tiles = -(-m // 32)
        splits = max(1, min(-(-n // 512), -(-4 * sms // tiles)))
    return out_shape, _pack(sizes, m, sx, None), n, red_stride, splits


def _launch(fn, ref: torch.Tensor, *args) -> None:
    global LAUNCHES
    lib = cuda_lib.lib()
    dev = ref.device
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, cuda_lib.stream_of(ref))
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, fn)(*args, cuda_lib.stream_of(ref))
    cuda_lib.check(err, fn)
    LAUNCHES += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _binary_cuda(op: int, a, b) -> torch.Tensor:
    out, numel, ta, wa, tb, wb, layout = _elementwise_plan(a, b)
    if numel:
        _launch("starky_field_binary", out, op, _ptr(ta), wa, _ptr(tb), wb, out.data_ptr(), layout,
                _sm_count(out.device.index))
    return out


def _unary_cuda(op: int, a, c: int = 0) -> torch.Tensor:
    out, numel, ta, _, _, _, layout = _elementwise_plan(a, None)
    if numel:
        _launch("starky_field_unary", out, op, ta.data_ptr(), c, out.data_ptr(), layout,
                _sm_count(out.device.index))
    return out


def _sum_cuda(x, axis: int) -> torch.Tensor:
    x, _ = _card_operand(x, x)
    out_shape, layout, n, red_stride, splits = _sum_layout(x.shape, x.stride(), axis,
                                                           _sm_count(x.device.index))
    out = torch.empty(out_shape, dtype=torch.int64, device=x.device)
    m = out.numel()
    if m:
        scratch = None
        if splits > 1:  # partial words, then a 32-bit counter a tile of 32 outputs
            scratch = torch.empty(2 * splits * m + -(-m // 32), dtype=torch.int64, device=x.device)
        _launch("starky_field_sum", out, x.data_ptr(), out.data_ptr(), layout, n, red_stride,
                splits, _ptr(scratch))
    return out


# ----------------------------------------------------------------------------
# Base field ops (branchless, canonical in / canonical out)
# ----------------------------------------------------------------------------


def add(a, b):
    if _on_card(a) or _on_card(b):
        return _binary_cuda(_ADD, a, b)
    return _add_plain(a, b)


def _add_plain(a, b):
    (a, b), E = _prep(a, b)
    s = a + b  # wraps mod 2^64
    s = E.where(E.lt(s, a), s + E.EPS, s)
    return E.where(E.ge(s, E.P), s - E.P, s)


def sub(a, b):
    if _on_card(a) or _on_card(b):
        return _binary_cuda(_SUB, a, b)
    return _sub_plain(a, b)


def _sub_plain(a, b):
    (a, b), E = _prep(a, b)
    d = a - b
    d = E.where(E.lt(a, b), d - E.EPS, d)
    return E.where(E.ge(d, E.P), d - E.P, d)


def neg(a):
    if _on_card(a):
        return _unary_cuda(_NEG, a)
    return _neg_plain(a)


def _neg_plain(a):
    (a,), E = _prep(a)
    return E.where(a == 0, a, E.P - a)


def _reduce128(hi, lo):
    """Reduce hi*2^64 + lo (both u64) mod p, branchless:
    2^64 === 2^32 - 1 and 2^96 === -1 (mod p)."""
    (hi, lo), E = _prep(hi, lo)
    hi_hi = E.shr(hi, 32)
    hi_lo = hi & E.MASK
    t0 = lo - hi_hi
    t0 = E.where(E.lt(lo, hi_hi), t0 - E.EPS, t0)
    t1 = hi_lo * E.EPS  # < 2^64 exactly
    s = t0 + t1
    s = E.where(E.lt(s, t1), s + E.EPS, s)
    return E.where(E.ge(s, E.P), s - E.P, s)


def _mul128(a_lo, a_hi, b_lo, b_hi, E):
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    hi_hi = a_hi * b_hi
    mid = hi_lo + E.shr(lo_lo, 32)  # < 2^64
    mid = mid + lo_hi
    mid_carry = E.lt(mid, lo_hi)
    lo = E.shl(mid, 32) | (lo_lo & E.MASK)
    hi = hi_hi + E.shr(mid, 32) + E.shl(E.from_bool(mid_carry), 32)
    return hi, lo


def mul(a, b):
    """Full 64x64 -> 128-bit product via 32-bit halves, then reduce."""
    if _on_card(a) or _on_card(b):
        return _binary_cuda(_MUL, a, b)
    return _mul_plain(a, b)


def _mul_plain(a, b):
    (a, b), E = _prep(a, b)
    if E is _NumpyOps:
        return _mul_numpy(a, b)
    hi, lo = _mul128(a & E.MASK, E.shr(a, 32), b & E.MASK, E.shr(b, 32), E)
    return _reduce128(hi, lo)


def _mul_numpy(a, b):
    """mul on numpy: the same 128-bit product and reduction, updated in
    place where the operand is a fresh full-shape array (a quarter fewer
    passes over memory; the host sponges spend most of their time here)."""
    m, s32, eps = _NumpyOps.MASK, _SHIFTS[32], _NumpyOps.EPS
    a0, a1, b0, b1 = a & m, a >> s32, b & m, b >> s32
    lo, mid, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid += hl
    hi = (mid < hl).astype(np.uint64)  # the carry of lo_hi + hi_lo, worth 2^96
    hi <<= s32
    hi += hh
    hi += mid >> s32
    mid <<= s32
    lo += mid
    hi += lo < mid
    # _reduce128(hi, lo): 2^64 = EPSILON, 2^96 = -1 (mod p)
    hi_hi = hi >> s32
    hi &= m
    hi *= eps
    out = lo - hi_hi
    out -= (lo < hi_hi) * eps
    out += hi
    out += (out < hi) * eps
    out -= (out >= _NumpyOps.P) * _NumpyOps.P
    return out


def square(a):
    return mul(a, a)


def mul_const(a, c: int):
    """Multiply by a small Python-int constant (c < 2^32)."""
    assert 0 <= c < (1 << 32)
    if _on_card(a):
        return _unary_cuda(_MUL_CONST, a, c)
    return _mul_const_plain(a, c)


def _mul_const_plain(a, c: int):
    (a,), E = _prep(a)
    a_lo = a & E.MASK
    a_hi = E.shr(a, 32)
    cc = np.uint64(c) if E is _NumpyOps else c
    lo_prod = a_lo * cc
    hi_prod = a_hi * cc
    mid = hi_prod + E.shr(lo_prod, 32)
    lo = E.shl(mid, 32) | (lo_prod & E.MASK)
    hi = E.shr(mid, 32)
    return _reduce128(hi, lo)


def pow_const(a, e: int):
    """a^e for a fixed Python-int exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e > 0:
            base = square(base)
    if result is None:
        return xnp.ones_like(a)
    return result


def _sq_n(x, n: int):
    for _ in range(n):
        x = square(x)
    return x


def inv(a):
    """Fermat inverse a^(p-2) by the 2^k-1 addition chain (~75 squarings +
    10 multiplies); inv(0) = 0. p-2 = (2^31-1)*2^33 + 2^32 - 1 and with
    f(k) = a^(2^k-1), f(k+m) = f(k)^(2^m) * f(m)."""
    f1 = a
    f2 = mul(_sq_n(f1, 1), f1)
    f3 = mul(_sq_n(f2, 1), f1)
    f4 = mul(_sq_n(f2, 2), f2)
    f7 = mul(_sq_n(f4, 3), f3)
    f8 = mul(_sq_n(f4, 4), f4)
    f15 = mul(_sq_n(f8, 7), f7)
    f16 = mul(_sq_n(f8, 8), f8)
    f31 = mul(_sq_n(f16, 15), f15)
    f32 = mul(_sq_n(f31, 1), f1)
    return mul(_sq_n(f31, 33), f32)


def batch_inv(a):
    """Elementwise Fermat inversion; zeros map to zero."""
    return inv(a)


# ----------------------------------------------------------------------------
# Quadratic extension GF(p^2): arrays with trailing dim 2
# ----------------------------------------------------------------------------


def ext_add(a, b):
    return add(a, b)


def ext_sub(a, b):
    return sub(a, b)


def ext_neg(a):
    return neg(a)


def ext_mul(a, b):
    (a, b), _ = _prep(a, b)
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    t0 = mul(a0, b0)
    t1 = mul(a1, b1)
    c0 = add(t0, mul_const(t1, W))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return xnp.stack([c0, c1], axis=-1)


def ext_scalar_mul(a, s):
    """Multiply extension array by base-field array s (broadcast)."""
    return mul(a, s[..., None])


def ext_square(a):
    return ext_mul(a, a)


def ext_inv(a):
    # (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2)
    (a,), _ = _prep(a)
    a0, a1 = a[..., 0], a[..., 1]
    norm = sub(square(a0), mul_const(square(a1), W))
    ninv = inv(norm)
    return xnp.stack([mul(a0, ninv), mul(neg(a1), ninv)], axis=-1)


def ext_pow_const(a, e: int):
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e > 0:
            base = ext_square(base)
    if result is None:
        return xnp.at_set(xnp.zeros_like(a), (..., 0), 1)
    return result


def ext_from_base(a):
    """Embed base-field array as extension elements (trailing dim 2)."""
    return xnp.stack([a, xnp.zeros_like(a)], axis=-1)


# ----------------------------------------------------------------------------
# Reductions / scans
# ----------------------------------------------------------------------------


def sum_mod(x, axis: int):
    """Exact modular sum along an axis: 32-bit halves summed exactly (up to
    2^32 terms), then recombined mod p."""
    if _on_card(x):
        return _sum_cuda(x, axis)
    return _sum_mod_plain(x, axis)


def _sum_mod_plain(x, axis: int):
    (x,), E = _prep(x)
    lo = xnp.sum(x & E.MASK, axis=axis)
    hi = xnp.sum(E.shr(x, 32), axis=axis)
    lo2 = E.shl(hi, 32) + lo
    carry = E.lt(lo2, lo)
    hi2 = E.shr(hi, 32) + E.from_bool(carry)
    return _reduce128(hi2, lo2)


def powers_vec(base, n: int):
    """[1, base, base^2, ..., base^{n-1}] for a scalar base (doubling)."""
    (base,), E = _prep(base)
    out = E.ones((1,), base)
    step = base
    while out.shape[0] < n:
        out = xnp.concatenate([out, mul(out, step)])
        step = mul(step, step)
    return out[:n]


def cumprod(x):
    """Modular inclusive prefix product along axis 0: Hillis-Steele doubling
    (log n shifted multiplies)."""
    (x,), E = _prep(x)
    n = x.shape[0]
    d = 1
    while d < n:
        shifted = xnp.concatenate([E.ones((d,) + tuple(x.shape[1:]), x), x[:-d]], axis=0)
        x = mul(x, shifted)
        d *= 2
    return x


def cumsum(x):
    """Modular inclusive prefix sum along axis 0 (Hillis-Steele)."""
    (x,), E = _prep(x)
    n = x.shape[0]
    d = 1
    while d < n:
        shifted = xnp.concatenate([E.zeros((d,) + tuple(x.shape[1:]), x), x[:-d]], axis=0)
        x = add(x, shifted)
        d *= 2
    return x


def ext_powers_vec(base_ext, n: int):
    """[(1,0), b, b^2, ..., b^{n-1}] for an extension scalar b: [n, 2]."""
    (base,), E = _prep(base_ext)
    out = xnp.at_set(E.zeros((1, 2), base), (0, 0), 1)
    step = base
    while out.shape[0] < n:
        out = xnp.concatenate([out, ext_mul(out, step[None, :])], axis=0)
        step = ext_mul(step, step)
    return out[:n]
