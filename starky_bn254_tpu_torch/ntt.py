"""Number-theoretic transform and low-degree extension over Goldilocks.

`ntt` is the wrapper of kernel K1 (csrc/ntt.cu): on a CUDA tensor every
call, 1-D input included, launches the hand-written kernel; on a CPU tensor
it runs `_ntt_plain`, the same radix-2 DIT ladder written in torch ops
(bit-reversal gather, then log2(n) butterfly stages). Both give exactly the
JAX package's ntt._ntt_xla output: an NTT's values do not depend on the
algorithm, and all arithmetic is exact mod p.

All transforms are batched over a trailing column axis: the trace is
`[rows, cols]` and one call transforms every column. Coset LDE evaluates on
`shift * <w_{n*blowup}>`, so Z_H(x) = x^n - 1 is nonzero on the domain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import xnp

LAUNCHES = 0  # K1 launches (one per ntt call on a CUDA tensor)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Twiddles of each radix-2 stage of a size-2^log_n NTT: stage s
    (half-size m = 2^s) needs w_{2m}^j, j in [0, m), w_{2m} a primitive
    (2m)-th root (its inverse for the inverse transform)."""
    n = 1 << log_n
    root = gl.primitive_root_of_unity(log_n)
    if inverse:
        root = pow(root, gl.P - 2, gl.P)
    out = []
    for s in range(log_n):
        m = 1 << s
        w = pow(root, n // (2 * m), gl.P)
        tw = np.empty(m, dtype=np.uint64)
        acc = 1
        for j in range(m):
            tw[j] = acc
            acc = acc * w % gl.P
        out.append(tw)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _twiddle_table(log_n: int, inverse: bool) -> np.ndarray:
    """All stage twiddles packed as table[m + j] = w_{2m}^j (table[0]
    unused): the layout K1 reads."""
    tab = np.ones(1 << log_n, dtype=np.uint64)
    for s, tw in enumerate(_stage_twiddles(log_n, inverse)):
        tab[1 << s : 2 << s] = tw
    return tab


@functools.lru_cache(maxsize=None)
def _bit_reversal(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int64)


def _log2_exact(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n <= 0 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    return log_n


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward/inverse NTT along axis 0 of `values` ([n] or [n, cols]).

    Natural order in, natural order out; the inverse includes the 1/n
    scale. CUDA tensor: kernel K1. CPU tensor: the plain torch ladder."""
    if values.device.type == "cuda":
        return _ntt_cuda(values, inverse)
    if values.device.type != "cpu":
        raise ValueError(f"ntt: unsupported device {values.device}")
    return _ntt_plain(values, inverse)


def _ntt_plain(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    n, cols = values.shape
    log_n = _log2_exact(n)
    dev = values.device
    rev = xnp.device_table(("bitrev", log_n), dev, lambda: _bit_reversal(log_n).view(np.uint64))
    x = values[rev]
    for s, tw in enumerate(_stage_twiddles(log_n, inverse)):
        m = 1 << s
        xv = x.reshape(n // (2 * m), 2, m, cols)
        a, b = xv[:, 0], xv[:, 1]
        w = xnp.device_table(("tw", log_n, inverse, s), dev, lambda: tw).view(1, m, 1)
        bw = gl.mul(b, w)
        x = torch.stack([gl.add(a, bw), gl.sub(a, bw)], dim=1).reshape(n, cols)
    if inverse:
        x = gl.mul(x, pow(n, gl.P - 2, gl.P))
    return x[:, 0] if squeeze else x


def _ntt_cuda(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    global LAUNCHES
    from . import cuda_lib

    squeeze = values.ndim == 1
    x = values[:, None] if squeeze else values
    if x.stride(1) != 1:
        x = x.contiguous()
    cuda_lib.require_cuda_u64("ntt", x)
    n, c = x.shape
    log_n = _log2_exact(n)
    tw = xnp.device_table(("twtab", log_n, inverse), x.device, lambda: _twiddle_table(log_n, inverse))
    out = torch.empty((n, c), dtype=torch.int64, device=x.device)
    scale = pow(n, gl.P - 2, gl.P) if inverse else 1
    with torch.cuda.device(x.device):
        err = cuda_lib.lib().starky_ntt(
            x.data_ptr(), x.stride(0), out.data_ptr(), n, c, tw.data_ptr(),
            scale, int(inverse), cuda_lib.stream_of(x),
        )
    cuda_lib.check(err, "ntt")
    LAUNCHES += 1
    return out[:, 0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _shift_powers(shift: int, n: int) -> np.ndarray:
    powers = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        powers[i] = acc
        acc = acc * shift % gl.P
    return powers


def lde_from_coeffs(coeffs: torch.Tensor, rate_bits: int, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Evaluate coefficient-form polynomials on shift * H_{n * 2^rate_bits}.

    coeffs: [n, cols]; returns [n << rate_bits, cols]."""
    squeeze = coeffs.ndim == 1
    if squeeze:
        coeffs = coeffs[:, None]
    n, cols = coeffs.shape
    powers = xnp.device_table(("shift_pow", shift, n), coeffs.device, lambda: _shift_powers(shift, n))
    padded = torch.zeros((n << rate_bits, cols), dtype=torch.int64, device=coeffs.device)
    padded[:n] = gl.mul(coeffs, powers[:, None])
    out = ntt(padded, inverse=False)
    return out[:, 0] if squeeze else out


def interpolate_coset(values: torch.Tensor, shift: int) -> torch.Tensor:
    """Coefficients of the polynomial with the given evals on shift * H_n."""
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    n = values.shape[0]
    coeffs = ntt(values, inverse=True)
    s_inv = pow(shift, gl.P - 2, gl.P)
    powers = xnp.device_table(("shift_pow", s_inv, n), values.device, lambda: _shift_powers(s_inv, n))
    out = gl.mul(coeffs, powers[:, None])
    return out[:, 0] if squeeze else out


def interpolate_coeffs(values: torch.Tensor) -> torch.Tensor:
    """Monomial coefficients of the polynomial with the given subgroup evals."""
    return ntt(values, inverse=True)


def coset_lde(values: torch.Tensor, rate_bits: int, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Low-degree extension: interpolate columns over H_n, evaluate over
    shift * H_{n * 2^rate_bits}."""
    return lde_from_coeffs(interpolate_coeffs(values), rate_bits, shift)


def _ext_pow_host(a: tuple[int, int], e: int) -> tuple[int, int]:
    """(a0 + a1*X)^e in GF(p^2), exact host ints."""
    r0, r1 = 1, 0
    b0, b1 = a[0] % gl.P, a[1] % gl.P
    while e > 0:
        if e & 1:
            r0, r1 = (r0 * b0 + gl.W * r1 * b1) % gl.P, (r0 * b1 + r1 * b0) % gl.P
        e >>= 1
        if e:
            b0, b1 = (b0 * b0 + gl.W * b1 * b1) % gl.P, 2 * b0 * b1 % gl.P
    return r0, r1


@functools.lru_cache(maxsize=None)
def _coset_points(shift: int, big_n: int) -> np.ndarray:
    """shift * omega^i over the size-big_n domain, natural order."""
    w_big = gl.primitive_root_of_unity(big_n.bit_length() - 1)
    pts = np.empty(big_n, dtype=np.uint64)
    acc = shift % gl.P
    for i in range(big_n):
        pts[i] = acc
        acc = acc * w_big % gl.P
    return pts


# cells per column chunk of the opening matvecs: bounds the [N, chunk]
# temporaries of the 64-bit field multiply
OPEN_CHUNK_CELLS = 1 << 25


def eval_from_lde(
    lde: torch.Tensor,
    point: tuple[int, int],
    inv_den: torch.Tensor,
    shift: int = gl.GENERATOR,
) -> torch.Tensor:
    """Evaluate committed polynomials at an extension point FROM their LDE,
    in barycentric form over the coset D = shift * H_N:
        p(zeta) = (zeta^N - s^N) / (N * s^N) * sum_i v_i * x_i / (zeta - x_i)
    `inv_den` is 1/(x_i - zeta) [N, 2], the vector the batched-opening
    combine shares; the sum's -1 folds into the host factor.

    lde: [N, cols] base-field values on D. Returns [cols, 2]."""
    big_n = lde.shape[0]
    s_n = pow(shift, big_n, gl.P)
    p_n = _ext_pow_host(point, big_n)
    z_d = ((p_n[0] - s_n) % gl.P, p_n[1])
    denom_inv = pow(big_n % gl.P * s_n % gl.P, gl.P - 2, gl.P)
    factor = np.array(
        [(gl.P - z_d[0] * denom_inv % gl.P) % gl.P, (gl.P - z_d[1] * denom_inv % gl.P) % gl.P],
        dtype=np.uint64,
    )
    xs = xnp.device_table(("coset_pts", shift, big_n), lde.device, lambda: _coset_points(shift, big_n))
    w = gl.ext_scalar_mul(inv_den, xs)  # [N, 2]
    chunk = max(OPEN_CHUNK_CELLS // big_n, 8)
    parts = []
    for c0 in range(0, lde.shape[1], chunk):
        blk = lde[:, c0 : c0 + chunk]
        r0 = gl.sum_mod(gl.mul(blk, w[:, 0:1]), axis=0)
        r1 = gl.sum_mod(gl.mul(blk, w[:, 1:2]), axis=0)
        parts.append(torch.stack([r0, r1], dim=-1))
    s = torch.cat(parts, dim=0)
    return gl.ext_mul(s, xnp.as_tensor_like(factor, s))


def eval_poly_ext(coeffs, point_ext):
    """Evaluate polynomial(s) with base-field coeffs at an extension point
    by Horner: coeffs [n] or [n, cols], point_ext [2] -> [2] or [cols, 2]."""
    squeeze = coeffs.ndim == 1
    if squeeze:
        coeffs = coeffs[:, None]
    acc = gl.ext_from_base(xnp.zeros_like(coeffs[0]))
    for i in range(coeffs.shape[0] - 1, -1, -1):
        acc = gl.ext_add(gl.ext_mul(acc, xnp.broadcast_to(point_ext, acc.shape)),
                         gl.ext_from_base(coeffs[i]))
    return acc[0] if squeeze else acc
