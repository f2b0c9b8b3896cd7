"""Number-theoretic transform and low-degree extension over Goldilocks.

`ntt` is the wrapper of kernel K1 (csrc/ntt.cu): on a CUDA tensor every
call, 1-D input included, launches the hand-written kernel once per pass of
`_pass_plan` (two passes up to n = 2^(2t)); on a CPU tensor it runs
`_ntt_plain`, the radix-2 DIT ladder written in torch ops (bit-reversal
gather, then log2(n) butterfly stages). Both give exactly the JAX package's
ntt._ntt_xla output: the kernel runs the same butterflies on the same
twiddles, only grouped into shared-memory tiles, and all arithmetic is
exact mod p.

All transforms are batched over a trailing column axis: the trace is
`[rows, cols]` and one call transforms every column. Coset LDE evaluates on
`shift * <w_{n*blowup}>`, so Z_H(x) = x^n - 1 is nonzero on the domain.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import goldilocks as gl
from . import xnp

LAUNCHES = 0  # K1 kernel launches (one per pass of each ntt call on a CUDA tensor)

# K1's shared-memory tile, in u64 words (64 KB: three blocks fit on an SM),
# and its widest column slab (16 words: a 128-byte row segment)
TILE_WORDS = 1 << 13
MAX_LOG_W = 4


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


@dataclass(frozen=True)
class NttPass:
    """One launch of K1: DIT stages [s_lo, s_hi) of a size-2^log_n NTT.

    Those stages only pair rows that agree in their low s_lo bits and in
    their bits from s_hi up, so the rows
        i = hi * 2^s_hi + mid * 2^s_lo + lo,   mid in [0, 2^(s_hi - s_lo))
    form an independent sub-transform for each (hi, lo). A block loads one
    tile: G = 2^(s_hi - s_lo) rows `mid` x R = 2^log_r consecutive `lo`
    x W = 2^log_w consecutive columns, runs the stages in shared memory
    and writes the tile back. The first pass also gathers its rows from the
    bit-reversed source rows (and applies the inverse's 1/n scale)."""

    s_lo: int
    s_hi: int
    log_r: int
    log_w: int

    @property
    def log_tile_rows(self) -> int:  # log2(G * R)
        return self.s_hi - self.s_lo + self.log_r

    def n_groups(self, log_n: int) -> int:
        """Tiles along the rows (each spans every column slab)."""
        return 1 << (log_n - self.log_tile_rows)

    def tile_rows(self, g: np.ndarray) -> np.ndarray:
        """Row indices [len(g), G, R] of the tiles `g` (the kernel's
        blockIdx / n_slabs): hi = g >> (s_lo - log_r), and the tile's
        first lo = (g mod 2^(s_lo - log_r)) * R."""
        g = np.asarray(g, dtype=np.int64)[:, None, None]
        lo_bits = self.s_lo - self.log_r
        hi = g >> lo_bits
        lo_base = (g & ((1 << lo_bits) - 1)) << self.log_r
        mid = np.arange(1 << (self.s_hi - self.s_lo), dtype=np.int64)[None, :, None]
        r = np.arange(1 << self.log_r, dtype=np.int64)[None, None, :]
        return (hi << self.s_hi) + (mid << self.s_lo) + lo_base + r

    def twiddle_index(self, s: int, jm: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """Index into `_pass_twiddles` of the twiddle w_{2^(s+1)}^j of
        global stage s (s_lo <= s < s_hi), j = jm * 2^s_lo + lo, where jm is
        the butterfly's position in its half-block of 2^(s - s_lo) rows."""
        m = 1 << (s - self.s_lo)
        return ((m - 1 + np.asarray(jm)) << self.s_lo) + np.asarray(lo)


def _pass_plan(log_n: int, c: int, t: int | None = None) -> tuple[NttPass, ...]:
    """K1's passes for an [2^log_n, c] transform: at most t stages each, so
    two passes cover n <= 2^(2t). By default as few passes as TILE_WORDS
    tiles allow, with the stages spread evenly over them: the tiles are then
    no larger than they must be, and a narrow matrix still gets enough
    blocks to fill the card. Every tile holds at most 2^t rows x W columns;
    a pass with fewer than t stages widens its tile with R residues, up to
    2^s_lo."""
    log_w = min(max(c - 1, 0).bit_length(), MAX_LOG_W)
    if t is None:
        t_max = TILE_WORDS.bit_length() - 1 - log_w
        n_passes = max(1, -(-log_n // t_max))
        t = max(1, -(-log_n // n_passes))
    if t < 1:
        raise ValueError(f"ntt: a pass needs at least one stage, got t={t}")
    passes = []
    s = 0
    while True:
        s_hi = min(s + t, log_n)
        passes.append(NttPass(s, s_hi, min(s, t - (s_hi - s)), log_w))
        s = s_hi
        if s >= log_n:
            return tuple(passes)


@functools.lru_cache(maxsize=None)
def _pass_twiddles(log_n: int, inverse: bool, s_lo: int, s_hi: int) -> np.ndarray:
    """The twiddles of stages [s_lo, s_hi), laid out as NttPass.twiddle_index
    reads them: entry ((m - 1 + jm) << s_lo) + lo is w_{2^(s+1)}^j with
    m = 2^(s - s_lo), j = jm * 2^s_lo + lo. That is the packed table's
    slice [2^s_lo, 2^s_hi), so lo, which runs along a tile's R residues, is
    the contiguous index."""
    return np.ascontiguousarray(_twiddle_table(log_n, inverse)[1 << s_lo : 1 << s_hi])


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


def _ntt_cuda(values: torch.Tensor, inverse: bool = False, t: int | None = None) -> torch.Tensor:
    """K1: one launch per pass of `_pass_plan(log_n, c, t)`. The first pass
    reads `values` in place (any row stride, bit-reversed rows) into the
    output; later passes work on the output in place."""
    global LAUNCHES
    from . import cuda_lib

    squeeze = values.ndim == 1
    x = values[:, None] if squeeze else values
    if x.stride(1) != 1:
        x = x.contiguous()
    cuda_lib.require_cuda_u64("ntt", x)
    n, c = x.shape
    log_n = _log2_exact(n)
    out = torch.empty((n, c), dtype=torch.int64, device=x.device)
    if c == 0:
        return out[:, 0] if squeeze else out
    scale = pow(n, gl.P - 2, gl.P) if inverse else 1
    lib = cuda_lib.lib()
    with torch.cuda.device(x.device):
        stream = cuda_lib.stream_of(x)
        for k, p in enumerate(_pass_plan(log_n, c, t)):
            tw = xnp.device_table(("ntt_pass_tw", log_n, inverse, p.s_lo, p.s_hi), x.device,
                                  lambda: _pass_twiddles(log_n, inverse, p.s_lo, p.s_hi))
            src, src_stride = (x, x.stride(0)) if k == 0 else (out, c)
            err = lib.starky_ntt_pass(
                src.data_ptr(), src_stride, out.data_ptr(), n, c, log_n, p.s_lo, p.s_hi,
                p.log_r, p.log_w, tw.data_ptr(), scale, int(k == 0), int(k == 0 and inverse),
                stream,
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
