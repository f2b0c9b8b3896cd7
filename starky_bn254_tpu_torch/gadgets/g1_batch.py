"""Vectorized G1 witness generation over instance batches (native-backed).

Same math as gadgets/g1.py but operating on [n, 16] limb arrays for all
instances of a trace row at once: numpy convolutions for the limb products
and the native batch modular-witness/inverse kernels for the bigint work.
G1ExpAir's trace generator runs the whole chain in one native call
(native.g1_exp_chain) and uses only the point <-> limb helpers here. No
path of this package runs `double_batch` / `add_batch` yet: they are the
per-row counterpart that the MSM and exp AIRs still to be ported build on,
and the tests hold them against the JAX package's and the exact-int gadgets.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import bn254, native
from ..utils.conversions import N_LIMBS, int_to_limbs

WIDE = 2 * N_LIMBS - 1


def conv16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise polynomial product along the last axis: [..,16] x [..,16]
    -> [.., 31] int64 (broadcasting over leading dims)."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    lead = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = np.zeros((*lead, WIDE), dtype=np.int64)
    for i in range(N_LIMBS):
        out[..., i : i + N_LIMBS] += a[..., i : i + 1] * b
    return out


def _wide(a: np.ndarray) -> np.ndarray:
    n = a.shape[0]
    out = np.zeros((n, WIDE), dtype=np.int64)
    out[:, : a.shape[1]] = a.astype(np.int64)
    return out


def _mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a*b mod p) limbs for [n,16] inputs."""
    return native.batch_modular_witness(conv16(a, b), zero_op=False)["outputs"]


def _lambda_pack(lam, w_zero, w_x, w_y) -> np.ndarray:
    """Assemble G1Output cell block [n, 320] (order: gadgets/g1.py _pack)."""
    return np.concatenate(
        [
            lam,
            w_x["outputs"],
            w_y["outputs"],
            w_zero["quot_abs"],
            w_zero["aux_lo"],
            w_zero["aux_hi"],
            w_x["out_aux_red"],
            w_x["quot_abs"],
            w_x["aux_lo"],
            w_x["aux_hi"],
            w_y["out_aux_red"],
            w_y["quot_abs"],
            w_y["aux_lo"],
            w_y["aux_hi"],
            w_zero["signs"][:, None],
            w_x["signs"][:, None],
            w_y["signs"][:, None],
        ],
        axis=1,
    )


def double_batch(x: np.ndarray, y: np.ndarray):
    """x, y: [n,16] uint64 limb arrays. Returns (cells [n,320], new_x, new_y)."""
    two_y = y.astype(np.int64) * 2
    # lambda = 3x^2 * inv(2y): reduce 2y first so the inverse input is <p
    two_y_red = native.batch_modular_witness(_wide(two_y), zero_op=False)["outputs"]
    inv_2y = native.batch_fq_inv(two_y_red.astype(np.uint16))
    x_sq3 = native.batch_modular_witness(conv16(x, x) * 3, zero_op=False)["outputs"]
    lam = _mulmod(x_sq3, inv_2y)

    zero_pol = conv16(lam, y) * 2 - conv16(x, x) * 3
    w_zero = native.batch_modular_witness(zero_pol, zero_op=True)
    new_x_input = conv16(lam, lam) - _wide(x.astype(np.int64) * 2)
    w_x = native.batch_modular_witness(new_x_input, zero_op=False)
    new_x = w_x["outputs"]
    new_y_input = conv16(lam, x.astype(np.int64) - new_x.astype(np.int64)) - _wide(y)
    w_y = native.batch_modular_witness(new_y_input, zero_op=False)
    return _lambda_pack(lam, w_zero, w_x, w_y), new_x, w_y["outputs"]


def add_batch(ax, ay, bx, by, mask: np.ndarray):
    """Masked batched addition a+b; rows where mask is False get zero cells
    and coordinates pass through unchanged. Returns (cells, new_bx, new_by)."""
    n = ax.shape[0]
    # substitute a harmless (G, 2G) pair on masked-off rows so every
    # intermediate is well-defined; their results are discarded below
    gx, gy = _dummy_pair()
    m = mask[:, None]
    orig_bx, orig_by = bx, by
    ax = np.where(m, ax, gx[0])
    ay = np.where(m, ay, gx[1])
    bx = np.where(m, bx, gy[0])
    by = np.where(m, by, gy[1])

    dx = bx.astype(np.int64) - ax.astype(np.int64)
    dy = by.astype(np.int64) - ay.astype(np.int64)
    dx_red = native.batch_modular_witness(_wide(dx), zero_op=False)["outputs"]
    if (dx_red == 0).all(axis=1).any():
        raise ValueError("g1 add with equal x-coordinates")
    inv_dx = native.batch_fq_inv(dx_red.astype(np.uint16))
    dy_red = native.batch_modular_witness(_wide(dy), zero_op=False)["outputs"]
    lam = _mulmod(dy_red, inv_dx)

    zero_pol = conv16(lam, dx) - _wide(dy)
    w_zero = native.batch_modular_witness(zero_pol, zero_op=True)
    new_x_input = conv16(lam, lam) - _wide(ax.astype(np.int64) + bx.astype(np.int64))
    w_x = native.batch_modular_witness(new_x_input, zero_op=False)
    new_x = w_x["outputs"]
    new_y_input = conv16(lam, ax.astype(np.int64) - new_x.astype(np.int64)) - _wide(ay)
    w_y = native.batch_modular_witness(new_y_input, zero_op=False)

    cells = _lambda_pack(lam, w_zero, w_x, w_y)
    cells = np.where(m, cells, zero_cells_g1(n))
    new_bx = np.where(m, new_x, orig_bx)
    new_by = np.where(m, w_y["outputs"], orig_by)
    return cells, new_bx, new_by


@functools.lru_cache(maxsize=1)
def _dummy_pair():
    g = bn254.G1_GEN
    g2 = bn254.g1_double(g)
    return (
        (np.array(int_to_limbs(g[0]), dtype=np.uint64), np.array(int_to_limbs(g[1]), dtype=np.uint64)),
        (np.array(int_to_limbs(g2[0]), dtype=np.uint64), np.array(int_to_limbs(g2[1]), dtype=np.uint64)),
    )


@functools.lru_cache(maxsize=1)
def _zero_cells() -> np.ndarray:
    from .g1 import zero_g1_output

    return np.array(zero_g1_output()["cells"], dtype=np.uint64)


def zero_cells_g1(n: int) -> np.ndarray:
    cells = _zero_cells()
    return np.broadcast_to(cells, (n, cells.shape[0]))


def points_to_limbs(points) -> tuple[np.ndarray, np.ndarray]:
    xs = np.array([int_to_limbs(p[0]) for p in points], dtype=np.uint64)
    ys = np.array([int_to_limbs(p[1]) for p in points], dtype=np.uint64)
    return xs, ys


def limbs_to_point(xl, yl) -> tuple[int, int]:
    x = sum(int(v) << (16 * i) for i, v in enumerate(xl))
    y = sum(int(v) << (16 * i) for i, v in enumerate(yl))
    return (x, y)
