# Frozen copy of starky_bn254_tpu_torch/gadgets/limbs.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Limb-polynomial algebra on constraint values (lane-stacked Vals).

Constraint-side counterpart of reference src/modular/pol_utils.rs — a U256 is
a degree-15 polynomial in beta = 2^16 with Goldilocks coefficients
(reference src/constants.rs:1-2). Unlike the reference's per-coefficient
Rust loops mirrored into circuit code, these operate on the lane axis of
`Val`s, so one call covers all 16/31 limb constraints in a handful of
tensor ops, and the same code serves prover (row-vectorized) and verifier
(extension scalars).
"""

from __future__ import annotations

from .. import xnp
import numpy as np

from .. import goldilocks as gl
from ..stark.field_expr import Val
from ..utils.conversions import LIMB_BITS

BETA = 1 << LIMB_BITS


def lane_axis(v: Val) -> int:
    return -2 if v.ext else -1


def num_lanes(v: Val) -> int:
    return v.arr.shape[lane_axis(v)]


def lane_get(v: Val, i: int) -> Val:
    """Extract lane i as a single-column Val."""
    if v.ext:
        return Val(v.arr[..., i, :], True)
    return Val(v.arr[..., i], False)


def lane_pad(v: Val, total: int, offset: int = 0) -> Val:
    """Zero-pad the lane axis to `total`, placing existing lanes at `offset`."""
    k = num_lanes(v)
    assert offset + k <= total
    axis = lane_axis(v)
    pads = [(0, 0)] * v.arr.ndim
    idx = axis % v.arr.ndim
    pads[idx] = (offset, total - offset - k)
    return Val(xnp.pad(v.arr, pads), v.ext)


def const_lanes(ints, ext: bool) -> Val:
    """Lift a list of Python ints to a lane-constant Val."""
    arr = np.array([int(x) % gl.P for x in ints], dtype=np.uint64)
    if ext:
        a = xnp.asarray(arr)
        return Val(xnp.stack([a, xnp.zeros_like(a)], axis=-1), True)
    return Val(xnp.asarray(arr), False)


def u16_to_u32_lanes(v: Val) -> Val:
    """[.., 16] u16 lanes -> [.., 8] u32 lanes: even + 2^16 * odd (the JAX
    package keeps it in airs/fq_exp.py)."""
    if v.ext:
        even = Val(v.arr[..., 0::2, :], True)
        odd = Val(v.arr[..., 1::2, :], True)
    else:
        even = Val(v.arr[..., 0::2], False)
        odd = Val(v.arr[..., 1::2], False)
    return even + odd * (1 << 16)


def pol_mul_wide(a: Val, b: Val, out_len: int | None = None) -> Val:
    """Schoolbook polynomial product along the lane axis.

    a: [.., ka], b: [.., kb] -> [.., ka+kb-1] (reference pol_utils.rs:221-232
    for the 16x16 case, :274-285 for the 17x16 `pol_mul_wide2` case).

    One broadcasted modular outer product + a shifted lane-sum, so the op
    count stays small however many limb lanes are involved.
    """
    ka, kb = num_lanes(a), num_lanes(b)
    total = out_len if out_len is not None else ka + kb - 1
    if a.ext:
        # [.., ka, 1, 2] * [.., 1, kb, 2] -> [.., ka, kb, 2]
        prod = gl.ext_mul(a.arr[..., :, None, :], b.arr[..., None, :, :])
        rows = []
        for i in range(ka):
            pads = [(0, 0)] * (prod.ndim - 1)
            pads[-2] = (i, total - kb - i)
            rows.append(xnp.pad(prod[..., i, :, :], pads))
        stacked = xnp.stack(rows, axis=-3)  # [.., ka, total, 2]
        return Val(gl.sum_mod(stacked, axis=-3), True)
    prod = gl.mul(a.arr[..., :, None], b.arr[..., None, :])  # [.., ka, kb]
    rows = []
    for i in range(ka):
        pads = [(0, 0)] * (prod.ndim - 1)
        pads[-1] = (i, total - kb - i)
        rows.append(xnp.pad(prod[..., i, :], pads))
    stacked = xnp.stack(rows, axis=-2)  # [.., ka, total]
    return Val(gl.sum_mod(stacked, axis=-2), False)


def pol_adjoin_root(a: Val, root: int) -> Val:
    """(x - root) * a(x), keeping the SAME lane count as `a` (the caller
    guarantees a's top lane is zero — reference pol_utils.rs:348-363)."""
    shifted = a.roll_lanes(1)  # a_{i-1}
    return shifted - a * root
