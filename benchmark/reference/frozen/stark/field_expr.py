# Frozen copy of starky_bn254_tpu_torch/stark/field_expr.py at commit fb7d4c0.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Polymorphic constraint-expression values.

The reference evaluates every constraint twice through parallel code paths:
`eval_packed_generic` over packed base-field rows and `eval_ext_circuit` as
plonky2 gates (e.g. reference src/modular/modular.rs:215-257). Here ONE
constraint implementation runs in both prover and verifier:

* prover mode (`ext=False`): values are base-field int64 tensors over LDE
  rows, shaped [N] (a single column) or [N, k] (a stack of k limb-lanes — the
  limb axis is an array axis, not a Python loop, so one tensor op covers
  every lane);
* verifier mode (`ext=True`): values are GF(p^2) scalars shaped [2] or [k, 2]
  (openings at zeta).

`Val` overloads arithmetic and dispatches to the right Goldilocks ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import xnp

from .. import goldilocks as gl


def _lift_const(c: int, ext: bool):
    c = int(c) % gl.P
    if ext:
        return xnp.asarray(np.array([c, 0], dtype=np.uint64))
    return xnp.asarray(np.uint64(c))


class Val:
    """A constraint-expression value (base-field lanes or extension scalars)."""

    __slots__ = ("arr", "ext")

    def __init__(self, arr, ext: bool):
        self.arr = arr
        self.ext = ext

    # -- helpers ------------------------------------------------------------
    def _coerce(self, other) -> "Val":
        if isinstance(other, Val):
            assert other.ext == self.ext
            return other
        if isinstance(other, (int, np.integer)):
            return Val(_lift_const(int(other), self.ext), self.ext)
        raise TypeError(f"cannot mix Val with {type(other)}")

    def lane(self) -> "Val":
        """Insert a broadcast lane axis so a single column can combine with a
        [.., k]-lane stack (prover: [N] -> [N, 1]; verifier: [2] -> [1, 2])."""
        if self.ext:
            return Val(self.arr[None, :], True)
        return Val(self.arr[..., None], False)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        o = self._coerce(other)
        f = gl.ext_add if self.ext else gl.add
        return Val(f(self.arr, o.arr), self.ext)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        f = gl.ext_sub if self.ext else gl.sub
        return Val(f(self.arr, o.arr), self.ext)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        o = self._coerce(other)
        f = gl.ext_mul if self.ext else gl.mul
        return Val(f(self.arr, o.arr), self.ext)

    __rmul__ = __mul__

    def __neg__(self):
        f = gl.ext_neg if self.ext else gl.neg
        return Val(f(self.arr), self.ext)

    def roll_lanes(self, shift: int) -> "Val":
        """Shift along the lane axis, filling with zeros (for pol algebra)."""
        axis = -2 if self.ext else -1
        rolled = xnp.roll(self.arr, shift, axis=axis)
        k = self.arr.shape[axis]
        idx = xnp.arange(k)
        if shift >= 0:
            mask = idx >= shift
        else:
            mask = idx < k + shift
        if self.ext:
            mask = mask[:, None]
        rolled = xnp.where(mask, rolled, xnp.zeros_like(rolled))
        return Val(rolled, self.ext)

    @property
    def num_lanes(self) -> int:
        axis = -2 if self.ext else -1
        if self.ext:
            return 1 if self.arr.ndim == 1 else self.arr.shape[axis]
        return 1 if self.arr.ndim <= 1 else self.arr.shape[axis]


def stack_vals(vals: list[Val]) -> Val:
    """Stack single-column Vals into one lane-stacked Val."""
    ext = vals[0].ext
    axis = -2 if ext else -1
    return Val(xnp.stack([v.arr for v in vals], axis=axis), ext)


def lane_concat(vals: list[Val]) -> Val:
    """Concatenate lane-stacked Vals along the lane axis."""
    ext = vals[0].ext
    axis = -2 if ext else -1
    return Val(xnp.concatenate([v.arr for v in vals], axis=axis), ext)


class RowView:
    """Column accessor over either an LDE row-block (prover) or a vector of
    opened values at a point (verifier).

    prover: data [N, C] base field, ext=False. col(i) -> Val [N].
    verifier: data [C, 2] extension, ext=True. col(i) -> Val [2].

    `start`/`length` (prover only) window the rows: col(i) ->
    data[start:start+length, i]. The block composition uses this — `lv`
    reads rows [0, B) and `nv` rows [blowup, B+blowup) of a block extended
    by `blowup` halo rows.
    """

    def __init__(self, data, ext: bool, start: int | None = None,
                 length: int | None = None):
        self.data = data
        self.ext = ext
        self.start = start
        self.length = length

    def _rolled(self, arr):
        if self.start is not None:
            return arr[self.start : self.start + self.length]
        return arr

    def col(self, i: int) -> Val:
        if self.ext:
            return Val(self.data[i], True)
        return Val(self._rolled(self.data[:, i]), False)

    def cols(self, start: int, stop: int) -> Val:
        """Lane-stacked slice of columns [start, stop)."""
        if self.ext:
            return Val(self.data[start:stop], True)
        return Val(self._rolled(self.data[:, start:stop]), False)

    def cols_idx(self, indices) -> Val:
        idx = np.asarray(indices, dtype=np.int64)
        if isinstance(self.data, torch.Tensor):
            idx = torch.from_numpy(idx).to(self.data.device)
        if self.ext:
            return Val(self.data[idx], True)
        return Val(self._rolled(self.data[:, idx]), False)


class PublicInputsView:
    """Public inputs as constraint values (base field lifted appropriately)."""

    def __init__(self, values, ext: bool):
        # values: [P] u64 array
        self.values = values
        self.ext = ext

    def col(self, i: int) -> Val:
        v = self.values[i]
        if self.ext:
            return Val(xnp.stack([v, xnp.zeros_like(v)], axis=-1), True)
        return Val(v, False)

    def cols(self, start: int, stop: int) -> Val:
        v = self.values[start:stop]
        if self.ext:
            return Val(xnp.stack([v, xnp.zeros_like(v)], axis=-1), True)
        return Val(v, False)
