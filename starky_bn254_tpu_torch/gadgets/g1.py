"""G1 add/double gadget: witness generation + constraint evaluation.

Re-derivation of reference src/curves/g1/muladd.rs: the slope lambda is
witnessed (computed natively via field division on the host, muladd.rs:136,
415) and three modular statements bind it:

  add (P=(ax,ay), Q=(bx,by), P != +-Q):
    lambda*(bx - ax) - (by - ay)  === 0         (modular-zero)
    new_x === lambda^2 - (ax + bx)              (modular op)
    new_y === lambda*(ax - new_x) - ay          (modular op)
  double (P=(x,y)):
    2*lambda*y - 3*x^2            === 0
    new_x === lambda^2 - 2x
    new_y === lambda*(x - new_x) - y

Output block layout (20*N_LIMBS cells, muladd.rs:79-94):
  lambda(16) new_x(16) new_y(16) aux_zero(79) aux_x(95) aux_y(95)
  quot_sign_zero quot_sign_x quot_sign_y

The witness functions here are the exact-int reference, one point at a
time; the trace generator runs the native chain (native.g1_exp_chain).
"""

from __future__ import annotations

import numpy as np

from .. import bn254
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val
from ..utils.conversions import N_LIMBS, int_to_limbs
from . import modular as mod
from .limbs import lane_pad, pol_mul_wide

G1_OUTPUT_COLS = 20 * N_LIMBS  # 320

P = bn254.P_BN


def _pol_mul_limbs(a: list[int], b: list[int]) -> list[int]:
    if max(map(abs, a)) * max(map(abs, b)) * min(len(a), len(b)) < 1 << 63:
        # every coefficient fits an int64: one numpy convolution, exact
        return np.convolve(np.asarray(a, np.int64), np.asarray(b, np.int64)).tolist()
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out


def _sub(a: list[int], b: list[int]) -> list[int]:
    n = min(len(a), len(b))
    return [x - y for x, y in zip(a, b)] + list(a[n:]) + [-y for y in b[n:]]


def _add(a: list[int], b: list[int]) -> list[int]:
    n = min(len(a), len(b))
    return [x + y for x, y in zip(a, b)] + list(a[n:]) + list(b[n:])


def _wide(a: list[int]) -> list[int]:
    return list(a) + [0] * (2 * N_LIMBS - 1 - len(a))


def generate_g1_add(ax: int, ay: int, bx: int, by: int) -> dict:
    lam = (by - ay) * bn254.fq_inv(bx - ax) % P
    axl, ayl = int_to_limbs(ax), int_to_limbs(ay)
    bxl, byl = int_to_limbs(bx), int_to_limbs(by)
    laml = int_to_limbs(lam)

    zero_pol = _wide(_sub(_pol_mul_limbs(laml, _sub(bxl, axl)), _sub(byl, ayl)))
    w_zero = mod.generate_modular_zero(P, zero_pol)

    new_x_input = _wide(_sub(_pol_mul_limbs(laml, laml), _add(axl, bxl)))
    w_x = mod.generate_modular_op(P, new_x_input)
    new_x = w_x["output_int"]

    new_y_input = _wide(
        _sub(_pol_mul_limbs(laml, _sub(axl, int_to_limbs(new_x))), ayl)
    )
    w_y = mod.generate_modular_op(P, new_y_input)
    return _pack(laml, w_zero, w_x, w_y)


def generate_g1_double(x: int, y: int) -> dict:
    lam = 3 * x * x * bn254.fq_inv(2 * y) % P
    xl, yl = int_to_limbs(x), int_to_limbs(y)
    laml = int_to_limbs(lam)

    lam_y2 = [2 * c for c in _pol_mul_limbs(laml, yl)]
    x_sq3 = [3 * c for c in _pol_mul_limbs(xl, xl)]
    w_zero = mod.generate_modular_zero(P, _wide(_sub(lam_y2, x_sq3)))

    new_x_input = _wide(_sub(_pol_mul_limbs(laml, laml), _add(xl, xl)))
    w_x = mod.generate_modular_op(P, new_x_input)
    new_x = w_x["output_int"]

    new_y_input = _wide(_sub(_pol_mul_limbs(laml, _sub(xl, int_to_limbs(new_x))), yl))
    w_y = mod.generate_modular_op(P, new_y_input)
    return _pack(laml, w_zero, w_x, w_y)


def zero_g1_output() -> dict:
    z = mod.zero_modular_aux()
    return {
        "cells": [0] * (3 * N_LIMBS)
        + [0] * (N_LIMBS + 1)
        + [0] * (2 * N_LIMBS - 1) * 2
        + z["out_aux_red"]
        + z["quot_abs"]
        + z["aux_lo"]
        + z["aux_hi"]
        + z["out_aux_red"]
        + z["quot_abs"]
        + z["aux_lo"]
        + z["aux_hi"]
        + [1, 1, 1],
        "new_x_int": 0,
        "new_y_int": 0,
    }


def _pack(laml, w_zero, w_x, w_y) -> dict:
    cells = (
        list(laml)
        + w_x["output"]
        + w_y["output"]
        + w_zero["quot_abs"]
        + w_zero["aux_lo"]
        + w_zero["aux_hi"]
        + w_x["out_aux_red"]
        + w_x["quot_abs"]
        + w_x["aux_lo"]
        + w_x["aux_hi"]
        + w_y["out_aux_red"]
        + w_y["quot_abs"]
        + w_y["aux_lo"]
        + w_y["aux_hi"]
        + [w_zero["quot_sign"], w_x["quot_sign"], w_y["quot_sign"]]
    )
    assert len(cells) == G1_OUTPUT_COLS
    return {
        "cells": cells,
        "new_x_int": w_x["output_int"],
        "new_y_int": w_y["output_int"],
    }


class G1OutputView:
    """Column accessors for a G1Output block starting at `base` in a row view."""

    def __init__(self, lv, base: int):
        c = base
        self.lam = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        self.new_x = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        self.new_y = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        self.z_quot_abs = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
        self.z_lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.z_hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.x_aux_red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        self.x_quot_abs = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
        self.x_lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.x_hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.y_aux_red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        self.y_quot_abs = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
        self.y_lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.y_hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        self.sign_z = lv.col(c); c += 1
        self.sign_x = lv.col(c); c += 1
        self.sign_y = lv.col(c); c += 1
        assert c == base + G1_OUTPUT_COLS
        self.end = c


def _eval_three(cc, filter_v, o: G1OutputView, zero_pol, new_x_input_fn, new_y_input_fn):
    mod.eval_modular_zero(
        cc, filter_v, P, zero_pol, o.sign_z, o.z_quot_abs, o.z_lo, o.z_hi
    )
    mod.eval_modular_op(
        cc, filter_v, P, new_x_input_fn(), o.new_x, o.sign_x,
        o.x_aux_red, o.x_quot_abs, o.x_lo, o.x_hi,
    )
    mod.eval_modular_op(
        cc, filter_v, P, new_y_input_fn(), o.new_y, o.sign_y,
        o.y_aux_red, o.y_quot_abs, o.y_lo, o.y_hi,
    )


def eval_g1_add(
    cc: ConstraintConsumer,
    filter_v: Val,
    a_x: Val,
    a_y: Val,
    b_x: Val,
    b_y: Val,
    o: G1OutputView,
):
    zero_pol = pol_mul_wide(o.lam, b_x - a_x) - lane_pad(b_y - a_y, 2 * N_LIMBS - 1)
    _eval_three(
        cc,
        filter_v,
        o,
        zero_pol,
        lambda: pol_mul_wide(o.lam, o.lam) - lane_pad(a_x + b_x, 2 * N_LIMBS - 1),
        lambda: pol_mul_wide(o.lam, a_x - o.new_x) - lane_pad(a_y, 2 * N_LIMBS - 1),
    )


def eval_g1_double(
    cc: ConstraintConsumer,
    filter_v: Val,
    x: Val,
    y: Val,
    o: G1OutputView,
):
    zero_pol = pol_mul_wide(o.lam, y) * 2 - pol_mul_wide(x, x) * 3
    _eval_three(
        cc,
        filter_v,
        o,
        zero_pol,
        lambda: pol_mul_wide(o.lam, o.lam) - lane_pad(x + x, 2 * N_LIMBS - 1),
        lambda: pol_mul_wide(o.lam, x - o.new_x) - lane_pad(y, 2 * N_LIMBS - 1),
    )
