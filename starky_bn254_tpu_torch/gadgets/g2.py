"""G2 add/double gadget over Fq2 coordinates.

Fq2 lift of the G1 gadget (reference src/curves/g2/muladd.rs): each Fq2
constraint splits into two modular statements (real/imaginary). Output block
(40*N_LIMBS cells, muladd.rs:57-81):
  lambda(2x16) new_x(2x16) new_y(2x16)
  aux_zero[0] aux_zero[1] (79 each)
  aux_x0 aux_x1 aux_y0 aux_y1 (95 each)
  sign_zero[0] sign_zero[1] sign_x0 sign_x1 sign_y0 sign_y1

The witness functions here are the exact-int reference, one point at a
time; the trace generator runs the native chain (native.g2_exp_chain).
"""

from __future__ import annotations

from .. import bn254
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val
from ..utils.conversions import N_LIMBS, int_to_limbs
from . import modular as mod
from .fq2 import pol_add_fq2, pol_mul_fq2, pol_mul_scalar_fq2, pol_sub_fq2, to_wide_fq2
from .g1 import _add, _pol_mul_limbs, _sub, _wide

G2_OUTPUT_COLS = 40 * N_LIMBS  # 640
P = bn254.P_BN


def _fq2_limbs(v) -> tuple[list[int], list[int]]:
    return int_to_limbs(v[0]), int_to_limbs(v[1])


def _mul_fq2_limbs(x, y):
    """x, y: pairs of limb lists; u^2 = -1 fold. Returns pair of wide lists."""
    z0 = _sub(_pol_mul_limbs(x[0], y[0]), _pol_mul_limbs(x[1], y[1]))
    z1 = _add(_pol_mul_limbs(x[0], y[1]), _pol_mul_limbs(x[1], y[0]))
    return (z0, z1)


def generate_g2_add(a_pt, b_pt) -> dict:
    """a_pt, b_pt: ((x0,x1),(y0,y1)) Fq2-coordinate points as int pairs."""
    ax, ay = a_pt
    bx, by = b_pt
    lam = bn254.fq2_mul(bn254.fq2_sub(by, ay), bn254.fq2_inv(bn254.fq2_sub(bx, ax)))
    axl, ayl = _fq2_limbs(ax), _fq2_limbs(ay)
    bxl, byl = _fq2_limbs(bx), _fq2_limbs(by)
    laml = _fq2_limbs(lam)

    delta_x = (_sub(bxl[0], axl[0]), _sub(bxl[1], axl[1]))
    delta_y = (_sub(byl[0], ayl[0]), _sub(byl[1], ayl[1]))
    lam_dx = _mul_fq2_limbs(laml, delta_x)
    zero_pol = (_sub(lam_dx[0], delta_y[0]), _sub(lam_dx[1], delta_y[1]))

    lam_sq = _mul_fq2_limbs(laml, laml)
    x_sum = (_add(axl[0], bxl[0]), _add(axl[1], bxl[1]))
    new_x_input = (_sub(lam_sq[0], x_sum[0]), _sub(lam_sq[1], x_sum[1]))
    return _finish(laml, axl, ayl, zero_pol, new_x_input)


def generate_g2_double(pt) -> dict:
    x, y = pt
    num = bn254.fq2_scalar(bn254.fq2_mul(x, x), 3)
    lam = bn254.fq2_mul(num, bn254.fq2_inv(bn254.fq2_scalar(y, 2)))
    xl, yl = _fq2_limbs(x), _fq2_limbs(y)
    laml = _fq2_limbs(lam)

    lam_y = _mul_fq2_limbs(laml, yl)
    x_sq = _mul_fq2_limbs(xl, xl)
    zero_pol = (
        _sub([2 * c for c in lam_y[0]], [3 * c for c in x_sq[0]]),
        _sub([2 * c for c in lam_y[1]], [3 * c for c in x_sq[1]]),
    )
    lam_sq = _mul_fq2_limbs(laml, laml)
    x_dbl = ([2 * c for c in xl[0]], [2 * c for c in xl[1]])
    new_x_input = (_sub(lam_sq[0], x_dbl[0]), _sub(lam_sq[1], x_dbl[1]))
    return _finish(laml, xl, yl, zero_pol, new_x_input)


def _finish(laml, xl, yl, zero_pol, new_x_input) -> dict:
    """Common tail: modular ops for zero/new_x/new_y and cell packing."""
    w_zero = [mod.generate_modular_zero(P, _wide(zero_pol[i])) for i in range(2)]
    w_x = [mod.generate_modular_op(P, _wide(new_x_input[i])) for i in range(2)]
    new_x = (w_x[0]["output_int"], w_x[1]["output_int"])
    nxl = _fq2_limbs(new_x)

    x_m_nx = (_sub(xl[0], nxl[0]), _sub(xl[1], nxl[1]))
    lam_xmnx = _mul_fq2_limbs(laml, x_m_nx)
    new_y_input = (_sub(lam_xmnx[0], yl[0]), _sub(lam_xmnx[1], yl[1]))
    w_y = [mod.generate_modular_op(P, _wide(new_y_input[i])) for i in range(2)]
    new_y = (w_y[0]["output_int"], w_y[1]["output_int"])

    cells = list(laml[0]) + list(laml[1])
    cells += w_x[0]["output"] + w_x[1]["output"]
    cells += w_y[0]["output"] + w_y[1]["output"]
    for wz in w_zero:
        cells += wz["quot_abs"] + wz["aux_lo"] + wz["aux_hi"]
    for w in w_x + w_y:
        cells += w["out_aux_red"] + w["quot_abs"] + w["aux_lo"] + w["aux_hi"]
    cells += [w_zero[0]["quot_sign"], w_zero[1]["quot_sign"]]
    cells += [w["quot_sign"] for w in w_x + w_y]
    assert len(cells) == G2_OUTPUT_COLS
    return {"cells": cells, "new_x": new_x, "new_y": new_y}


def zero_g2_output() -> dict:
    z = mod.zero_modular_aux()
    cells = [0] * (6 * N_LIMBS)
    for _ in range(2):
        cells += z["quot_abs"] + z["aux_lo"] + z["aux_hi"]
    for _ in range(4):
        cells += z["out_aux_red"] + z["quot_abs"] + z["aux_lo"] + z["aux_hi"]
    cells += [1] * 6
    assert len(cells) == G2_OUTPUT_COLS
    return {"cells": cells, "new_x": (0, 0), "new_y": (0, 0)}


class G2OutputView:
    """Column accessors for a G2Output block starting at `base` in a row view."""

    def __init__(self, lv, base: int):
        c = base

        def fq2():
            nonlocal c
            out = (lv.cols(c, c + N_LIMBS), lv.cols(c + N_LIMBS, c + 2 * N_LIMBS))
            c += 2 * N_LIMBS
            return out

        self.lam = fq2()
        self.new_x = fq2()
        self.new_y = fq2()
        self.aux_zero = []
        for _ in range(2):
            qa = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
            lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            self.aux_zero.append((qa, lo, hi))
        self.aux = []
        for _ in range(4):
            red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
            qa = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
            lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            self.aux.append((red, qa, lo, hi))
        self.sign_zero = [lv.col(c), lv.col(c + 1)]; c += 2
        self.signs = [lv.col(c + i) for i in range(4)]; c += 4
        assert c == base + G2_OUTPUT_COLS
        self.end = c


def _eval_common(cc, filter_v, o: G2OutputView, zero_pol, new_x_input):
    for i in range(2):
        qa, lo, hi = o.aux_zero[i]
        mod.eval_modular_zero(cc, filter_v, P, zero_pol[i], o.sign_zero[i], qa, lo, hi)
    for i in range(2):
        red, qa, lo, hi = o.aux[i]
        mod.eval_modular_op(
            cc, filter_v, P, new_x_input[i], o.new_x[i], o.signs[i], red, qa, lo, hi
        )


def _eval_new_y(cc, filter_v, o: G2OutputView, x, y):
    x_m_nx = pol_sub_fq2(x, o.new_x)
    lam_xmnx = pol_mul_fq2(o.lam, x_m_nx)
    new_y_input = pol_sub_fq2(lam_xmnx, to_wide_fq2(y))
    for i in range(2):
        red, qa, lo, hi = o.aux[2 + i]
        mod.eval_modular_op(
            cc, filter_v, P, new_y_input[i], o.new_y[i], o.signs[2 + i], red, qa, lo, hi
        )


def eval_g2_add(
    cc: ConstraintConsumer,
    filter_v: Val,
    a_x,
    a_y,
    b_x,
    b_y,
    o: G2OutputView,
):
    delta_x = pol_sub_fq2(b_x, a_x)
    delta_y = pol_sub_fq2(b_y, a_y)
    zero_pol = pol_sub_fq2(pol_mul_fq2(o.lam, delta_x), to_wide_fq2(delta_y))
    lam_sq = pol_mul_fq2(o.lam, o.lam)
    new_x_input = pol_sub_fq2(lam_sq, to_wide_fq2(pol_add_fq2(a_x, b_x)))
    _eval_common(cc, filter_v, o, zero_pol, new_x_input)
    _eval_new_y(cc, filter_v, o, a_x, a_y)


def eval_g2_double(
    cc: ConstraintConsumer,
    filter_v: Val,
    x,
    y,
    o: G2OutputView,
):
    lam_y = pol_mul_fq2(o.lam, y)
    x_sq = pol_mul_fq2(x, x)
    zero_pol = pol_sub_fq2(pol_mul_scalar_fq2(lam_y, 2), pol_mul_scalar_fq2(x_sq, 3))
    lam_sq = pol_mul_fq2(o.lam, o.lam)
    new_x_input = pol_sub_fq2(lam_sq, to_wide_fq2(pol_mul_scalar_fq2(x, 2)))
    _eval_common(cc, filter_v, o, zero_pol, new_x_input)
    _eval_new_y(cc, filter_v, o, x, y)
