# Frozen copy of starky_bn254_tpu_torch/gadgets/g2.py at commit eed7dfc,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
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
from ..utils.conversions import N_LIMBS
from . import modular as mod
from .fq2 import pol_add_fq2, pol_mul_fq2, pol_mul_scalar_fq2, pol_sub_fq2, to_wide_fq2

G2_OUTPUT_COLS = 40 * N_LIMBS  # 640
P = bn254.P_BN


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
