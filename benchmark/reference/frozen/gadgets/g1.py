# Frozen copy of starky_bn254_tpu_torch/gadgets/g1.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
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


from .. import bn254
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val
from ..utils.conversions import N_LIMBS
from . import modular as mod
from .limbs import lane_pad, pol_mul_wide

G1_OUTPUT_COLS = 20 * N_LIMBS  # 320

P = bn254.P_BN


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
