"""Fq12 multiplication gadget: 12 modular ops per product.

Re-derivation of reference src/fields/fq12/mul.rs: an Fq12 value is 12 limb
vectors [re0..re5, im0..im5] (6 Fq2 coefficients of a degree-6 polynomial in
w, with w^6 = XI = 9 + u). Schoolbook 6x6 over Fq2 pairs gives 11 wide
Fq2 coefficients; the fold-down multiplies the top 5 by XI:

  out_re[i] = re[i] + 9*re[i+6] - im[i+6]        (i < 5)
  out_im[i] = im[i] + re[i+6] + 9*im[i+6]        (i < 5)
  out_re[5] = re[5],  out_im[5] = im[5]

where re[k] = (a0b0 - a1b1)[k], im[k] = (a0b1 + a1b0)[k]
(mul.rs:24-87, xi = 9 at :196).

Output block (84*N_LIMBS cells, mul.rs:176-215): output(12x16) then 12x
aux(95) then 12 quotient signs.

The witness functions here are the exact-int reference, one product at a
time; the trace generators run the native chain (native.exp_chain with
"fq12_exp_chain"), which computes the same schoolbook and fold.
"""

from __future__ import annotations

from .. import bn254
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val
from ..utils.conversions import N_LIMBS, int_to_limbs
from . import modular as mod
from .g1 import _add, _pol_mul_limbs, _sub
from .limbs import pol_mul_wide

FQ12_OUTPUT_COLS = 84 * N_LIMBS  # 1344
P = bn254.P_BN
XI = 9


def _pol_mul_fq12_generic(a, b, mul, add, sub, scalar):
    """a, b: lists of 12 limb 'vectors'; returns 12 wide vectors. Shared by
    the int-list witness and the constraint Vals, so both take one order."""
    a0b0 = [None] * 11
    a0b1 = [None] * 11
    a1b0 = [None] * 11
    a1b1 = [None] * 11

    def acc(dst, k, v):
        dst[k] = v if dst[k] is None else add(dst[k], v)

    for i in range(6):
        for j in range(6):
            k = i + j
            acc(a0b0, k, mul(a[i], b[j]))
            acc(a0b1, k, mul(a[i], b[j + 6]))
            acc(a1b0, k, mul(a[i + 6], b[j]))
            acc(a1b1, k, mul(a[i + 6], b[j + 6]))
    re = [sub(a0b0[k], a1b1[k]) for k in range(11)]  # a0b0 - a1b1 per degree
    im = [add(a0b1[k], a1b0[k]) for k in range(11)]  # a0b1 + a1b0
    out = [sub(add(re[i], scalar(re[i + 6], XI)), im[i + 6]) for i in range(5)] + [re[5]]
    out += [add(add(im[i], re[i + 6]), scalar(im[i + 6], XI)) for i in range(5)] + [im[5]]
    return out


def generate_fq12_mul(a: "bn254.Fq12", b: "bn254.Fq12") -> dict:
    """Host witness: returns cells (84*N_LIMBS) + the product as Fq12."""
    al = [int_to_limbs(v) for v in a.to_fq_list()]
    bl = [int_to_limbs(v) for v in b.to_fq_list()]
    wides = _pol_mul_fq12_generic(al, bl, _pol_mul_limbs, _add, _sub,
                                  lambda x, c: [c * v for v in x])
    ws = [mod.generate_modular_op(P, w) for w in wides]
    cells = []
    for w in ws:
        cells += w["output"]
    for w in ws:
        cells += w["out_aux_red"] + w["quot_abs"] + w["aux_lo"] + w["aux_hi"]
    cells += [w["quot_sign"] for w in ws]
    assert len(cells) == FQ12_OUTPUT_COLS
    product = bn254.Fq12.from_fq_list([w["output_int"] for w in ws])
    # sanity: matches the tower-arithmetic oracle
    assert product.to_fq_list() == (a * b).to_fq_list()
    return {"cells": cells, "product": product}


def zero_fq12_output() -> dict:
    """The block of a row that multiplies nothing: zero cells, signs 1."""
    z = mod.zero_modular_aux()
    cells = [0] * (12 * N_LIMBS)
    for _ in range(12):
        cells += z["out_aux_red"] + z["quot_abs"] + z["aux_lo"] + z["aux_hi"]
    cells += [1] * 12
    assert len(cells) == FQ12_OUTPUT_COLS
    return {"cells": cells, "product": bn254.Fq12.zero()}


class Fq12OutputView:
    """The 1344 cells of an Fq12Output block starting at column `base`."""

    def __init__(self, lv, base: int):
        c = base
        self.output = []
        for _ in range(12):
            self.output.append(lv.cols(c, c + N_LIMBS))
            c += N_LIMBS
        self.aux = []
        for _ in range(12):
            red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
            qa = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
            lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
            self.aux.append((red, qa, lo, hi))
        self.signs = [lv.col(c + i) for i in range(12)]
        assert c + 12 == base + FQ12_OUTPUT_COLS


def eval_fq12_mul(cc: ConstraintConsumer, filter_v: Val, a: list[Val], b: list[Val],
                  o: Fq12OutputView):
    """a, b: 12 limb Vals each ([.., 16]); 12 modular statements bind the
    output block to a * b under filter_v."""
    wides = _pol_mul_fq12_generic(
        a, b, mul=pol_mul_wide, add=lambda x, y: x + y, sub=lambda x, y: x - y,
        scalar=lambda x, c: x * c,
    )
    for k in range(12):
        red, qa, lo, hi = o.aux[k]
        mod.eval_modular_op(cc, filter_v, P, wides[k], o.output[k], o.signs[k], red, qa, lo, hi)
