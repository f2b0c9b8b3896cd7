"""The port's Fq2/G2 modules and the exp AIRs' constraints against the JAX
package, on the same numpy inputs, on the CPU: the Fq2 and G2 host oracle,
the G2 double/add witnesses, the Fq2 limb-polynomial algebra, and every
constraint value of G2ExpAir(1).eval and FqExpAir(2).eval (which hold the
g2, fq2 and modular gadgets) on a random LDE row block (the prover's torch
path) and at a random extension point (the verifier's numpy path). All
arithmetic is exact, so "equal" means identical words.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu import bn254 as jbn
from starky_bn254_tpu.airs.fq_exp import FqExpAir as JaxFqExpAir
from starky_bn254_tpu.airs.g2_exp import G2ExpAir as JaxG2ExpAir
from starky_bn254_tpu.gadgets import fq2 as jfq2
from starky_bn254_tpu.gadgets import g2 as jg2
from starky_bn254_tpu.stark.consumer import ConstraintConsumer as JaxConsumer
from starky_bn254_tpu.stark.field_expr import PublicInputsView as JaxPiView
from starky_bn254_tpu.stark.field_expr import RowView as JaxRowView
from starky_bn254_tpu.stark.field_expr import Val as JaxVal
from starky_bn254_tpu_torch import bn254, native, xnp
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
from starky_bn254_tpu_torch.gadgets import fq2
from starky_bn254_tpu_torch.gadgets import g2 as g2g
from starky_bn254_tpu_torch.stark.consumer import ConstraintConsumer
from starky_bn254_tpu_torch.stark.field_expr import PublicInputsView, RowView, Val

torch.set_num_threads(1)


def _scalar(rng):
    return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN


def _fq2(rng):
    return tuple(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(2))


def _points(seed, count):
    rng = np.random.default_rng(seed)
    return [bn254.g2_mul(bn254.G2_GEN, _scalar(rng)) for _ in range(count)]


def test_fq2_oracle_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(4):
        a, b, s = _fq2(rng), _fq2(rng), _scalar(rng)
        for name in ("fq2_add", "fq2_sub", "fq2_mul"):
            assert getattr(bn254, name)(a, b) == getattr(jbn, name)(a, b), name
        assert bn254.fq2_neg(a) == jbn.fq2_neg(a)
        assert bn254.fq2_scalar(a, s) == jbn.fq2_scalar(a, s)
        assert bn254.fq2_inv(a) == jbn.fq2_inv(a)
        assert bn254.fq2_mul(a, bn254.fq2_inv(a)) == (1, 0)
    assert (bn254.XI, bn254.G2_B, bn254.G2_GEN) == (jbn.XI, jbn.G2_B, jbn.G2_GEN)


def test_g2_oracle_matches_jax():
    rng = np.random.default_rng(12)
    pts = _points(13, 4)
    for p, q in zip(pts, pts[1:]):
        k = _scalar(rng)
        assert bn254.g2_mul(p, k) == jbn.g2_mul(p, k)
        assert bn254.g2_add(p, q) == jbn.g2_add(p, q)
        assert bn254.g2_double(p) == jbn.g2_double(p)
        assert bn254.g2_neg(p) == jbn.g2_neg(p)
        assert bn254.g2_is_on_curve(bn254.g2_add(p, q))
    p = pts[0]
    assert bn254.g2_is_on_curve(bn254.G2_GEN)
    assert not bn254.g2_is_on_curve((p[0], bn254.fq2_add(p[1], (1, 0))))
    assert bn254.g2_add(p, bn254.g2_neg(p)) is None
    assert bn254.g2_mul(p, bn254.R_BN) is None  # the group order
    assert bn254.g2_add(p, p) == bn254.g2_double(p)


def test_g2_double_and_add_cells_match_jax():
    a, b, c = _points(14, 3)
    for p in (a, b):
        w = g2g.generate_g2_double(p)
        assert w == jg2.generate_g2_double(p)
        assert (w["new_x"], w["new_y"]) == bn254.g2_double(p)
    for p, q in ((a, b), (b, c)):
        w = g2g.generate_g2_add(p, q)
        assert w == jg2.generate_g2_add(p, q)
        assert (w["new_x"], w["new_y"]) == bn254.g2_add(p, q)
    assert g2g.zero_g2_output() == jg2.zero_g2_output()


def test_native_chains_raise_on_bad_input():
    """The port's chain bindings have no quiet fallback: a chain the
    library does not run, or shapes that disagree, raise."""
    main = np.zeros((1, 4, 200), dtype=np.uint64)
    a = np.zeros((1, 16), dtype=np.uint64)
    flags = np.zeros(4, dtype=np.uint8), np.zeros((1, 4), dtype=np.uint8)
    with pytest.raises(ValueError, match="unknown chain"):
        native.exp_chain("fq6_exp_chain", a, a, *flags, main, 0, 32)
    with pytest.raises(ValueError, match="past the row"):
        native.exp_chain("fq_exp_chain", a, a, *flags, main, 0, 100)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.exp_chain("fq_exp_chain", a, a, *flags, main[:, :, :150], 0, 32)
    pt = np.zeros((1, 2, 16), dtype=np.uint64)
    with pytest.raises(ValueError, match="past the row"):
        native.g2_exp_chain(pt, pt, pt, pt, *flags, main, 0, 128)
    with pytest.raises(ValueError, match="shapes"):
        native.g2_exp_chain(pt, pt, pt, pt[:, 0], *flags, np.zeros((1, 4, 800), np.uint64), 0, 128)


def _field(rng, *shape):
    return rng.integers(0, gl.P, shape, dtype=np.uint64)


def test_fq2_limb_algebra_matches_jax():
    """Products, sums, scalings and widening of Fq2 lane stacks, on an LDE
    block (torch) against the same lanes in numpy (JAX package)."""
    rng = np.random.default_rng(15)
    x, y = ([_field(rng, 8, 16) for _ in range(2)] for _ in range(2))

    def port(v):
        return tuple(Val(xnp.to_torch(c), False) for c in v)

    def jax(v):
        return tuple(JaxVal(c, False) for c in v)

    pairs = [
        (fq2.pol_mul_fq2(port(x), port(y)), jfq2.pol_mul_fq2(jax(x), jax(y))),
        (fq2.pol_add_fq2(port(x), port(y)), jfq2.pol_add_fq2(jax(x), jax(y))),
        (fq2.pol_sub_fq2(port(x), port(y)), jfq2.pol_sub_fq2(jax(x), jax(y))),
        (fq2.pol_mul_scalar_fq2(port(x), 3), jfq2.pol_mul_scalar_fq2(jax(x), 3)),
        (fq2.to_wide_fq2(port(x)), jfq2.to_wide_fq2(jax(x))),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert np.array_equal(xnp.to_numpy(g.arr), np.asarray(w.arr, dtype=np.uint64))


class _Recorder(ConstraintConsumer):
    """Keeps every constraint's values (after its row selector)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.values = []

    def _accumulate(self, v):
        self.values.append(xnp.to_numpy(self._normalize(v)[0].arr))
        super()._accumulate(v)


class _JaxRecorder(JaxConsumer):
    def __init__(self, *a):
        super().__init__(*a)
        self.values = []

    def _accumulate(self, v):
        self.values.append(np.asarray(self._normalize(v)[0].arr, dtype=np.uint64))
        super()._accumulate(v)


AIRS = {  # name -> (port AIR, JAX AIR) factories by io binding
    "g2": (lambda b: G2ExpAir(1, range_check="logup", io_binding=b),
           lambda b: JaxG2ExpAir(1, range_check="logup", io_binding=b)),
    "fq": (lambda b: FqExpAir(2, range_check="logup", io_binding=b),
           lambda b: JaxFqExpAir(2, range_check="logup", io_binding=b)),
}


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_eval_matches_jax_on_an_lde_block(name, io_binding):
    """The prover's path: the port's eval over int64 tensors of a random
    [32 + pad] row block, the JAX eval over the same rows in numpy."""
    air, jair = (f(io_binding) for f in AIRS[name])
    rng = np.random.default_rng(16)
    rows, pad = 32, 2
    block = _field(rng, rows + pad, air.num_columns)
    pi = _field(rng, air.num_public_inputs)
    sels = [_field(rng, rows) for _ in range(3)]
    alphas = [int(a) for a in _field(rng, 2)]

    tb = xnp.to_torch(block)
    cc = _Recorder([Val(xnp.as_tensor_like(a, tb), False) for a in alphas],
                   *(Val(xnp.to_torch(s), False) for s in sels))
    air.eval(RowView(tb, False, start=0, length=rows), RowView(tb, False, start=pad, length=rows),
             PublicInputsView(xnp.to_torch(pi), False), cc)

    jcc = _JaxRecorder([JaxVal(np.uint64(a), False) for a in alphas],
                       *(JaxVal(s, False) for s in sels))
    jair.eval(JaxRowView(block[:rows], False), JaxRowView(block[pad:], False),
              JaxPiView(pi, False), jcc)
    assert len(cc.values) == len(jcc.values) >= 20
    for got, want in zip(cc.values, jcc.values):
        assert np.array_equal(got, want)
    for acc, jacc in zip(cc.final_accs(), jcc.final_accs()):
        assert np.array_equal(xnp.to_numpy(acc.arr), np.asarray(jacc.arr))


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_eval_matches_jax_at_an_extension_point(name, io_binding):
    """The verifier's path: openings, public inputs, selectors and alphas
    as extension scalars, numpy on both sides."""
    air, jair = (f(io_binding) for f in AIRS[name])
    rng = np.random.default_rng(17)
    lv, nv = _field(rng, air.num_columns, 2), _field(rng, air.num_columns, 2)
    pi = _field(rng, air.num_public_inputs)
    sels = [_field(rng, 2) for _ in range(3)]
    alphas = [_field(rng, 2) for _ in range(2)]
    with np.errstate(over="ignore"):
        cc = _Recorder([Val(a, True) for a in alphas], *(Val(s, True) for s in sels))
        air.eval(RowView(lv, True), RowView(nv, True), PublicInputsView(pi, True), cc)
        jcc = _JaxRecorder([JaxVal(a, True) for a in alphas], *(JaxVal(s, True) for s in sels))
        jair.eval(JaxRowView(lv, True), JaxRowView(nv, True), JaxPiView(pi, True), jcc)
    assert len(cc.values) == len(jcc.values) >= 20
    for got, want in zip(cc.values, jcc.values):
        assert np.array_equal(got, want)
