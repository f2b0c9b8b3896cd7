"""The port's BN254 G1 modules against the JAX package, on the same numpy
inputs, on the CPU: the host oracle, the G1 double/add witnesses, the
modular-zero gadget, the flag and pulse witnesses, the native-backed batch
witnesses (the port's own build of native/witness.cpp against the JAX
package's), and every constraint value of G1ExpAir(2).eval, on a random LDE
row block (the prover's torch path) and at a random extension point (the
verifier's numpy path). All arithmetic is exact, so "equal" means identical
words.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu import bn254 as jbn
from starky_bn254_tpu.airs.g1_exp import G1ExpAir as JaxG1ExpAir
from starky_bn254_tpu.gadgets import flags as jfl
from starky_bn254_tpu.gadgets import g1 as jg1
from starky_bn254_tpu.gadgets import g1_batch as jgb
from starky_bn254_tpu.gadgets import modular as jmod
from starky_bn254_tpu.gadgets import pulse as jpu
from starky_bn254_tpu.stark.consumer import ConstraintConsumer as JaxConsumer
from starky_bn254_tpu.stark.field_expr import PublicInputsView as JaxPiView
from starky_bn254_tpu.stark.field_expr import RowView as JaxRowView
from starky_bn254_tpu.stark.field_expr import Val as JaxVal
from starky_bn254_tpu_torch import bn254, native, xnp
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
from starky_bn254_tpu_torch.gadgets import flags as fl
from starky_bn254_tpu_torch.gadgets import g1 as g1g
from starky_bn254_tpu_torch.gadgets import g1_batch as gb
from starky_bn254_tpu_torch.gadgets import modular as mod
from starky_bn254_tpu_torch.gadgets import pulse as pu
from starky_bn254_tpu_torch.stark.consumer import ConstraintConsumer
from starky_bn254_tpu_torch.stark.field_expr import PublicInputsView, RowView, Val

torch.set_num_threads(1)


def _scalar(rng):
    return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN


def _points(seed, count):
    rng = np.random.default_rng(seed)
    return [bn254.g1_mul(bn254.G1_GEN, _scalar(rng)) for _ in range(count)]


def test_g1_oracle_matches_jax():
    rng = np.random.default_rng(1)
    pts = _points(2, 4)
    for p, q in zip(pts, pts[1:]):
        k = _scalar(rng)
        assert bn254.g1_mul(p, k) == jbn.g1_mul(p, k)
        assert bn254.g1_add(p, q) == jbn.g1_add(p, q)
        assert bn254.g1_double(p) == jbn.g1_double(p)
        assert bn254.g1_neg(p) == jbn.g1_neg(p)
        assert bn254.g1_is_on_curve(bn254.g1_add(p, q))
        assert bn254.fq_inv(p[0]) == jbn.fq_inv(p[0])
    p = pts[0]
    assert bn254.g1_add(p, bn254.g1_neg(p)) is None
    assert bn254.g1_mul(p, bn254.R_BN) is None  # the group order
    assert bn254.g1_add(p, p) == bn254.g1_double(p)
    assert (bn254.R_BN, bn254.G1_GEN) == (jbn.R_BN, jbn.G1_GEN)


def test_g1_double_and_add_cells_match_jax():
    a, b, c = _points(3, 3)
    for p in (a, b):
        assert g1g.generate_g1_double(*p) == jg1.generate_g1_double(*p)
    for p, q in ((a, b), (b, c)):
        assert g1g.generate_g1_add(*p, *q) == jg1.generate_g1_add(*p, *q)
    assert g1g.zero_g1_output() == jg1.zero_g1_output()
    w = g1g.generate_g1_double(*a)
    assert (w["new_x_int"], w["new_y_int"]) == bn254.g1_double(a)


def test_modular_zero_matches_jax():
    """The slope statements of G1 adds and doubles: lambda*(bx - ax) - (by - ay)
    and 2*lambda*y - 3*x^2, each divisible by p."""
    from starky_bn254_tpu_torch.utils.conversions import int_to_limbs

    pts = _points(4, 4)
    pols = []
    for (ax, ay), (bx, by) in zip(pts, pts[1:]):
        lam = int_to_limbs((by - ay) * bn254.fq_inv(bx - ax) % bn254.P_BN)
        dx = g1g._sub(int_to_limbs(bx), int_to_limbs(ax))
        dy = g1g._sub(int_to_limbs(by), int_to_limbs(ay))
        pols.append(g1g._wide(g1g._sub(g1g._pol_mul_limbs(lam, dx), dy)))
    x, y = pts[0]
    lam = int_to_limbs(3 * x * x * bn254.fq_inv(2 * y) % bn254.P_BN)
    xl, yl = int_to_limbs(x), int_to_limbs(y)
    pols.append(g1g._wide(g1g._sub([2 * c for c in g1g._pol_mul_limbs(lam, yl)],
                                   [3 * c for c in g1g._pol_mul_limbs(xl, xl)])))
    for pol in pols:
        assert mod.generate_modular_zero(bn254.P_BN, pol) == jmod.generate_modular_zero(jbn.P_BN, pol)
    assert mod.zero_modular_aux() == jmod.zero_modular_aux()
    assert mod.AUX_ZERO_COLS == jmod.AUX_ZERO_COLS


def test_flag_and_pulse_witnesses_match_jax():
    rng = np.random.default_rng(5)
    exp_limbs = rng.integers(0, 1 << 32, (3, 8), dtype=np.uint64)
    rows = fl.generate_flag_columns(exp_limbs)
    assert np.array_equal(rows, jfl.generate_flag_columns(exp_limbs))
    n = 3 * fl.NUM_FLAG_ROWS
    positions = [0, 511, 512, 1023, 1535]
    assert np.array_equal(pu.generate_pulse(n, positions), jpu.generate_pulse(n, positions))
    final = rows[:, :, 0].reshape(-1)
    assert np.array_equal(pu.generate_periodic_pulse_witness(final, 512, 511),
                          jpu.generate_periodic_pulse_witness(final, 512, 511))
    rotate = rows[:, :, 1].reshape(-1)
    assert np.array_equal(pu.generate_periodic_pulse_witness(rotate, 64, 62),
                          jpu.generate_periodic_pulse_witness(rotate, 64, 62))


def test_g1_batch_matches_jax_and_exact_gadgets():
    """The batch witnesses through the port's own native library equal the
    JAX package's (its native library) and the exact-int gadgets."""
    a_pts, b_pts = _points(6, 5), _points(7, 5)
    ax, ay = gb.points_to_limbs(a_pts)
    bx, by = gb.points_to_limbs(b_pts)
    cells, nx, ny = gb.double_batch(ax, ay)
    jcells, jnx, jny = jgb.double_batch(ax, ay)
    assert np.array_equal(cells, jcells) and np.array_equal(nx, jnx) and np.array_equal(ny, jny)
    for i, p in enumerate(a_pts):
        assert list(cells[i]) == g1g.generate_g1_double(*p)["cells"]
        assert gb.limbs_to_point(nx[i], ny[i]) == bn254.g1_double(p)
    mask = np.array([True, False, True, True, False])
    cells, nbx, nby = gb.add_batch(ax, ay, bx, by, mask)
    jcells, jbx, jby = jgb.add_batch(ax, ay, bx, by, mask)
    assert np.array_equal(cells, jcells) and np.array_equal(nbx, jbx) and np.array_equal(nby, jby)
    for i, (p, q) in enumerate(zip(a_pts, b_pts)):
        want = g1g.generate_g1_add(*p, *q)["cells"] if mask[i] else g1g.zero_g1_output()["cells"]
        assert list(cells[i]) == want


def test_native_library_raises_on_bad_input():
    """The port's loader has no quiet fallback: bad cells raise."""
    view = np.zeros((8, 4), dtype=np.uint64)
    view[5, 2] = 1 << 16
    with pytest.raises(ValueError, match="2\\^16"):
        native.hist_u16_cols(view, [0, 2])
    counts = native.hist_u16_cols(view, [0, 1])
    assert counts[0] == 16 and counts.sum() == 16
    with pytest.raises(ValueError):
        native.hist_u16_cols(view[:, ::2], [0])  # column stride of two words


# -- constraint values of G1ExpAir(2).eval -----------------------------------


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


def _field(rng, *shape):
    return rng.integers(0, gl.P, shape, dtype=np.uint64)


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
def test_g1_eval_matches_jax_on_an_lde_block(io_binding):
    """The prover's path: the port's eval over int64 tensors of a random
    [64 + pad] row block, the JAX eval over the same rows in numpy."""
    air = G1ExpAir(2, io_binding=io_binding)
    jair = JaxG1ExpAir(2, io_binding=io_binding)
    rng = np.random.default_rng(8)
    rows, pad = 64, 2
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
    assert len(cc.values) == len(jcc.values) >= 50
    for got, want in zip(cc.values, jcc.values):
        assert np.array_equal(got, want)
    for acc, jacc in zip(cc.final_accs(), jcc.final_accs()):
        assert np.array_equal(xnp.to_numpy(acc.arr), np.asarray(jacc.arr))


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
def test_g1_eval_matches_jax_at_an_extension_point(io_binding):
    """The verifier's path: openings, public inputs, selectors and alphas
    as extension scalars, numpy on both sides."""
    air = G1ExpAir(2, io_binding=io_binding)
    jair = JaxG1ExpAir(2, io_binding=io_binding)
    rng = np.random.default_rng(9)
    lv, nv = _field(rng, air.num_columns, 2), _field(rng, air.num_columns, 2)
    pi = _field(rng, air.num_public_inputs)
    sels = [_field(rng, 2) for _ in range(3)]
    alphas = [_field(rng, 2) for _ in range(2)]
    with np.errstate(over="ignore"):
        cc = _Recorder([Val(a, True) for a in alphas], *(Val(s, True) for s in sels))
        air.eval(RowView(lv, True), RowView(nv, True), PublicInputsView(pi, True), cc)
        jcc = _JaxRecorder([JaxVal(a, True) for a in alphas], *(JaxVal(s, True) for s in sels))
        jair.eval(JaxRowView(lv, True), JaxRowView(nv, True), JaxPiView(pi, True), jcc)
    assert len(cc.values) == len(jcc.values) >= 50
    for got, want in zip(cc.values, jcc.values):
        assert np.array_equal(got, want)
