"""The port's logUp argument, logUp range checks and RLC IO binding against
the JAX package, on the same numpy inputs, on the CPU.

The logUp aux columns by both of the port's routes (a Fermat chain per
cell, or a 2^16-entry inverse table and a gather) equal the JAX package's,
on a [4096, 8] u16 trace and on a 2^16-row logup_u16 range check over 4
target columns; the constraint values of logup_constraints and of the RLC
binding's eval_extra equal the JAX evaluation on a random LDE row block
(torch) and at a random extension point (numpy); the range-check generators
and G1ExpAir's RLC aux columns are the JAX package's. All arithmetic is
exact, so "equal" means identical words.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu.airs.g1_exp import G1ExpAir as JaxG1ExpAir
from starky_bn254_tpu.gadgets import range_check as jrc
from starky_bn254_tpu.stark import logup as jlogup
from starky_bn254_tpu.stark.consumer import ConstraintConsumer as JaxConsumer
from starky_bn254_tpu.stark.field_expr import PublicInputsView as JaxPiView
from starky_bn254_tpu.stark.field_expr import RowView as JaxRowView
from starky_bn254_tpu.stark.field_expr import Val as JaxVal
from starky_bn254_tpu_torch import bn254, xnp
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
from starky_bn254_tpu_torch.gadgets import range_check as rc
from starky_bn254_tpu_torch.stark import logup
from starky_bn254_tpu_torch.stark.consumer import ConstraintConsumer
from starky_bn254_tpu_torch.stark.field_expr import PublicInputsView, RowView, Val

torch.set_num_threads(1)

GAMMAS = [999, 424242]


def _u16(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 16, shape, dtype=np.uint64)


def _field(rng, *shape):
    return rng.integers(0, gl.P, shape, dtype=np.uint64)


@pytest.mark.parametrize("route", ["fermat", "table"])
def test_logup_columns_match_jax_on_a_small_trace(route):
    tr = _u16(7, (4096, 8))
    tables = [(0, 1, tuple(range(2, 8)))]  # an odd pair count: 3 pairs, no single
    tables_odd = [(0, 1, tuple(range(2, 7)))]  # 2 pairs and a single
    for tbl in (tables, tables_odd):
        want = np.asarray(jlogup.compute_logup_columns(tr, tbl, GAMMAS))
        got = xnp.to_numpy(logup.compute_logup_columns(xnp.to_torch(tr), tbl, GAMMAS, route))
        assert got.shape == (4096, 2 * logup.table_aux_width(tbl)) == want.shape
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def u16_range_checked():
    """A 2^16-row trace of 6 u16 columns with its logup_u16 range check over
    columns 1..4 appended (table, multiplicity)."""
    base = _u16(9, (1 << 16, 6))
    spec = rc.RangeCheckSpec("logup_u16", 6, [1, 2, 3, 4])
    added = spec.generate(base)
    assert np.array_equal(added, jrc.RangeCheckSpec("logup_u16", 6, [1, 2, 3, 4]).generate(base))
    return np.concatenate([base, added], axis=1), spec


@pytest.mark.parametrize("route", ["fermat", "table"])
def test_logup_columns_match_jax_on_a_u16_range_check(u16_range_checked, route):
    trace, spec = u16_range_checked
    tables = spec.tables()
    assert logup.pick_route(trace.shape[0], tables) == "table"  # 2^18 checked cells
    want = np.asarray(jlogup.compute_logup_columns(trace, tables, GAMMAS))
    got = xnp.to_numpy(logup.compute_logup_columns(xnp.to_torch(trace), tables, GAMMAS, route))
    assert np.array_equal(got, want)
    s_cols = [logup.table_aux_width(tables) * c + 3 for c in range(2)]
    assert (got[0, s_cols] == 0).all()  # S starts at 0


def test_table_gather_keeps_out_of_range_cells_in_the_table():
    """A forged cell >= 2^16 reads the last table entry, as the JAX
    package's clamped gather does, instead of indexing past the table."""
    tr = _u16(3, (4096, 4))
    tr[5, 2] = (1 << 16) + 3
    tr[6, 3] = gl.P - 1
    tables = [(0, 1, (2, 3))]
    got = xnp.to_numpy(logup.compute_logup_columns(xnp.to_torch(tr), tables, GAMMAS, "table"))
    clamped = tr.copy()
    clamped[5, 2] = clamped[6, 3] = (1 << 16) - 1
    want = xnp.to_numpy(logup.compute_logup_columns(xnp.to_torch(clamped), tables, GAMMAS,
                                                    "fermat"))
    assert np.array_equal(got, want)


def test_range_check_generators_and_spec_match_jax():
    base = _u16(11, (512, 5))
    targets = [0, 2, 3]
    assert np.array_equal(rc.generate_logup_range_check(base, targets),
                          jrc.generate_logup_range_check(base, targets))
    for flavor in ("split", "logup", "logup_u16"):
        spec = rc.RangeCheckSpec(flavor, 5, targets)
        jspec = jrc.RangeCheckSpec(flavor, 5, targets)
        assert spec.num_added == jspec.num_added
        assert spec.tables() == jspec.tables()
        assert spec.pairs() == jspec.pairs()
    spec = rc.RangeCheckSpec("logup", 5, targets)
    assert np.array_equal(spec.generate(base), jrc.RangeCheckSpec("logup", 5, targets).generate(base))
    with pytest.raises(NotImplementedError):
        rc.RangeCheckSpec("u16", 5, targets)


# -- constraint values --------------------------------------------------------


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


def _block_views(rng, rows, pad, width, aux_width, n_pi):
    """The same random operands for both packages, in prover mode: the
    port's as int64 tensors windowed like the composition's row blocks,
    the JAX package's as numpy rows."""
    main, aux = _field(rng, rows + pad, width), _field(rng, rows + pad, aux_width)
    pi = _field(rng, n_pi)
    sels = [_field(rng, rows) for _ in range(3)]
    alphas = [int(a) for a in _field(rng, 2)]
    gammas = [int(g) for g in _field(rng, 2)]
    tm, ta = xnp.to_torch(main), xnp.to_torch(aux)
    port = dict(
        lv=RowView(tm, False, start=0, length=rows), nv=RowView(tm, False, start=pad, length=rows),
        aux_lv=RowView(ta, False, start=0, length=rows),
        aux_nv=RowView(ta, False, start=pad, length=rows),
        pi=PublicInputsView(xnp.to_torch(pi), False),
        gammas=[Val(xnp.as_tensor_like(g, tm), False) for g in gammas],
        cc=_Recorder([Val(xnp.as_tensor_like(a, tm), False) for a in alphas],
                     *(Val(xnp.to_torch(s), False) for s in sels)),
    )
    jax = dict(
        lv=JaxRowView(main[:rows], False), nv=JaxRowView(main[pad:], False),
        aux_lv=JaxRowView(aux[:rows], False), aux_nv=JaxRowView(aux[pad:], False),
        pi=JaxPiView(pi, False), gammas=[JaxVal(np.uint64(g), False) for g in gammas],
        cc=_JaxRecorder([JaxVal(np.uint64(a), False) for a in alphas],
                        *(JaxVal(s, False) for s in sels)),
    )
    return port, jax


def _point_views(rng, width, aux_width, n_pi):
    """Verifier mode: extension scalars, numpy on both sides."""
    lv, nv = _field(rng, width, 2), _field(rng, width, 2)
    aux_lv, aux_nv = _field(rng, aux_width, 2), _field(rng, aux_width, 2)
    pi = _field(rng, n_pi)
    sels = [_field(rng, 2) for _ in range(3)]
    alphas = [_field(rng, 2) for _ in range(2)]
    gammas = [np.array([g, 0], dtype=np.uint64) for g in _field(rng, 2)]
    port = dict(lv=RowView(lv, True), nv=RowView(nv, True), aux_lv=RowView(aux_lv, True),
                aux_nv=RowView(aux_nv, True), pi=PublicInputsView(pi, True),
                gammas=[Val(g, True) for g in gammas],
                cc=_Recorder([Val(a, True) for a in alphas], *(Val(s, True) for s in sels)))
    jax = dict(lv=JaxRowView(lv, True), nv=JaxRowView(nv, True), aux_lv=JaxRowView(aux_lv, True),
               aux_nv=JaxRowView(aux_nv, True), pi=JaxPiView(pi, True),
               gammas=[JaxVal(g, True) for g in gammas],
               cc=_JaxRecorder([JaxVal(a, True) for a in alphas], *(JaxVal(s, True) for s in sels)))
    return port, jax


def _assert_same_values(port, jax, at_least):
    assert len(port["cc"].values) == len(jax["cc"].values) >= at_least
    for got, want in zip(port["cc"].values, jax["cc"].values):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["lde_block", "extension_point"])
def test_logup_constraints_match_jax(mode):
    tables = [(0, 1, tuple(range(2, 9))), (9, 10, (11, 12))]  # a single tail, then a pair
    aux_offset = 3  # behind three permutation Z columns
    aux_width = aux_offset + 2 * logup.table_aux_width(tables)
    rng = np.random.default_rng(21)
    if mode == "lde_block":
        port, jax = _block_views(rng, 64, 2, 13, aux_width, 0)
    else:
        port, jax = _point_views(rng, 13, aux_width, 0)
    with np.errstate(over="ignore"):
        for side, fn in ((port, logup.logup_constraints), (jax, jlogup.logup_constraints)):
            fn(tables, side["gammas"], side["lv"], side["nv"], side["aux_lv"], side["aux_nv"],
               side["cc"], aux_offset)
    _assert_same_values(port, jax, 2 * 2 * 4 - 2)


@pytest.mark.parametrize("mode", ["lde_block", "extension_point"])
def test_rlc_eval_extra_matches_jax(mode):
    air = G1ExpAir(2, io_binding="rlc")
    jair = JaxG1ExpAir(2, io_binding="rlc")
    aux_offset = 2 * logup.table_aux_width(air.lookup_tables())
    aux_width = aux_offset + 2 * air.aux_extra_width()
    rng = np.random.default_rng(22)
    if mode == "lde_block":
        port, jax = _block_views(rng, 64, 2, air.num_columns, aux_width, air.num_public_inputs)
    else:
        port, jax = _point_views(rng, air.num_columns, aux_width, air.num_public_inputs)
    with np.errstate(over="ignore"):
        for side, a in ((port, air), (jax, jair)):
            a.eval_extra(side["lv"], side["nv"], side["aux_lv"], side["aux_nv"], side["gammas"],
                         side["pi"], side["cc"], aux_offset)
    _assert_same_values(port, jax, 2 * 7)


def test_rlc_aux_columns_match_jax():
    rng = np.random.default_rng(23)

    def scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    inputs = [(bn254.g1_mul(bn254.G1_GEN, scalar()), bn254.g1_mul(bn254.G1_GEN, scalar()),
               scalar()) for _ in range(2)]
    air = G1ExpAir(2, range_check="logup", io_binding="rlc")
    trace, _ = air.generate_trace_and_pi(inputs)
    gammas = [int(g) for g in _field(rng, 2)]
    got = air.generate_aux(trace, gammas)
    want = JaxG1ExpAir(2, range_check="logup", io_binding="rlc").generate_aux(trace, gammas)
    assert got.shape == (1024, 4)
    assert np.array_equal(got, np.asarray(want))
