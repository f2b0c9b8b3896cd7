"""The port's Fq12 modules and the MSM composition against the JAX package,
on the same numpy inputs, on the CPU: the Fq12 host oracle, the Fq12
multiply witness, the u64 exponent flags (at the edge exponents, the
public inputs of Fq12ExpU64Air included), the native "fq12_exp_chain"
against the exact-int gadget for both Fq12 AIRs, every constraint value of
Fq12ExpAir(1).eval and Fq12ExpU64Air(1).eval on a random LDE row block (the
prover's torch path) and at a random extension point (the verifier's numpy
path), the MSM chain builders and checks, and the square roots and SVDW map
behind hash-to-G2. No test here proves anything. All arithmetic is exact,
so "equal" means identical words.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu import bn254 as jbn
from starky_bn254_tpu.airs.fq12_exp import Fq12ExpAir as JaxFq12ExpAir
from starky_bn254_tpu.airs.fq12_exp_u64 import Fq12ExpU64Air as JaxFq12ExpU64Air
from starky_bn254_tpu.compose import msm as jmsm
from starky_bn254_tpu.gadgets import flags_u64 as jfl64
from starky_bn254_tpu.gadgets import fq12 as jfq12
from starky_bn254_tpu.stark.consumer import ConstraintConsumer as JaxConsumer
from starky_bn254_tpu.stark.field_expr import PublicInputsView as JaxPiView
from starky_bn254_tpu.stark.field_expr import RowView as JaxRowView
from starky_bn254_tpu.stark.field_expr import Val as JaxVal
from starky_bn254_tpu_torch import bn254, native, xnp
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch.airs import Fq12ExpAir, Fq12ExpU64Air, G1ExpAir, G2ExpAir
from starky_bn254_tpu_torch.airs.fq12_exp import FQ12_EXP_IO_LEN, START_FLAGS
from starky_bn254_tpu_torch.airs.fq12_exp_u64 import FQ12_EXP_U64_IO_LEN
from starky_bn254_tpu_torch.airs.g1_exp import G1_EXP_IO_LEN
from starky_bn254_tpu_torch.airs.g2_exp import G2_EXP_IO_LEN
from starky_bn254_tpu_torch.compose import msm
from starky_bn254_tpu_torch.gadgets import flags_u64 as fl64
from starky_bn254_tpu_torch.gadgets import fq12 as fq12g
from starky_bn254_tpu_torch.stark.consumer import ConstraintConsumer
from starky_bn254_tpu_torch.stark.field_expr import PublicInputsView, RowView, Val

torch.set_num_threads(1)

P_GL = (1 << 64) - (1 << 32) + 1
EDGE_EXPONENTS = [0, 1, (1 << 63) - 1, 1 << 63, P_GL - 1, P_GL, (1 << 64) - 1]


def _fq(rng):
    return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN


def _fq12(rng):
    return bn254.Fq12.from_fq_list([_fq(rng) for _ in range(12)])


def _jax(f):
    """The same Fq12 value as the JAX package's type."""
    return jbn.Fq12(f.coeffs)


def _scalar(rng):
    return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN


def test_fq12_oracle_matches_jax():
    rng = np.random.default_rng(21)
    for _ in range(3):
        a, b, e = _fq12(rng), _fq12(rng), _scalar(rng)
        assert (a * b).coeffs == (_jax(a) * _jax(b)).coeffs
        assert a.pow(e).coeffs == _jax(a).pow(e).coeffs
        assert a.inv().coeffs == _jax(a).inv().coeffs
        assert (a * a.inv()).coeffs == bn254.Fq12.one().coeffs
        assert a.to_fq_list() == _jax(a).to_fq_list()
        vals = a.to_fq_list()
        assert bn254.Fq12.from_fq_list(vals) == a
        assert bn254.Fq12.from_fq_list([v + bn254.P_BN for v in vals]).coeffs \
            == jbn.Fq12.from_fq_list([v + bn254.P_BN for v in vals]).coeffs
    assert bn254.Fq12.one().coeffs == jbn.Fq12.one().coeffs
    assert bn254.Fq12.zero().coeffs == jbn.Fq12.zero().coeffs


def test_fq12_mul_cells_match_jax():
    rng = np.random.default_rng(22)
    a, b = _fq12(rng), _fq12(rng)
    for x, y in ((a, b), (a, a)):
        w = fq12g.generate_fq12_mul(x, y)
        jw = jfq12.generate_fq12_mul(_jax(x), _jax(y))
        assert len(w["cells"]) == fq12g.FQ12_OUTPUT_COLS == 1344
        assert w["cells"] == jw["cells"]
        assert w["product"].coeffs == jw["product"].coeffs
    assert fq12g.zero_fq12_output()["cells"] == jfq12.zero_fq12_output()["cells"]


@pytest.fixture(scope="module")
def edge_statement():
    """Fq12ExpU64Air's trace and public inputs, in both packages, with one
    instance per edge exponent (and one more of exponent 3)."""
    rng = np.random.default_rng(23)
    x, off = _fq12(rng), _fq12(rng)
    inputs = [(x, off, e) for e in EDGE_EXPONENTS] + [(off, x, 3)]
    port = Fq12ExpU64Air(len(inputs), io_binding="pulse").generate_trace_and_pi(inputs)
    jax = JaxFq12ExpU64Air(len(inputs), io_binding="pulse").generate_trace_and_pi(
        [(_jax(x), _jax(o), e) for x, o, e in inputs])
    return port, jax


@pytest.mark.parametrize("exp", EDGE_EXPONENTS, ids=lambda e: hex(e))
def test_u64_flags_and_public_inputs_match_jax(exp, edge_statement):
    """The u64 flag columns, and the instance's rows of Fq12ExpU64Air's
    trace and its public inputs, at the edge exponents. At or above p the
    exponent cell holds the raw word e % 2^64, a non-canonical field value,
    in both packages."""
    exps = np.array([exp], dtype=np.uint64)
    flags = fl64.generate_flag_u64_columns(exps)
    assert flags.shape == (1, 128, 6)
    assert np.array_equal(flags, jfl64.generate_flag_u64_columns(exps))
    (trace, pi), (jtrace, jpi) = edge_statement
    assert np.array_equal(trace, jtrace)
    assert np.array_equal(pi, jpi)
    i = EDGE_EXPONENTS.index(exp)
    assert np.array_equal(trace[128 * i : 128 * (i + 1), START_FLAGS : START_FLAGS + 6], flags[0])
    assert int(pi[FQ12_EXP_U64_IO_LEN * i + 24 * 16]) == exp % (1 << 64)


def _chain_case(name):
    rng = np.random.default_rng(24)
    if name == "fq12":
        inputs = [(_fq12(rng), _fq12(rng), _scalar(rng))]
        return Fq12ExpAir(1, io_binding="rlc"), JaxFq12ExpAir(1, io_binding="rlc"), inputs
    inputs = [(_fq12(rng), _fq12(rng), e) for e in ((1 << 64) - 1, int(rng.integers(0, 1 << 63)))]
    return Fq12ExpU64Air(2, io_binding="rlc"), JaxFq12ExpU64Air(2, io_binding="rlc"), inputs


@pytest.mark.parametrize("name", ["fq12", "fq12_u64"])
def test_native_fq12_chain_matches_exact_and_jax(name):
    """The native chain (for the u64 AIR driven by flag cols 1 and 3) writes
    the exact-int gadget's trace, and the JAX package's (which takes the
    same chain for Fq12ExpAir and a batched numpy witness for the u64 AIR)."""
    air, jair, inputs = _chain_case(name)
    trace, pi = air.generate_trace_and_pi(inputs)
    ref_trace, ref_pi = air.generate_trace_and_pi(inputs, exact=True)
    jtrace, jpi = jair.generate_trace_and_pi([(_jax(x), _jax(o), e) for x, o, e in inputs])
    assert trace.shape == ((512, 4412) if name == "fq12" else (256, 4402))
    assert np.array_equal(trace, ref_trace) and np.array_equal(pi, ref_pi)
    assert np.array_equal(trace, jtrace) and np.array_equal(pi, jpi)


def test_native_fq12_chain_raises_on_bad_input():
    """The binding has no fallback: shapes that disagree, offsets past the
    row and a non-contiguous trace raise."""
    a = np.zeros((1, 12, 16), dtype=np.uint64)
    flags = np.zeros(4, dtype=np.uint8), np.zeros((1, 4), dtype=np.uint8)
    main = np.zeros((1, 4, 1800), dtype=np.uint64)
    native.exp_chain("fq12_exp_chain", a, a, *flags, main, 0, 384)  # the layout fits
    with pytest.raises(ValueError, match="past the row"):
        native.exp_chain("fq12_exp_chain", a, a, *flags, main, 0, 500)
    with pytest.raises(ValueError, match="shapes"):
        native.exp_chain("fq12_exp_chain", a[:, 0], a[:, 0], *flags, main, 0, 384)
    with pytest.raises(ValueError, match="shapes"):
        native.exp_chain("fq12_exp_chain", a, a, flags[0][:3], flags[1], main, 0, 384)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.exp_chain("fq12_exp_chain", a, a, *flags, main[:, :, :1760], 0, 384)
    with pytest.raises(ValueError, match="unknown chain"):
        native.exp_chain("fq6_exp_chain", a, a, *flags, main, 0, 384)


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


AIRS = {  # name -> (port AIR, JAX AIR) factories by io binding
    "fq12": (lambda b: Fq12ExpAir(1, range_check="logup", io_binding=b),
             lambda b: JaxFq12ExpAir(1, range_check="logup", io_binding=b)),
    "fq12_u64": (lambda b: Fq12ExpU64Air(1, range_check="logup", io_binding=b),
                 lambda b: JaxFq12ExpU64Air(1, range_check="logup", io_binding=b)),
}


def _assert_same_constraints(cc, jcc):
    assert len(cc.values) == len(jcc.values) >= 20
    for got, want in zip(cc.values, jcc.values):
        assert np.array_equal(got, want)
    for acc, jacc in zip(cc.final_accs(), jcc.final_accs()):
        assert np.array_equal(xnp.to_numpy(acc.arr), np.asarray(jacc.arr, dtype=np.uint64))


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_eval_matches_jax_on_an_lde_block(name, io_binding):
    """The prover's path: the port's eval over int64 tensors of a random
    [16 + pad] row block, the JAX eval over the same rows in numpy."""
    air, jair = (f(io_binding) for f in AIRS[name])
    rng = np.random.default_rng(25)
    rows, pad = 16, 2
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
    _assert_same_constraints(cc, jcc)


@pytest.mark.parametrize("io_binding", ["pulse", "rlc"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_eval_matches_jax_at_an_extension_point(name, io_binding):
    """The verifier's path: openings, public inputs, selectors and alphas
    as extension scalars, numpy on both sides."""
    air, jair = (f(io_binding) for f in AIRS[name])
    rng = np.random.default_rng(26)
    lv, nv = _field(rng, air.num_columns, 2), _field(rng, air.num_columns, 2)
    pi = _field(rng, air.num_public_inputs)
    sels = [_field(rng, 2) for _ in range(3)]
    alphas = [_field(rng, 2) for _ in range(2)]
    with np.errstate(over="ignore"):
        cc = _Recorder([Val(a, True) for a in alphas], *(Val(s, True) for s in sels))
        air.eval(RowView(lv, True), RowView(nv, True), PublicInputsView(pi, True), cc)
        jcc = _JaxRecorder([JaxVal(a, True) for a in alphas], *(JaxVal(s, True) for s in sels))
        jair.eval(JaxRowView(lv, True), JaxRowView(nv, True), JaxPiView(pi, True), jcc)
    _assert_same_constraints(cc, jcc)


def test_pad_instances_matches_jax():
    for n, m in ((1, 1), (2, 1), (3, 1), (5, 1), (8, 1), (3, 16)):
        items = list(range(n))
        assert msm.pad_instances(items, m) == jmsm.pad_instances(items, m)
    assert msm.pad_instances([7, 8, 9]) == [7, 8, 9, 9]


OFFSET_OF_INSTANCE_1 = {  # public-input index of instance 1's offset
    "g1": G1_EXP_IO_LEN + 16, "g2": G2_EXP_IO_LEN + 32,
    "fq12": FQ12_EXP_IO_LEN + 12 * 16, "fq12_u64": FQ12_EXP_U64_IO_LEN + 12 * 16,
}


def _msm_case(name, rng):
    """(port builder, JAX builder, port AIR, port inputs, JAX inputs)."""
    if name == "g1":
        pts = [bn254.g1_mul(bn254.G1_GEN, _scalar(rng)) for _ in range(3)]
        return (msm.G1Msm(), jmsm.G1Msm(), lambda n: G1ExpAir(n, io_binding="pulse"),
                (pts, [_scalar(rng) for _ in pts]), None)
    if name == "g2":
        pts = [bn254.g2_mul(bn254.G2_GEN, _scalar(rng)) for _ in range(2)]
        return (msm.G2Msm(), jmsm.G2Msm(), lambda n: G2ExpAir(n, io_binding="pulse"),
                (pts, [_scalar(rng) for _ in pts]), None)
    u64 = name == "fq12_u64"
    xs = [_fq12(rng) for _ in range(3)]
    exps = [(1 << 64) + 5, _scalar(rng), 3] if u64 else [_scalar(rng), 2, 0]
    air = (lambda n: Fq12ExpU64Air(n, io_binding="pulse")) if u64 else \
        (lambda n: Fq12ExpAir(n, io_binding="pulse"))
    return (msm.Fq12MultiExp(u64=u64), jmsm.Fq12MultiExp(u64=u64), air, (xs, exps),
            ([_jax(x) for x in xs], exps))


def _same(a, b):
    """Equal values, the port's Fq12 against the JAX package's."""
    if isinstance(a, bn254.Fq12):
        return a.coeffs == b.coeffs
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", ["g1", "g2", "fq12", "fq12_u64"])
def test_msm_build_inputs_and_check_chain_match_jax(name):
    """The offset chain each builder makes, padded and traced, checks true
    against its result in both packages and false against another one."""
    rng = np.random.default_rng(27)
    port, jax, air_of, args, jargs = _msm_case(name, rng)
    inputs, result = port.build_inputs(*args)
    jinputs, jresult = jax.build_inputs(*(jargs or args))
    assert _same(inputs, jinputs) and _same(result, jresult)
    padded = msm.pad_instances(inputs)
    _, pi = air_of(len(padded)).generate_trace_and_pi(padded)
    n_real = len(inputs)
    wrong = {"g1": bn254.g1_double, "g2": bn254.g2_double}.get(name, lambda r: r * r)(result)
    assert port.check_chain(pi, n_real, result)
    assert jax.check_chain(pi, n_real, jresult)
    assert not port.check_chain(pi, n_real, wrong)
    broken = pi.copy()  # instance 1's offset no longer instance 0's output
    broken[OFFSET_OF_INSTANCE_1[name]] ^= np.uint64(1)
    assert not port.check_chain(broken, n_real, result)
    assert not jax.check_chain(broken, n_real, jresult)


def test_square_roots_match_jax():
    rng = np.random.default_rng(28)
    for _ in range(4):
        a, b = _fq(rng), _fq(rng)
        assert bn254.fq_is_square(a) == jbn.fq_is_square(a)
        assert bn254.fq_sqrt(a) == jbn.fq_sqrt(a)
        r = bn254.fq_sqrt(a * a)
        assert r * r % bn254.P_BN == a * a % bn254.P_BN
        assert bn254.fq2_is_square((a, b)) == jbn.fq2_is_square((a, b))
        assert bn254.fq2_sqrt((a, b)) == jbn.fq2_sqrt((a, b))
        sq = bn254.fq2_mul((a, b), (a, b))
        r2 = bn254.fq2_sqrt(sq)
        assert bn254.fq2_mul(r2, r2) == sq
        assert bn254._fq2_sgn0((a, b)) == jbn._fq2_sgn0((a, b))
    assert bn254.fq2_sqrt((4, 0)) == jbn.fq2_sqrt((4, 0))
    assert bn254.fq2_sqrt((bn254.P_BN - 4, 0)) == jbn.fq2_sqrt((bn254.P_BN - 4, 0))
    assert bn254._svdw_constants() == jbn._svdw_constants()
    assert bn254.G2_COFACTOR == jbn.G2_COFACTOR


@pytest.mark.parametrize("msg", [b"", b"abc", b"starky bn254 hash-to-G2 message"])
def test_hash_to_g2_matches_jax(msg):
    """The message's Fq2 element, its SVDW point on the twist and the
    cofactor instance; cofactor times the point lands in the r-torsion."""
    u = bn254.hash_to_g2_field(msg)
    assert u == jbn.hash_to_g2_field(msg)
    p = bn254.map_to_g2_svdw(u)
    assert p == jbn.map_to_g2_svdw(u)
    assert bn254.g2_is_on_curve(p)
    assert msm.g2_mul_by_cofactor_input(p) == jmsm.g2_mul_by_cofactor_input(p)
    q = bn254.g2_mul(p, bn254.G2_COFACTOR)
    assert bn254.g2_mul(q, bn254.R_BN) is None


def _entry_calls():
    rng = np.random.default_rng(29)
    g1 = [bn254.g1_mul(bn254.G1_GEN, _scalar(rng))]
    g2 = [bn254.g2_mul(bn254.G2_GEN, _scalar(rng))]
    return {
        "g1_msm": lambda **kw: msm.prove_g1_msm(g1, [5], **kw),
        "g2_msm": lambda **kw: msm.prove_g2_msm(g2, [5], **kw),
        "fq12_multiexp": lambda **kw: msm.prove_fq12_multiexp([_fq12(rng)], [5], **kw),
        "fq12_multiexp_u64": lambda **kw: msm.prove_fq12_multiexp(
            [_fq12(rng), _fq12(rng)], [5, 7], u64=True, **kw),
        "fq_multiexp": lambda **kw: msm.prove_fq_multiexp([_fq(rng), _fq(rng)], [5, 7], **kw),
        "hash_to_g2": lambda **kw: msm.prove_hash_to_g2(b"abc", **kw),
    }


@pytest.mark.parametrize("entry", sorted(_entry_calls()))
def test_entry_points_run_on_the_card_by_default(entry, monkeypatch):
    """With no device named each entry point proves on the card, and where
    there is none it raises (after its host tracegen) instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _entry_calls()[entry](cfg=None)
