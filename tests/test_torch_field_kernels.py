"""The field kernels (csrc/field.cu) against goldilocks.py's plain torch
engine.

On a card, each op that goldilocks.py dispatches to a kernel (add, sub,
mul, neg, mul_const, sum_mod) must give the plain version's words byte for
byte, on random full-range words and the edge words, at the composition's
operand patterns; a G1ExpAir(1) and an Fq12ExpAir(1) composition block on
the card must equal the CPU's; and a CUDA operand must never reach the
torch chain: each call is one launch. Those tests are marked `cuda` and
skip without a card. Two of them need two cards or more (a host of
several): an op on a card that is not the current one, and a mesh prove
over the host's cards, whose composition runs each shard's field ops on
its own card.

On the CPU: a CPU tensor or a numpy array launches nothing, and the
wrapper's layout (broadcast, size-1 dims dropped, dims merged, strides a
word) replayed with torch.as_strided gives the plain op's result, so the
plan a kernel walks is checked without a card.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu_torch import bn254
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch import xnp
from starky_bn254_tpu_torch.airs.fq12_exp import Fq12ExpAir
from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
from starky_bn254_tpu_torch.parallel import sharded
from starky_bn254_tpu_torch.stark import composition, proof_to_bytes, prove
from starky_bn254_tpu_torch.stark.config import StarkConfig
from starky_bn254_tpu_torch.stark.logup import table_aux_width
from starky_bn254_tpu_torch.utils import timing as tm

P = gl.P
EDGE = np.array([0, 1, gl.EPSILON, (1 << 32) - 1, P - 1, P, P + 1, (1 << 64) - 1, 1 << 63,
                 1 << 32, P - (1 << 32)], dtype=np.uint64)

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the field kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a field op on a card that is not the current one")
    return torch.device("cuda", 1)


def _words(rng, shape) -> torch.Tensor:
    """Random u64 words (int64 bits) with the edge words at random places."""
    w = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    flat = w.reshape(-1)
    k = min(len(EDGE), flat.size)
    flat[rng.permutation(flat.size)[:k]] = EDGE[rng.permutation(len(EDGE))[:k]]
    return xnp.to_torch(w)


B = 97  # rows: no power of two, so no dims line up by chance


def _patterns(rng):
    """(a, b) operand pairs of the composition: equal shapes, a column
    against its lanes ([B, 1] x [B, k]), the limb product's [B, ka, 1] x
    [B, 1, kb], 0-d challenges and selectors, lane weights [k], column
    slices of a row block read in place (row stride = the block's width),
    a transposed operand, and a 4-d broadcast."""
    block = _words(rng, (B + 2, 40))
    return {
        "same": (_words(rng, (B, 5)), _words(rng, (B, 5))),
        "lane": (_words(rng, (B,))[:, None], _words(rng, (B, 9))),
        "outer": (_words(rng, (B, 4, 1)), _words(rng, (B, 1, 6))),
        "zero_d": (_words(rng, ()), _words(rng, (B, 3))),
        "both_zero_d": (_words(rng, ()), _words(rng, ())),
        "weights": (_words(rng, (B, 12)), _words(rng, (12,))),
        "col_slices": (block[:B, 3:19], block[2 : B + 2, 20:36]),
        "col_lane": (block[:B, 7, None], block[1 : B + 1, 8:24]),
        "transposed": (_words(rng, (9, 11)).T, _words(rng, (11, 9))),
        "four_d": (_words(rng, (3, 1, 5, 7)), _words(rng, (1, 4, 5, 1))),
    }


HOST_SCALARS = [3, 0, P - 1, (1 << 64) - 1, np.uint64(12345), np.asarray(np.uint64(P + 5))]
BINARY = {"add": (gl.add, gl._add_plain), "sub": (gl.sub, gl._sub_plain),
          "mul": (gl.mul, gl._mul_plain)}
SUM_SHAPES = [(B, 17), (B, 5, 31), (3, 4, 5, 7), (300, 33), (5000, 3), (2049, 70), (1,), (7,)]


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    got = got.cpu()
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want.cpu())


# ----------------------------------------------------------------------------
# CPU: nothing launches; the layout a kernel walks
# ----------------------------------------------------------------------------


def test_cpu_and_numpy_operands_launch_nothing():
    rng = np.random.default_rng(0)
    a, b = _words(rng, (B, 4)), _words(rng, (B, 4))
    before = gl.LAUNCHES
    for t in (a, xnp.to_numpy(a)):
        u = xnp.to_numpy(b) if isinstance(t, np.ndarray) else b
        gl.add(t, u), gl.sub(t, u), gl.mul(t, u), gl.neg(t), gl.mul_const(t, 7)
        gl.sum_mod(t, 0), gl.inv(t)
    assert gl.LAUNCHES == before


def _walk(t: torch.Tensor, sizes, strides) -> torch.Tensor:
    """t's words in the kernel's order: the plan's sizes and strides from
    t's first word."""
    return torch.as_strided(t, sizes, strides, t.storage_offset())


@pytest.mark.parametrize("pattern", ["same", "lane", "outer", "zero_d", "both_zero_d", "weights",
                                     "col_slices", "col_lane", "transposed", "four_d"])
def test_layout_replayed_on_the_cpu_gives_the_plain_result(monkeypatch, pattern):
    monkeypatch.setattr(gl, "_on_card", lambda x: isinstance(x, torch.Tensor))
    a, b = _patterns(np.random.default_rng(1))[pattern]
    for x, y in ((a, b), (b, a), (a, 5)):
        out, numel, ta, wa, tb, wb, layout = gl._elementwise_plan(x, y)
        nd, words, *rest = gl._LAYOUT.unpack(layout)
        sizes, sa, sb = rest[:nd], rest[4 : 4 + nd], rest[8 : 8 + nd]
        assert 1 <= nd <= gl._MAX_DIMS and words == numel == out.numel()
        va = _walk(ta, sizes, sa) if ta is not None else wa
        vb = _walk(tb, sizes, sb) if tb is not None else wb
        if isinstance(y, int):
            assert tb is None and wb == y
        _same(gl._mul_plain(va, vb).reshape(out.shape), gl._mul_plain(x, y))


def test_sum_layout_replayed_on_the_cpu_gives_the_plain_result():
    rng = np.random.default_rng(2)
    for shape in SUM_SHAPES:
        x = _words(rng, shape)
        for t in (x, x.transpose(0, -1)):
            for axis in range(-t.ndim, t.ndim):
                out_shape, layout, n, red_stride, splits = gl._sum_layout(t.shape, t.stride(),
                                                                          axis, 132)
                nd, words, *rest = gl._LAYOUT.unpack(layout)
                walk = _walk(t, rest[:nd] + [n], rest[4 : 4 + nd] + [red_stride])
                got = gl._sum_mod_plain(walk, -1).reshape(out_shape)
                _same(got, gl._sum_mod_plain(t, axis))
                # few outputs over a long axis split it; many outputs never
                assert (splits > 0) == (n >= 256 and words < 132 * 256)


# ----------------------------------------------------------------------------
# The card: each op, byte for byte
# ----------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_ops_on_every_pair_of_edge_words(cuda_device):
    a = xnp.to_torch(np.repeat(EDGE, len(EDGE)))
    b = xnp.to_torch(np.tile(EDGE, len(EDGE)))
    ca, cb = a.to(cuda_device), b.to(cuda_device)
    for name, (op, plain) in BINARY.items():
        _same(op(ca, cb), plain(a, b))
    _same(gl.neg(ca), gl._neg_plain(a))
    for c in (0, 1, 7, 1 << 16, (1 << 32) - 1):
        _same(gl.mul_const(ca, c), gl._mul_const_plain(a, c))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["same", "lane", "outer", "zero_d", "both_zero_d", "weights",
                                     "col_slices", "col_lane", "transposed", "four_d"])
def test_card_ops_at_the_composition_patterns(cuda_device, pattern):
    a, b = _patterns(np.random.default_rng(3))[pattern]
    ca, cb = a.to(cuda_device), b.to(cuda_device)
    for name, (op, plain) in BINARY.items():
        _same(op(ca, cb), plain(a, b))
        _same(op(cb, ca), plain(b, a))
    _same(gl.neg(ca), gl._neg_plain(a))
    _same(gl.mul_const(cb, 65536), gl._mul_const_plain(b, 65536))


@pytest.mark.cuda
def test_card_ops_read_column_slices_in_place(cuda_device):
    block = _words(np.random.default_rng(4), (B + 2, 40))
    cblock = block.to(cuda_device)
    a, b = cblock[:B, 3:19], cblock[2 : B + 2, 20:36]
    assert a.stride() == (40, 1) and not a.is_contiguous()
    for name, (op, plain) in BINARY.items():
        _same(op(a, b), plain(block[:B, 3:19], block[2 : B + 2, 20:36]))
        _same(op(cblock[:B, 7, None], b), plain(block[:B, 7, None], block[2 : B + 2, 20:36]))


@pytest.mark.cuda
@pytest.mark.parametrize("scalar", range(len(HOST_SCALARS)))
def test_card_ops_with_host_scalars(cuda_device, scalar):
    s = HOST_SCALARS[scalar]
    a = _words(np.random.default_rng(5), (B, 8))
    ca = a.to(cuda_device)
    for name, (op, plain) in BINARY.items():
        _same(op(ca, s), plain(a, s))
        _same(op(s, ca), plain(s, a))
    cpu_scalar = xnp.to_torch(np.array([int(s)], dtype=np.uint64))[0]  # a 0-d CPU tensor
    assert cpu_scalar.ndim == 0
    _same(gl.mul(ca, cpu_scalar), gl._mul_plain(a, cpu_scalar))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SUM_SHAPES)
def test_card_sum_mod_along_every_axis(cuda_device, shape):
    x = _words(np.random.default_rng(6), shape)
    for t in (x, x.transpose(0, -1)):
        ct = t.to(cuda_device) if t.is_contiguous() else x.to(cuda_device).transpose(0, -1)
        for axis in range(-t.ndim, t.ndim):
            _same(gl.sum_mod(ct, axis), gl._sum_mod_plain(t, axis))


@pytest.mark.cuda
def test_card_sum_mod_of_the_largest_words_over_a_long_axis(cuda_device):
    big = xnp.to_torch(np.full((131072, 32), (1 << 64) - 1, dtype=np.uint64))
    _same(gl.sum_mod(big.to(cuda_device), 0), gl._sum_mod_plain(big, 0))
    x = _words(np.random.default_rng(7), (131072, 32))
    _same(gl.sum_mod(x.to(cuda_device), 0), gl._sum_mod_plain(x, 0))


# ----------------------------------------------------------------------------
# The card: composition blocks, one launch a field op
# ----------------------------------------------------------------------------


def _block(air, seed: int, dev, rows: int = 64):
    """A row block of random words at the AIR's trace and aux widths, and
    its _BlockEval under standard_fast_config (2 challenges), on `dev`."""
    cfg = StarkConfig.standard_fast_config("poseidon")
    nc, pad = cfg.num_challenges, cfg.fri.blowup
    aux_w = nc * (len(air.permutation_pairs()) + table_aux_width(air.lookup_tables())
                  + air.aux_extra_width())
    rng = np.random.default_rng(seed)
    tb = xnp.to_torch(rng.integers(0, P, (rows + pad, air.num_columns), dtype=np.uint64))
    zb = xnp.to_torch(rng.integers(0, P, (rows + pad, aux_w), dtype=np.uint64))
    pi = rng.integers(0, P, air.num_public_inputs, dtype=np.uint64)
    alphas = [int(v) for v in rng.integers(0, P, nc, dtype=np.uint64)]
    gammas = [int(v) for v in rng.integers(0, P, nc, dtype=np.uint64)]

    def block_eval(device):
        return composition._BlockEval(air, pi, alphas, gammas, rows, cfg, gl.GENERATOR,
                                      torch.device(device))

    return block_eval, tb, zb


class _Counted:
    """Counts the calls of the six dispatched ops, and fails any call of a
    plain version (the torch chain) on a CUDA operand."""

    NAMES = ("add", "sub", "mul", "neg", "mul_const", "sum_mod")

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in self.NAMES:
            monkeypatch.setattr(gl, name, self._counted(getattr(gl, name)))
        for name in ("_add_plain", "_sub_plain", "_mul_plain", "_neg_plain", "_mul_const_plain",
                     "_sum_mod_plain", "_reduce128"):
            monkeypatch.setattr(gl, name, self._guarded(getattr(gl, name)))

    def _counted(self, f):
        def counted(*args, **kwargs):
            self.calls += 1
            return f(*args, **kwargs)
        return counted

    @staticmethod
    def _guarded(f):
        def guarded(*args, **kwargs):
            assert not any(isinstance(x, torch.Tensor) and x.is_cuda for x in args), \
                f"{f.__name__} ran the torch chain on a CUDA operand"
            return f(*args, **kwargs)
        return guarded


@pytest.mark.cuda
@pytest.mark.parametrize("air", [G1ExpAir(1), Fq12ExpAir(1)], ids=["g1_exp_1", "fq12_exp_1"])
def test_card_composition_block_equals_the_cpu_one_launch_a_field_op(cuda_device, monkeypatch,
                                                                     air):
    block_eval, tb, zb = _block(air, 8, cuda_device)
    want = block_eval("cpu")(tb, zb, 0)
    be = block_eval(cuda_device)
    counted = _Counted(monkeypatch)
    before = gl.LAUNCHES
    got = be(tb.to(cuda_device), zb.to(cuda_device), 0)
    assert gl.LAUNCHES - before == counted.calls > 0
    _same(got, want)


@pytest.mark.cuda
def test_card_block_span_counts_its_field_launches(cuda_device, monkeypatch):
    air = G1ExpAir(1)
    cfg = StarkConfig.standard_fast_config("poseidon")
    _, tb, zb = _block(air, 9, cuda_device, rows=128)
    n = 64  # tb holds the 128 + blowup rows of an LDE of 64 rows, cyclic
    lde, z_lde = tb[:128].to(cuda_device), zb[:128].to(cuda_device)
    counted = _Counted(monkeypatch)
    rec = tm.Recorder()
    with tm.recording(rec):
        composition.evaluate_composition(air, lde, z_lde, np.zeros(air.num_public_inputs,
                                         dtype=np.uint64), [3, 5], [7, 11], n, cfg)
    blocks = [s for s in rec.spans if s.name == "block"]
    assert len(blocks) == 1
    assert blocks[0].counts["field_launches"] == counted.calls > 0


# ----------------------------------------------------------------------------
# Several cards: an op launches on its operands' card
# ----------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_ops_on_a_card_that_is_not_the_current_one(second_card):
    torch.cuda.set_device(0)
    rng = np.random.default_rng(10)
    a, b = _words(rng, (B, 8)), _words(rng, (8,))
    ca, cb = a.to(second_card), b.to(second_card)
    for name, (op, plain) in BINARY.items():
        got = op(ca, cb)
        assert got.device == second_card
        _same(got, plain(a, b))
    _same(gl.neg(ca), gl._neg_plain(a))
    _same(gl.mul_const(ca, 65536), gl._mul_const_plain(a, 65536))
    x = _words(rng, (131072, 32))  # sum_mod's split path: its scratch on the second card
    _same(gl.sum_mod(x.to(second_card), 0), gl._sum_mod_plain(x, 0))
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_card_mesh_over_the_cards_proves_the_single_card_proof(second_card):
    """FqMulAir(256) under test_config, row-sharded over every card of the
    host, gives the proof a single card gives."""
    rng = np.random.default_rng(42)
    inputs = [(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN,
               int.from_bytes(rng.bytes(40), "little") % bn254.P_BN) for _ in range(250)]
    air = FqMulAir(256)
    trace = air.generate_trace(inputs)
    cfg, no_pi = StarkConfig.test_config(), np.zeros(0, dtype=np.uint64)
    want = proof_to_bytes(prove(air, trace, no_pi, cfg, device=torch.device("cuda", 0)))
    mesh = sharded.make_mesh(torch.cuda.device_count())
    assert proof_to_bytes(prove(air, trace, no_pi, cfg, mesh=mesh)) == want
