"""The port's field core and NTT (kernel K1's module) against the JAX
package, on the same numpy inputs, on the CPU.

The port runs its plain torch paths here; the JAX side runs its XLA path
and, for the NTT, the Pallas kernel in interpret mode. Tolerance: exact
equality (all arithmetic is exact mod p). The CUDA kernel is held against
the plain path by the `cuda`-marked test, which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starky_bn254_tpu import goldilocks as jgl
from starky_bn254_tpu import ntt as jntt
from starky_bn254_tpu.pallas import ntt_kernel as jnk
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch import ntt, xnp

P = gl.P

# one intra-op thread: test files run side by side in parallel workers, and
# torch's thread pool oversubscribes the cores (small ops get slower, not faster)
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda", 0)


_SPECIAL = np.array(
    [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
     P - (1 << 32), gl.EPSILON, 0xFFFF, 0x10000],
    dtype=np.uint64,
)


def _operands(seed: int, n: int = 1 << 12):
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), _SPECIAL, _SPECIAL[::-1],
                        np.repeat(_SPECIAL, len(_SPECIAL))])
    b = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), _SPECIAL[::-1], _SPECIAL,
                        np.tile(_SPECIAL, len(_SPECIAL))])
    return a, b


def _both_engines(f, *args):
    """The port's op on torch tensors and on numpy arrays, as numpy uint64."""
    with np.errstate(over="ignore"):
        on_np = np.asarray(f(*args), dtype=np.uint64)
    on_torch = xnp.to_numpy(f(*[xnp.to_torch(a) for a in args]))
    return on_torch, on_np


BINARY = {
    "add": (gl.add, jgl.add),
    "sub": (gl.sub, jgl.sub),
    "mul": (gl.mul, jgl.mul),
    "reduce128": (gl._reduce128, jgl._reduce128),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_match_jax(name):
    ours, ref = BINARY[name]
    a, b = _operands(1)
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b)))
    for got in _both_engines(ours, a, b):
        assert (got == want).all()


UNARY = {
    "neg": (gl.neg, jgl.neg),
    "square": (gl.square, jgl.square),
    "inv": (gl.inv, jgl.batch_inv),
    "mul_const7": (lambda x: gl.mul_const(x, 7), lambda x: jgl.mul_const(x, 7)),
    "pow_const": (lambda x: gl.pow_const(x, 0x1234567), lambda x: jgl.pow_const(x, 0x1234567)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_match_jax(name):
    ours, ref = UNARY[name]
    a, _ = _operands(2, 1 << 10)
    want = np.asarray(ref(jnp.asarray(a)))
    for got in _both_engines(ours, a):
        assert (got == want).all()


def test_mul_matches_python_ints():
    a, b = _operands(3, 256)
    got = xnp.to_numpy(gl.mul(xnp.to_torch(a), xnp.to_torch(b)))
    assert [int(v) for v in got] == [int(x) * int(y) % P for x, y in zip(a, b)]


EXT = {
    "ext_mul": (gl.ext_mul, jgl.ext_mul, 2),
    "ext_inv": (gl.ext_inv, jgl.ext_inv, 1),
    "ext_pow": (lambda x: gl.ext_pow_const(x, 1000003), lambda x: jgl.ext_pow_const(x, 1000003), 1),
}


@pytest.mark.parametrize("name", sorted(EXT))
def test_ext_ops_match_jax(name):
    ours, ref, arity = EXT[name]
    a, b = _operands(4, 510)
    xs = [a.reshape(-1, 2), b.reshape(-1, 2)][:arity]
    want = np.asarray(ref(*[jnp.asarray(x) for x in xs]))
    for got in _both_engines(ours, *xs):
        assert (got == want).all()


@pytest.mark.parametrize("name", ["sum_mod", "cumprod", "cumsum"])
def test_scans_match_jax(name):
    rng = np.random.default_rng(5)
    x = rng.integers(0, P, (300, 7), dtype=np.uint64)
    x[:12, 0] = _SPECIAL
    ours = {"sum_mod": lambda v: gl.sum_mod(v, axis=0), "cumprod": gl.cumprod,
            "cumsum": gl.cumsum}[name]
    ref = {"sum_mod": lambda v: jgl.sum_mod(v, axis=0), "cumprod": jgl.cumprod,
           "cumsum": jgl.cumsum}[name]
    want = np.asarray(ref(jnp.asarray(x)))
    for got in _both_engines(ours, x):
        assert (got == want).all()


def test_powers_vecs_match_jax():
    base = np.array([123456789123], dtype=np.uint64)
    want = np.asarray(jgl.powers_vec(jnp.asarray(base), 37))
    assert (xnp.to_numpy(gl.powers_vec(xnp.to_torch(base), 37)) == want).all()
    ext = np.array([987654321, 55555], dtype=np.uint64)
    want = np.asarray(jgl.ext_powers_vec(jnp.asarray(ext), 29))
    for got in _both_engines(lambda b: gl.ext_powers_vec(b, 29), ext):
        assert (got == want).all()


# -- NTT ----------------------------------------------------------------------


def _ntt2d_interpret(x: np.ndarray, inverse: bool) -> np.ndarray:
    """The Pallas kernel in interpret mode, with ntt.py's 128-column padding."""
    x2 = x[:, None] if x.ndim == 1 else x
    pad = (-x2.shape[1]) % 128
    out = np.asarray(jnk.ntt2d(jnp.pad(jnp.asarray(x2), ((0, 0), (0, pad))),
                               inverse=inverse, interpret=True))[:, : x2.shape[1]]
    return out[:, 0] if x.ndim == 1 else out


@pytest.mark.parametrize("shape", [(1 << 10, 130), (1 << 14, 64), (1 << 7, 1), (1 << 9,)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_matches_jax(shape, inverse):
    rng = np.random.default_rng(6)
    x = rng.integers(0, P, shape, dtype=np.uint64)
    x.reshape(-1)[: len(_SPECIAL)] = _SPECIAL
    got = xnp.to_numpy(ntt.ntt(xnp.to_torch(x), inverse=inverse))
    assert (got == np.asarray(jntt._ntt_xla(jnp.asarray(x), inverse=inverse))).all()
    if shape[0] <= 1 << 10:  # the interpreted Pallas kernel is slow on the CPU
        assert (got == _ntt2d_interpret(x, inverse)).all()


def test_ntt_matches_pallas_kernel_at_2_14():
    rng = np.random.default_rng(7)
    x = rng.integers(0, P, (1 << 14, 64), dtype=np.uint64)
    got = xnp.to_numpy(ntt.ntt(xnp.to_torch(x)))
    assert (got == _ntt2d_interpret(x, False)).all()


def test_lde_and_coset_interpolation_match_jax():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, P, (256, 5), dtype=np.uint64)
    want = np.asarray(jntt.coset_lde(jnp.asarray(vals), 1))
    assert (xnp.to_numpy(ntt.coset_lde(xnp.to_torch(vals), 1)) == want).all()
    coeffs = rng.integers(0, P, (64, 3), dtype=np.uint64)
    want = np.asarray(jntt.lde_from_coeffs(jnp.asarray(coeffs), 2, 7))
    assert (xnp.to_numpy(ntt.lde_from_coeffs(xnp.to_torch(coeffs), 2, 7)) == want).all()
    want = np.asarray(jntt.interpolate_coset(jnp.asarray(vals), 7))
    assert (xnp.to_numpy(ntt.interpolate_coset(xnp.to_torch(vals), 7)) == want).all()


def test_eval_from_lde_matches_jax():
    rng = np.random.default_rng(9)
    lde = rng.integers(0, P, (512, 11), dtype=np.uint64)
    point = tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64))
    xs_ext = jgl.ext_from_base(jnp.asarray(jntt._coset_points(7, 512)))
    pt = jnp.asarray(np.array(point, dtype=np.uint64))
    inv_den = np.asarray(jgl.ext_inv(jgl.ext_sub(xs_ext, pt)))
    want = np.asarray(jntt.eval_from_lde(jnp.asarray(lde), point, jnp.asarray(inv_den)))
    got = ntt.eval_from_lde(xnp.to_torch(lde), point, xnp.to_torch(inv_den))
    assert (xnp.to_numpy(got) == want).all()


def test_eval_poly_ext_matches_jax():
    rng = np.random.default_rng(10)
    coeffs = rng.integers(0, P, (40, 3), dtype=np.uint64)
    pt = np.array([5, 9], dtype=np.uint64)
    want = np.asarray(jntt.eval_poly_ext(jnp.asarray(coeffs), jnp.asarray(pt)))
    assert (xnp.to_numpy(ntt.eval_poly_ext(xnp.to_torch(coeffs), pt)) == want).all()


def test_ntt_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((12, 2), dtype=torch.int64))


# -- kernel K1's pass plan, replayed on the CPU --------------------------------


def _ntt_by_passes(values: torch.Tensor, inverse: bool, t=None) -> torch.Tensor:
    """K1 as csrc/ntt.cu runs it, in torch ops: for each pass of
    ntt._pass_plan, every tile (NttPass.tile_rows x one column slab) is
    loaded (the first pass from the bit-reversed rows of `values`, any row
    stride, times 1/n for the inverse), runs the pass's stages with the
    pass's twiddle table (_pass_twiddles, read at NttPass.twiddle_index),
    and is stored back. Tiles are batched over the row groups."""
    squeeze = values.ndim == 1
    x = values[:, None] if squeeze else values
    n, c = x.shape
    log_n = ntt._log2_exact(n)
    rev = torch.from_numpy(ntt._bit_reversal(log_n))
    out = torch.empty((n, c), dtype=torch.int64)
    for k, p in enumerate(ntt._pass_plan(log_n, c, t)):
        tw = xnp.to_torch(ntt._pass_twiddles(log_n, inverse, p.s_lo, p.s_hi))
        rows_np = p.tile_rows(np.arange(p.n_groups(log_n)))  # [groups, G, R]
        rows = torch.from_numpy(rows_np)
        lo = rows_np[:, :1, :] & ((1 << p.s_lo) - 1)  # [groups, 1, R]
        groups, g_rows, r_res = rows.shape
        width = 1 << p.log_w
        for col0 in range(0, c, width):
            cols = torch.arange(col0, min(col0 + width, c))
            if k == 0:
                tile = x[rev[rows][..., None], cols]
                if inverse:
                    tile = gl.mul(tile, pow(n, P - 2, P))
            else:
                tile = out[rows[..., None], cols]
            w = len(cols)
            for s in range(p.s_lo, p.s_hi):
                m = 1 << (s - p.s_lo)
                tv = tile.reshape(groups, g_rows // (2 * m), 2, m, r_res, w)
                idx = p.twiddle_index(s, np.arange(m)[None, :, None], lo)  # [groups, m, R]
                bw = gl.mul(tv[:, :, 1], tw[torch.from_numpy(idx)][:, None, :, :, None])
                tile = torch.stack([gl.add(tv[:, :, 0], bw), gl.sub(tv[:, :, 0], bw)], dim=2)
                tile = tile.reshape(groups, g_rows, r_res, w)
            out[rows[..., None], cols] = tile
    return out[:, 0] if squeeze else out


# (n, c or None for 1-D, t or None for the default, row stride or None)
PASS_CASES = {
    "n2_c1": (2, 1, None, None),
    "n64_c3_t2": (1 << 6, 3, 2, None),
    "n1024_c130_t4": (1 << 10, 130, 4, None),
    "n512_1d_t4": (1 << 9, None, 4, None),
    "n32_c7_t6_one_pass": (1 << 5, 7, 6, None),
    "n256_c5_t3_stride9": (1 << 8, 5, 3, 9),
}


def _pass_case_input(name: str) -> torch.Tensor:
    n, c, _, stride = PASS_CASES[name]
    rng = np.random.default_rng(13)
    full = rng.integers(0, P, (n, stride or c or 1), dtype=np.uint64)
    full.reshape(-1)[: min(full.size, len(_SPECIAL))] = _SPECIAL[: full.size]
    x = xnp.to_torch(full)
    if c is None:
        return x[:, 0]
    return x[:, 2 : 2 + c] if stride else x


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_ntt_pass_plan_matches_jax(case, inverse):
    x = _pass_case_input(case)
    t = PASS_CASES[case][2]
    got = _ntt_by_passes(x, inverse, t)
    want = np.asarray(jntt.ntt(jnp.asarray(xnp.to_numpy(x)), inverse=inverse))
    assert (xnp.to_numpy(got) == want).all()
    log_n = x.shape[0].bit_length() - 1
    c = 1 if x.ndim == 1 else x.shape[1]
    passes = ntt._pass_plan(log_n, c, t)
    assert len(passes) == max(1, -(-log_n // (t or log_n or 1)))
    if x.shape[0] <= 1 << (t or log_n):
        assert len(passes) == 1


@pytest.mark.parametrize("shape", [(1 << 16, 812), (1 << 17, 812), (1 << 16, 888), (1 << 17, 888),
                                   (1 << 17, 2), (1 << 16, 4), (1 << 17, 1), (1 << 20, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ntt_pass_plan_two_passes_at_main_path_shapes(shape):
    """Every main-path shape (and [2^20, 4]) takes two passes, with no
    separate bit-reversal launch: the stages split without gap or overlap,
    each tile fits TILE_WORDS, each twiddle index stays inside its table,
    and the tiles of a pass cover every row once."""
    n, c = shape
    log_n = n.bit_length() - 1
    passes = ntt._pass_plan(log_n, c)
    assert len(passes) == 2
    assert passes[0].s_lo == 0 and passes[-1].s_hi == log_n
    for a, b in zip(passes, passes[1:]):
        assert a.s_hi == b.s_lo
    for p in passes:
        assert p.log_r <= p.s_lo
        assert 1 << (p.log_tile_rows + p.log_w) <= ntt.TILE_WORDS
        size = (1 << p.s_hi) - (1 << p.s_lo)
        m_last = 1 << (p.s_hi - 1 - p.s_lo)
        assert p.twiddle_index(p.s_hi - 1, m_last - 1, (1 << p.s_lo) - 1) == size - 1
    last = passes[-1]
    rows = last.tile_rows(np.arange(last.n_groups(log_n)))
    assert np.array_equal(np.sort(rows.reshape(-1)), np.arange(n))


def test_pass_twiddles_are_the_stage_twiddles():
    log_n = 7
    for inverse in (False, True):
        stages = ntt._stage_twiddles(log_n, inverse)
        for p in ntt._pass_plan(log_n, 3, 3):
            tab = ntt._pass_twiddles(log_n, inverse, p.s_lo, p.s_hi)
            for s in range(p.s_lo, p.s_hi):
                j = np.arange(1 << s)
                idx = p.twiddle_index(s, j >> p.s_lo, j & ((1 << p.s_lo) - 1))
                assert (tab[idx] == stages[s]).all()


@pytest.mark.cuda
def test_ntt_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    for shape in [(1,), (2,), (1 << 10,), (1 << 12, 1), (1 << 12, 2), (1 << 13, 130),
                  (1 << 17, 888), (1 << 20, 4)]:
        x = xnp.to_torch(rng.integers(0, P, shape, dtype=np.uint64)).to(cuda_device)
        for inverse in (False, True):
            assert torch.equal(ntt.ntt(x, inverse), ntt._ntt_plain(x, inverse))
    wide = xnp.to_torch(rng.integers(0, P, (1 << 16, 900), dtype=np.uint64)).to(cuda_device)
    view = wide[:, 5:817]  # a column slice: row stride 900, no copy
    for inverse in (False, True):
        assert torch.equal(ntt.ntt(view, inverse), ntt._ntt_plain(view.contiguous(), inverse))
    for case in sorted(PASS_CASES):
        x = _pass_case_input(case)
        for inverse in (False, True):
            got = ntt._ntt_cuda(x.to(cuda_device), inverse, PASS_CASES[case][2]).cpu()
            assert torch.equal(got, _ntt_by_passes(x, inverse, PASS_CASES[case][2]))
            assert torch.equal(got, ntt._ntt_plain(x, inverse))
