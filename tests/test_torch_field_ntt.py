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


@pytest.mark.cuda
def test_ntt_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    for shape in [(1,), (2,), (1 << 10,), (1 << 12, 1), (1 << 12, 2), (1 << 13, 130)]:
        x = xnp.to_torch(rng.integers(0, P, shape, dtype=np.uint64))
        for inverse in (False, True):
            want = ntt._ntt_plain(x, inverse)
            assert torch.equal(ntt.ntt(x.to(cuda_device), inverse).cpu(), want)
