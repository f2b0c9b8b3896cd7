"""The exp AIRs' oracle check (native.exp_oracle over csrc/oracle.cpp) on
the CPU: each instance's expected output equals the JAX package's exact
Python arithmetic (starky_bn254_tpu.bn254, which imports no jax),
g1_add(g1_mul(x, e), offset), g2_add(g2_mul(x, e), offset) and
offset * x^e over Fq12, on seeded inputs and the degenerate cases (scalars
0, 1, r - 1, r and 2^256 - 1, x * e == offset so that the addition doubles,
a result at infinity, an offset given as a value at or above p), with one
thread and with the default; an exponent outside [0, 2^256) is refused; in
each of G1ExpAir, G2ExpAir and Fq12ExpAir one flipped limb of the chain's
output fails tracegen's assertion, and the `oracle check` span counts the
instances it checked."""

import functools
import random

import numpy as np
import pytest

from starky_bn254_tpu import bn254 as jbn
from starky_bn254_tpu_torch import native
from starky_bn254_tpu_torch.airs.fq12_exp import Fq12ExpAir, fq12_limb_array
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
from starky_bn254_tpu_torch.utils import timing as tm
from starky_bn254_tpu_torch.utils.conversions import int_to_limbs

R, P = jbn.R_BN, jbn.P_BN


def _g1_limbs(points) -> np.ndarray:
    """G1 points -> [n, 2, 16] limbs."""
    return np.array([[int_to_limbs(c) for c in p] for p in points], dtype=np.uint64)


def _g2_limbs(points) -> np.ndarray:
    """G2 points -> [n, 2, 2, 16] limbs."""
    return np.array([[[int_to_limbs(v) for v in c] for c in p] for p in points], dtype=np.uint64)


def _point_cases(gen, mul, neg, seed: int, n_random: int) -> list:
    """(x, offset, e): random draws from a pool of multiples of gen, then
    the degenerate cases."""
    rng = random.Random(seed)
    pool = [mul(gen, rng.randrange(1, R)) for _ in range(6)]
    cases = []
    for _ in range(n_random):
        x, off = rng.sample(pool, 2)
        cases.append((x, off, rng.randrange(R) if rng.random() < 0.5 else rng.getrandbits(256)))
    x, off = pool[0], pool[1]
    cases += [
        (x, off, 0),  # x * e is None: the offset itself
        (x, off, 1),
        (x, off, R - 1),
        (x, off, R),  # None again
        (x, off, 2**256 - 1),
        (x, x, 1),  # x * e == offset: the addition doubles
        (x, x, R - 1),  # x * e == -offset: the result is at infinity
        (x, neg(mul(x, 5)), 5),  # at infinity
    ]
    return cases


@functools.cache
def _g1_cases() -> list:
    cases = _point_cases(jbn.G1_GEN, jbn.g1_mul, jbn.g1_neg, 14001, 22)
    x, off, e = cases[0]
    shifted = (off[0] + P, off[1])  # an offset's x given at or above p
    return cases + [(x, shifted, 0), (x, shifted, e)]  # 32 cases


@functools.cache
def _g2_cases() -> list:
    return _point_cases(jbn.G2_GEN, jbn.g2_mul, jbn.g2_neg, 14002, 2)  # 10 cases


def _fq12(rng) -> jbn.Fq12:
    return jbn.Fq12.from_fq_list([rng.randrange(P) for _ in range(12)])


@functools.cache
def _fq12_cases() -> list:
    rng = random.Random(14003)
    x, off = _fq12(rng), _fq12(rng)
    return [(x, off, 0), (x, off, 1), (x, off, rng.getrandbits(256)), (x, off, 2**256 - 1),
            (jbn.Fq12.zero(), off, 3)]


ORACLES = {  # name: (cases, limbs of values, Python's expected output)
    "oracle_g1_exp": (_g1_cases, _g1_limbs,
                      lambda x, off, e: jbn.g1_add(jbn.g1_mul(x, e), off)),
    "oracle_g2_exp": (_g2_cases, _g2_limbs,
                      lambda x, off, e: jbn.g2_add(jbn.g2_mul(x, e), off)),
    "oracle_fq12_exp": (_fq12_cases, fq12_limb_array, lambda x, off, e: off * x.pow(e)),
}


def _run(name: str):
    cases, limbs, _ = ORACLES[name]
    cs = cases()
    return native.exp_oracle(name, limbs([c[0] for c in cs]), limbs([c[1] for c in cs]),
                             [c[2] for c in cs])


@pytest.mark.parametrize("name", list(ORACLES))
def test_native_oracle_equals_the_exact_python_arithmetic(name):
    cases, limbs, python = ORACLES[name]
    got, at_infinity = _run(name)
    for i, (x, off, e) in enumerate(cases()):
        want = python(x, off, e)
        if want is None:
            assert at_infinity[i], f"case {i}: Python's result is the point at infinity"
            continue
        assert not at_infinity[i], f"case {i}"
        assert np.array_equal(got[i], limbs([want])[0]), f"case {i}: e = {e}"
    if name != "oracle_fq12_exp":
        assert at_infinity.sum() == 2  # the two cases built to land there


@pytest.mark.parametrize("name", list(ORACLES))
def test_native_oracle_is_the_same_on_one_thread(name, monkeypatch):
    monkeypatch.delenv("STARKY_NATIVE_THREADS", raising=False)
    default = _run(name)
    monkeypatch.setenv("STARKY_NATIVE_THREADS", "1")
    one = _run(name)
    assert all(np.array_equal(a, b) for a, b in zip(default, one))


@pytest.mark.parametrize("e", [2**256, 2**256 + 7, -1])
def test_an_exponent_outside_256_bits_is_refused(e):
    """The chains see an exponent's low 256 bits; Python's oracle saw all of
    it, so such an instance failed its check. The native oracle refuses it."""
    (x, off, _), *_ = _g1_cases()
    with pytest.raises(ValueError, match="outside"):
        native.exp_oracle("oracle_g1_exp", _g1_limbs([x]), _g1_limbs([off]), [e])
    with pytest.raises(ValueError, match="outside"):
        G1ExpAir(1, range_check="logup").generate_trace_and_pi([(x, off, e)])


# per AIR: two valid instances and the native chain wrapper its tracegen calls
AIRS = {
    "g1": (G1ExpAir, lambda: _g1_cases()[:2], "g1_exp_chain"),
    "g2": (G2ExpAir, lambda: _g2_cases()[:2], "g2_exp_chain"),
    "fq12": (Fq12ExpAir, lambda: _fq12_cases()[1:3], "exp_chain"),
}


@pytest.mark.parametrize("kind", list(AIRS))
def test_a_flipped_limb_of_the_chains_output_fails_tracegen(kind, monkeypatch):
    air_cls, inputs, wrapper = AIRS[kind]
    chain = getattr(native, wrapper)

    def flipped(*args, **kwargs):
        out = chain(*args, **kwargs)
        final = out[0] if isinstance(out, tuple) else out  # final x, or final b
        final.flat[0] ^= np.uint64(1)
        return out

    monkeypatch.setattr(native, wrapper, flipped)
    with pytest.raises(AssertionError, match="mismatch vs oracle"):
        air_cls(2, range_check="logup").generate_trace_and_pi(inputs())


@pytest.mark.parametrize("kind", list(AIRS))
def test_the_oracle_check_span_counts_its_instances(kind):
    air_cls, inputs, _ = AIRS[kind]
    rec = tm.Recorder("run")
    with tm.recording(rec):
        air_cls(2, range_check="logup").generate_trace_and_pi(inputs())
    (check,) = [s for s in rec.spans if s.path == "tracegen/oracle check"]
    assert check.counts == {"instances": 2}
