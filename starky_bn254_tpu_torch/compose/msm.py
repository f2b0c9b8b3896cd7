"""Offset-chaining composition: the library's MSM / multi-exp recipe.

Re-derivation of the reference's composition mechanism (test_g1_msm,
src/curves/g1/circuit.rs:458-509; G2 analogue circuit.rs:392-443; Fq12
products fq12_u64/circuit.rs:437-489): Sum(x_i * s_i) is proven by wiring
instance i's `offset` to instance i-1's `output`, seeding the chain with a
known point (the generator) and subtracting it from the final output. One
STARK proof then covers the whole MSM; the chain links are plain public-input
equalities checked alongside verification.

Padding follows reference circuit.rs:273-278: repeat the last instance up to
the next power of two.

The port of the JAX package's compose/msm.py. Every `prove_*` entry point
takes `device=None` and hands it to `prove`: the CUDA card unless the caller
names another device, and an error when there is no card. The `verify_*`
entry points run on the host.
"""

from __future__ import annotations

import numpy as np

from .. import bn254
from ..airs.fq12_exp import FQ12_EXP_IO_LEN, Fq12ExpAir
from ..airs.fq12_exp_u64 import FQ12_EXP_U64_IO_LEN, Fq12ExpU64Air
from ..airs.fq_exp import FQ_EXP_IO_LEN, FqExpAir
from ..airs.g1_exp import G1_EXP_IO_LEN, G1ExpAir
from ..airs.g2_exp import G2_EXP_IO_LEN, G2ExpAir
from ..stark import StarkConfig, prove, verify
from ..utils.conversions import N_LIMBS, limbs_to_int, u32_limbs_to_int


def pad_instances(inputs: list, min_size: int = 1) -> list:
    """Pad to the next power of two >= min_size by repeating the last entry."""
    n = max(len(inputs), min_size)
    size = 1 << (n - 1).bit_length()
    return list(inputs) + [inputs[-1]] * (size - len(inputs))


def _u32s(pi, start):
    return u32_limbs_to_int([int(v) for v in pi[start : start + 8]])


def _u16s(pi, start):
    return limbs_to_int([int(v) for v in pi[start : start + N_LIMBS]])


def _g2_at(pi, base):
    """The G2 point whose 4 Fq coordinates (8 u32 limbs each) start at base."""
    vals = [_u32s(pi, base + 8 * k) for k in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


class G1Msm:
    """Prove/verify sum(s_i * P_i) on G1 with one G1ExpAir proof."""

    def build_inputs(self, points: list, scalars: list[int]):
        """Returns (air_inputs, expected_msm_result)."""
        assert len(points) == len(scalars) >= 1
        inputs = []
        offset = bn254.G1_GEN
        for p, s in zip(points, scalars):
            inputs.append((p, offset, s))
            offset = bn254.g1_add(bn254.g1_mul(p, s), offset)
        result = bn254.g1_add(offset, bn254.g1_neg(bn254.G1_GEN))
        return inputs, result

    def check_chain(self, public_inputs: np.ndarray, num_io: int, result) -> bool:
        """Verify the offset chain and the claimed MSM result against the
        public inputs of a (separately verified) proof."""
        pi = public_inputs

        def point_at(i, field):  # field: 0=x,1=offset,3=output
            base = G1_EXP_IO_LEN * i + {0: 0, 1: 16, 3: 40}[field]
            return (_u32s(pi, base), _u32s(pi, base + 8))

        if point_at(0, 1) != bn254.G1_GEN:
            return False
        for i in range(1, num_io):
            if point_at(i, 1) != point_at(i - 1, 3):
                return False
        final = point_at(num_io - 1, 3)
        return bn254.g1_add(final, bn254.g1_neg(bn254.G1_GEN)) == result


class G2Msm:
    """Prove/verify sum(s_i * P_i) on G2 with one G2ExpAir proof."""

    def build_inputs(self, points: list, scalars: list[int]):
        assert len(points) == len(scalars) >= 1
        inputs = []
        offset = bn254.G2_GEN
        for p, s in zip(points, scalars):
            inputs.append((p, offset, s))
            offset = bn254.g2_add(bn254.g2_mul(p, s), offset)
        result = bn254.g2_add(offset, bn254.g2_neg(bn254.G2_GEN))
        return inputs, result

    def check_chain(self, public_inputs: np.ndarray, num_io: int, result) -> bool:
        pi = public_inputs

        def point_at(i, field):  # 0=x, 1=offset, 3=output (4 fq each)
            return _g2_at(pi, G2_EXP_IO_LEN * i + {0: 0, 1: 32, 3: 72}[field])

        if point_at(0, 1) != bn254.G2_GEN:
            return False
        for i in range(1, num_io):
            if point_at(i, 1) != point_at(i - 1, 3):
                return False
        final = point_at(num_io - 1, 3)
        return bn254.g2_add(final, bn254.g2_neg(bn254.G2_GEN)) == result


class Fq12MultiExp:
    """Prove prod(x_i^(e_i)) in Fq12 by multiplicative offset chaining
    (reference fq12_u64/circuit.rs:437-489). Works for both the 256-bit and
    u64 exponent AIRs (io_len selects the layout)."""

    def __init__(self, u64: bool = False):
        self.u64 = u64
        self.io_len = FQ12_EXP_U64_IO_LEN if u64 else FQ12_EXP_IO_LEN

    def build_inputs(self, xs: list, exps: list[int]):
        assert len(xs) == len(exps) >= 1
        inputs = []
        offset = bn254.Fq12.one()
        for x, e in zip(xs, exps):
            inputs.append((x, offset, e))
            offset = offset * x.pow(e if not self.u64 else e % (1 << 64))
        return inputs, offset

    def check_chain(self, public_inputs: np.ndarray, num_io: int, result) -> bool:
        pi = public_inputs

        def fq12_at(i, which):  # which: 0=x, 1=offset, 2=output
            start = self.io_len * i + (
                0, 12 * N_LIMBS, 24 * N_LIMBS + (1 if self.u64 else 8))[which]
            return [_u16s(pi, start + k * N_LIMBS) % bn254.P_BN for k in range(12)]

        if fq12_at(0, 1) != bn254.Fq12.one().to_fq_list():
            return False
        for i in range(1, num_io):
            if fq12_at(i, 1) != fq12_at(i - 1, 2):
                return False
        return fq12_at(num_io - 1, 2) == result.to_fq_list()


def _prove_chain(air, inputs, cfg, device):
    trace, pi = air.generate_trace_and_pi(inputs)
    return prove(air, trace, pi, cfg, device=device)


def prove_g1_msm(points, scalars, cfg=None, range_check="auto", io_binding="auto", device=None):
    """One-call MSM proof: returns (proof, result_point, air, n_real).

    Builds the offset chain, pads to a power of two, generates the trace and
    proves it. Verify with `verify_g1_msm`."""
    cfg = cfg or StarkConfig.standard_fast_config()
    inputs, result = G1Msm().build_inputs(points, scalars)
    n_real = len(inputs)
    inputs = pad_instances(inputs)
    air = G1ExpAir(len(inputs), range_check=range_check, io_binding=io_binding)
    return _prove_chain(air, inputs, cfg, device), result, air, n_real


def verify_g1_msm(proof, result, air, n_real: int, cfg=None) -> bool:
    cfg = cfg or StarkConfig.standard_fast_config()
    if not verify(air, proof, cfg):
        return False
    return G1Msm().check_chain(proof.public_inputs, n_real, result)


def prove_g2_msm(points, scalars, cfg=None, range_check="auto", io_binding="auto", device=None):
    """One-call G2 MSM proof (offset chaining; reference g2/circuit.rs:392-443):
    returns (proof, result_point, air, n_real). Verify with `verify_g2_msm`."""
    cfg = cfg or StarkConfig.standard_fast_config()
    inputs, result = G2Msm().build_inputs(points, scalars)
    n_real = len(inputs)
    inputs = pad_instances(inputs)
    air = G2ExpAir(len(inputs), range_check=range_check, io_binding=io_binding)
    return _prove_chain(air, inputs, cfg, device), result, air, n_real


def verify_g2_msm(proof, result, air, n_real: int, cfg=None) -> bool:
    cfg = cfg or StarkConfig.standard_fast_config()
    if not verify(air, proof, cfg):
        return False
    return G2Msm().check_chain(proof.public_inputs, n_real, result)


def prove_fq12_multiexp(xs, exps, u64=False, cfg=None, range_check="auto", io_binding="auto",
                        device=None):
    """One-call Fq12 multi-exponentiation proof prod(x_i^e_i) by
    multiplicative offset chaining (reference fq12_u64/circuit.rs:437-489):
    returns (proof, result_fq12, air, n_real). u64: exponents taken mod 2^64
    (Fq12ExpU64Air, 128 rows a term) instead of 256-bit ones (Fq12ExpAir,
    512 rows a term)."""
    cfg = cfg or StarkConfig.standard_fast_config()
    inputs, result = Fq12MultiExp(u64=u64).build_inputs(xs, exps)
    n_real = len(inputs)
    inputs = pad_instances(inputs)
    if range_check == "auto":
        range_check = "logup"  # the Fq12 AIRs take "split" | "logup"
    air_cls = Fq12ExpU64Air if u64 else Fq12ExpAir
    air = air_cls(len(inputs), range_check=range_check, io_binding=io_binding)
    return _prove_chain(air, inputs, cfg, device), result, air, n_real


def verify_fq12_multiexp(proof, result, air, n_real: int, u64=False, cfg=None) -> bool:
    cfg = cfg or StarkConfig.standard_fast_config()
    if not verify(air, proof, cfg):
        return False
    return Fq12MultiExp(u64=u64).check_chain(proof.public_inputs, n_real, result)


def g2_mul_by_cofactor_input(p) -> tuple:
    """One G2ExpAir instance computing cofactor * P (reference
    g2/circuit.rs:335-367, cofactor constant :346-349). Combined with a
    map-to-curve this gives hash-to-G2."""
    return (p, bn254.G2_GEN, bn254.G2_COFACTOR)


def prove_hash_to_g2(msg: bytes, cfg=None, range_check="split", io_binding="auto", device=None):
    """End-to-end hash-to-G2 with a proven cofactor multiplication
    (reference test: src/curves/g2/circuit.rs:445-474).

    Host side: msg -> Fq2 (bn254.hash_to_g2_field) -> twist point via the
    SVDW map. Proven side: one G2ExpAir instance computing
    cofactor * P + G2_GEN. Returns (proof, mapped_point, result, air):
    result = cofactor * P is the subgroup element."""
    cfg = cfg or StarkConfig.standard_fast_config()
    p_twist = bn254.map_to_g2_svdw(bn254.hash_to_g2_field(msg))
    air = G2ExpAir(1, range_check=range_check, io_binding=io_binding)
    proof = _prove_chain(air, [g2_mul_by_cofactor_input(p_twist)], cfg, device)
    return proof, p_twist, bn254.g2_mul(p_twist, bn254.G2_COFACTOR), air


def verify_hash_to_g2(msg: bytes, proof, result, air, cfg=None) -> bool:
    """Re-derives the twist point from msg, verifies the STARK, and checks
    the public IO binds (x = mapped point, offset = G2_GEN,
    output = result + G2_GEN)."""
    cfg = cfg or StarkConfig.standard_fast_config()
    if not verify(air, proof, cfg):
        return False
    p_twist = bn254.map_to_g2_svdw(bn254.hash_to_g2_field(msg))
    pi = proof.public_inputs
    if _g2_at(pi, 0) != p_twist or _g2_at(pi, 32) != bn254.G2_GEN:
        return False
    if _g2_at(pi, 72) != bn254.g2_add(result, bn254.G2_GEN):
        return False
    # subgroup sanity: result must be r-torsion
    return bn254.g2_mul(result, bn254.R_BN) is None


def prove_fq_multiexp(xs, exps, cfg=None, range_check="auto", io_binding="auto", device=None):
    """One-call Fq multi-exponentiation proof prod(x_i^e_i) by multiplicative
    offset chaining (the Fq analogue of the reference's fq_exp_circuit
    composition, src/fields/fq/circuit.rs:240-282): returns
    (proof, result_fq, air, n_real). Verify with `verify_fq_multiexp`."""
    cfg = cfg or StarkConfig.standard_fast_config()
    assert len(xs) == len(exps) >= 1
    inputs = []
    offset = 1
    for x, e in zip(xs, exps):
        inputs.append((x, offset, e))
        offset = offset * pow(x, e, bn254.P_BN) % bn254.P_BN
    n_real = len(inputs)
    inputs = pad_instances(inputs)
    air = FqExpAir(len(inputs), range_check=range_check, io_binding=io_binding)
    return _prove_chain(air, inputs, cfg, device), offset, air, n_real


def verify_fq_multiexp(proof, result: int, air, n_real: int, cfg=None) -> bool:
    cfg = cfg or StarkConfig.standard_fast_config()
    if not verify(air, proof, cfg):
        return False
    pi = proof.public_inputs

    def fq_at(i, which):  # 0=x, 1=offset, 3=output (8 u32 limbs each)
        return _u32s(pi, FQ_EXP_IO_LEN * i + {0: 0, 1: 8, 3: 24}[which])

    if fq_at(0, 1) != 1:
        return False
    for i in range(1, n_real):
        if fq_at(i, 1) != fq_at(i - 1, 3):
            return False
    return fq_at(n_real - 1, 3) == result
