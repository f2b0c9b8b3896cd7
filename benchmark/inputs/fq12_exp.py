"""Fq12ExpAir statements: per instance (x, offset, exponent) with output
offset * x^exponent in Fq12: random elements (twelve Fq coefficients each)
and uniform 256-bit exponents, all from the seed."""

from __future__ import annotations

import numpy as np

from reference.frozen import bn254


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *key])


def _fq12(rng: np.random.Generator) -> tuple[int, ...]:
    return tuple(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(12))


class Maker:
    def __init__(self, seed: int, num_io: int):
        self.seed, self.num_io = seed, num_io

    def request(self, stream: int, i: int) -> list:
        """The inputs of request i of a stream (0: the window, 1: warm-up)."""
        rng = _rng(self.seed, 1 + stream, i)
        return [(_fq12(rng), _fq12(rng), int.from_bytes(rng.bytes(32), "little"))
                for _ in range(self.num_io)]


def program_form(inputs: list, bn254_module) -> list:
    """The program takes its own Fq12 objects."""
    make = bn254_module.Fq12.from_fq_list
    return [(make(list(x)), make(list(off)), e) for x, off, e in inputs]
