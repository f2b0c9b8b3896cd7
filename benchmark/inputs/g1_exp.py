"""G1ExpAir statements: per instance (x, offset, scalar) with output
x * scalar + offset on BN254 G1.

x and offset come from a pool of points made once per run from the seed
(a pure-Python scalar multiplication takes milliseconds, so points made per
request would dominate set-up); each request draws its points from the pool
and fresh scalars, uniform below the group order, so the double-and-add
work follows their bits. An instance's x and offset are two different
points of the pool: the AIR's addition is incomplete, and x = offset makes
its first addition one of a point with itself, which it cannot prove."""

from __future__ import annotations

import numpy as np

from reference.frozen import bn254

POOL_POINTS = 64


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *key])


def _scalar(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN


class Maker:
    def __init__(self, seed: int, num_io: int):
        self.seed, self.num_io = seed, num_io
        rng = _rng(seed, 0)
        self.pool = [bn254.g1_mul(bn254.G1_GEN, _scalar(rng)) for _ in range(POOL_POINTS)]

    def request(self, stream: int, i: int) -> list:
        """The inputs of request i of a stream (0: the window, 1: warm-up)."""
        rng = _rng(self.seed, 1 + stream, i)
        n = len(self.pool)
        xs = rng.integers(0, n, size=self.num_io)
        offs = (xs + rng.integers(1, n, size=self.num_io)) % n  # never x's own point
        return [(self.pool[a], self.pool[b], _scalar(rng)) for a, b in zip(xs, offs)]


def program_form(inputs: list, bn254_module) -> list:
    """Points are (x, y) int tuples on both sides."""
    return inputs
