"""G2ExpAir statements: per instance (x, offset, scalar) with output
x * scalar + offset on BN254 G2, points as ((x0, x1), (y0, y1)) Fq2 pairs.

Drawn as G1's statements are (inputs/g1_exp.py): x and offset from a pool
of G2 points made once per run from the seed, two different points of the
pool per instance (the AIR's addition is incomplete, as G1's is), and a
fresh scalar uniform below the group order."""

from __future__ import annotations

from inputs import g1_exp
from reference.frozen import bn254

program_form = g1_exp.program_form


class Maker(g1_exp.Maker):
    def __init__(self, seed: int, num_io: int):
        self.seed, self.num_io = seed, num_io
        rng = g1_exp._rng(seed, 0)
        self.pool = [bn254.g2_mul(bn254.G2_GEN, g1_exp._scalar(rng))
                     for _ in range(g1_exp.POOL_POINTS)]
