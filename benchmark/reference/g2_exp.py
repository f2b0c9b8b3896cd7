"""G2ExpAir's reference: the frozen AIR and each instance's public cells
(x, offset, scalar, x * scalar + offset) from exact BN254 G2 arithmetic,
each point's coordinates in the AIR's order x0, x1, y0, y1."""

from __future__ import annotations

import numpy as np

from .frozen import bn254
from .frozen.airs.g2_exp import G2_EXP_IO_LEN, G2ExpAir
from .frozen.utils.conversions import fq_to_u32_limbs


def air(statement: dict) -> G2ExpAir:
    return G2ExpAir(statement["num_io"], range_check=statement["range_check"],
                    io_binding=statement["io_binding"])


def public_cells(x, offset, scalar: int) -> list[int]:
    out = bn254.g2_add(bn254.g2_mul(x, scalar), offset)
    cells = []
    for pt in (x, offset):
        for v in (pt[0][0], pt[0][1], pt[1][0], pt[1][1]):
            cells += fq_to_u32_limbs(v)
    cells += fq_to_u32_limbs(scalar % (1 << 256))
    for v in (out[0][0], out[0][1], out[1][0], out[1][1]):
        cells += fq_to_u32_limbs(v)
    return cells


def wrong_outputs(inputs: list, public_inputs: np.ndarray) -> int:
    """Instances whose public cells differ from the reference's (all of
    them when the proof's public inputs have the wrong length)."""
    pi = np.asarray(public_inputs, dtype=np.uint64)
    if pi.shape != (len(inputs) * G2_EXP_IO_LEN,):
        return len(inputs)
    rows = pi.reshape(len(inputs), G2_EXP_IO_LEN).tolist()
    return sum(row != public_cells(*inst) for inst, row in zip(inputs, rows))
