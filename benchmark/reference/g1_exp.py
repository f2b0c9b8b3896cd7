"""G1ExpAir's reference: the frozen AIR and each instance's public cells
(x, offset, scalar, x * scalar + offset) from exact BN254 arithmetic."""

from __future__ import annotations

import numpy as np

from .frozen import bn254
from .frozen.airs.g1_exp import G1_EXP_IO_LEN, G1ExpAir
from .frozen.utils.conversions import fq_to_u32_limbs


def air(statement: dict) -> G1ExpAir:
    return G1ExpAir(statement["num_io"], range_check=statement["range_check"],
                    io_binding=statement["io_binding"])


def public_cells(x, offset, scalar: int) -> list[int]:
    out = bn254.g1_add(bn254.g1_mul(x, scalar), offset)
    cells = []
    for v in (x[0], x[1], offset[0], offset[1], scalar % (1 << 256), out[0], out[1]):
        cells += fq_to_u32_limbs(v)
    return cells


def wrong_outputs(inputs: list, public_inputs: np.ndarray) -> int:
    """Instances whose public cells differ from the reference's (all of
    them when the proof's public inputs have the wrong length)."""
    pi = np.asarray(public_inputs, dtype=np.uint64)
    if pi.shape != (len(inputs) * G1_EXP_IO_LEN,):
        return len(inputs)
    rows = pi.reshape(len(inputs), G1_EXP_IO_LEN).tolist()
    return sum(row != public_cells(*inst) for inst, row in zip(inputs, rows))
