"""Fq12ExpAir's reference: the frozen AIR and each instance's public cells
(x, offset, exponent, offset * x^exponent) from exact Fq12 arithmetic."""

from __future__ import annotations

import numpy as np

from .frozen import bn254
from .frozen.airs.fq12_exp import FQ12_EXP_IO_LEN, Fq12ExpAir, fq12_limb_array
from .frozen.utils.conversions import fq_to_u32_limbs


def air(statement: dict) -> Fq12ExpAir:
    return Fq12ExpAir(statement["num_io"], range_check=statement["range_check"],
                      io_binding=statement["io_binding"])


def public_cells(x, offset, exponent: int) -> list[int]:
    fx, foff = bn254.Fq12.from_fq_list(list(x)), bn254.Fq12.from_fq_list(list(offset))
    out = foff * fx.pow(exponent)
    return (fq12_limb_array([fx, foff]).reshape(-1).tolist() + fq_to_u32_limbs(exponent % (1 << 256))
            + fq12_limb_array([out]).reshape(-1).tolist())


def wrong_outputs(inputs: list, public_inputs: np.ndarray) -> int:
    """Instances whose public cells differ from the reference's (all of
    them when the proof's public inputs have the wrong length)."""
    pi = np.asarray(public_inputs, dtype=np.uint64)
    if pi.shape != (len(inputs) * FQ12_EXP_IO_LEN,):
        return len(inputs)
    rows = pi.reshape(len(inputs), FQ12_EXP_IO_LEN).tolist()
    return sum(row != public_cells(*inst) for inst, row in zip(inputs, rows))
