"""BN254 AIRs: Fq multiplication, Fq and Fq12 exponentiation (256-bit and
u64 exponents), G1 and G2 scalar multiplication."""

from .fq12_exp import Fq12ExpAir
from .fq12_exp_u64 import Fq12ExpU64Air
from .fq_exp import FqExpAir
from .fq_mul import FqMulAir
from .g1_exp import G1ExpAir
from .g2_exp import G2ExpAir

__all__ = ["FqMulAir", "FqExpAir", "Fq12ExpAir", "Fq12ExpU64Air", "G1ExpAir", "G2ExpAir"]
