"""A kernel's least time on an NVIDIA H100: the larger of its compulsory
bytes over the card's memory rate and the integer instructions of its work
over the card's int32 rate (chip_smoke.py's kernel bounds; the bench
scripts' rooflines).

    bounds = card_bounds(torch.device("cuda", 0))
    bounds.ntt(131072, 404, inverse=False)  # {"bound_ms", "bound_by", "bytes", "int_ops"}

The work is counted in field operations, each as many SASS instructions as
its probe in csrc/sass_probes.cu (cuda_lib.sass_op_counts, which needs
nvcc and cuobjdump).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT32_LANES_PER_SM = 64


class Bounds:
    """A kernel's least time on this card: its compulsory bytes (each input
    read once, each output written once) over the HBM rate, or the integer
    instructions of the work its function needs over the int32 rate,
    whichever is larger. The work is counted in field operations (one
    multiply, one add or subtract of canonical words, one Poseidon MDS
    layer, one Keccak round), each as many instructions as its probe in
    csrc/sass_probes.cu; a kernel's own index arithmetic, loads and
    redundant operations are not work."""

    def __init__(self, sms: int, sm_clock_mhz: float, ops: dict[str, int]):
        self.int_ops_per_s = sms * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
        self.ops = ops
        mul, add = ops["probe_gl_mul"], ops["probe_add_canonical"]
        # 30 rounds of 12 round-constant adds and one MDS layer; an S-box
        # (x^7: 4 multiplies) on 12 lanes in the 8 full rounds, on 1 in the 22 partial
        self.perm = 30 * (12 * add + ops["probe_poseidon_mds"]) + (8 * 12 + 22) * 4 * mul

    def __call__(self, nbytes: float, ops: float) -> dict:
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / self.int_ops_per_s * 1e3
        return dict(bound_ms=max(by_bytes, by_ops),
                    bound_by="bytes" if by_bytes >= by_ops else "operations",
                    bytes=nbytes, int_ops=ops)

    def ntt(self, n: int, c: int, inverse: bool) -> dict:
        """n/2 * log2(n) butterflies a column, each an add and a subtract,
        and a multiply unless its twiddle is 1: the j = 0 butterfly of each
        block of each stage, n - 1 of them. The inverse's 1/n is a multiply
        a word."""
        log_n = n.bit_length() - 1
        butterflies = n // 2 * log_n
        ops = c * (butterflies * (self.ops["probe_add_canonical"] + self.ops["probe_sub_canonical"])
                   + (butterflies - (n - 1)) * self.ops["probe_gl_mul"])
        if inverse:
            ops += n * c * self.ops["probe_gl_mul"]
        return self(16 * n * c + 8 * n, ops)  # + the twiddle table

    def keccak(self, rows: int, width: int) -> dict:
        perms = width // 17 + 1  # full chunks + the padded block
        return self(8 * rows * (width + 4), rows * perms * 24 * self.ops["probe_keccak_round"])

    def poseidon(self, rows: int, perms_per_row: int, words_in: int, words_out: int) -> dict:
        return self(8 * rows * (words_in + words_out), rows * perms_per_row * self.perm)


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def card_bounds(device) -> Bounds:
    """Bounds of the card `device`: its SM count, its maximum SM clock and
    the probes' instruction counts."""
    import torch

    from .. import cuda_lib

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return Bounds(sms, max_sm_clock_mhz(), cuda_lib.sass_op_counts())
