"""One prove and verify of a heavy family under standard_fast_config (84
queries, 16 bits of proof of work).

    python3 -m starky_bn254_tpu_torch.scripts.heavy_standard_config [g2|fq12|fq12u64]

G2ExpAir(num_io), Fq12ExpAir(num_io, range_check="logup") or
Fq12ExpU64Air(num_io, range_check="logup"), num_io from HEAVY_NUM_IO
(default 4), inputs from default_rng(9) (the JAX package's
scripts/heavy_standard_config.py): tracegen, a first prove, a warm prove
with its phases, verify. On the CPU, which has no kernels to build and no
allocator to grow, one prove is both the first and the warm one. Prints
one JSON line in bench.py's schema. Runs on the current CUDA card unless
`run(..., device=)` names another.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import bn254, xnp
from ..stark import StarkConfig, prove, verify
from ..stark.prover import _prove_device
from ..utils.timing import TimingTree


def statement(family: str, num_io: int):
    """(air, inputs) of the family."""
    rng = np.random.default_rng(9)

    def scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    def fq12():
        return bn254.Fq12.from_fq_list(
            [int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(12)])

    if family == "g2":
        from ..airs.g2_exp import G2ExpAir

        return G2ExpAir(num_io), [(bn254.g2_mul(bn254.G2_GEN, scalar()),
                                   bn254.g2_mul(bn254.G2_GEN, scalar()), scalar())
                                  for _ in range(num_io)]
    if family == "fq12":
        from ..airs.fq12_exp import Fq12ExpAir

        return Fq12ExpAir(num_io, range_check="logup"), [(fq12(), fq12(), scalar())
                                                         for _ in range(num_io)]
    if family == "fq12u64":
        from ..airs.fq12_exp_u64 import Fq12ExpU64Air

        return Fq12ExpU64Air(num_io, range_check="logup"), [
            (fq12(), fq12(), int(rng.integers(0, 1 << 63))) for _ in range(num_io)]
    raise ValueError(f"unknown family {family!r}")


def run(family: str = "g2", num_io: int | None = None, cfg: StarkConfig | None = None,
        device=None) -> dict:
    """The record of `family` at num_io (default HEAVY_NUM_IO, 4)."""
    num_io = num_io or int(os.environ.get("HEAVY_NUM_IO", "4"))
    cfg = cfg or StarkConfig.standard_fast_config()
    dev = _prove_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    air, inputs = statement(family, num_io)
    t0 = time.perf_counter()
    trace_np, pi = air.generate_trace_and_pi(inputs)
    t_tracegen = time.perf_counter() - t0
    trace = xnp.to_torch(trace_np, dev)
    times = []
    for _ in range(2 if cuda else 1):
        tt = TimingTree("prove", dev)
        sync()
        t0 = time.perf_counter()
        proof = prove(air, trace, pi, cfg, timing=tt, device=dev)
        sync()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ok = verify(air, proof, cfg)
    t_verify = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"heavy_standard_config: the {family} proof was not accepted")
    return {
        "metric": f"{family}_exp_standard_config_prove_s",
        "value": times[-1],
        "unit": "s",
        "vs_baseline": 1.0,
        "detail": {
            "num_io": num_io,
            "rows": int(trace.shape[0]),
            "columns": int(trace.shape[1]),
            "config": (f"rate 1/{cfg.fri.blowup}, {cfg.fri.num_query_rounds} queries, "
                       f"{cfg.fri.proof_of_work_bits}-bit PoW, {cfg.fri.merkle_hash} leaves"),
            "trace_gen_s": t_tracegen,
            "prove_first_s": times[0],
            "instances_per_s": num_io / times[-1],
            "verify_s": t_verify,
            "phases": tt.as_dict(),
            "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        },
    }


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1] if len(sys.argv) > 1 else "g2")), flush=True)
