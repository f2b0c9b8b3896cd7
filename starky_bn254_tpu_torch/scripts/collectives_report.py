"""The collectives of one sharded prove, by kind.

    python3 -m starky_bn254_tpu_torch.scripts.collectives_report [--device DEV] [fq_mul|g1 [num_io]] [shards]

Proves FqMulAir(256) (250 products, default_rng(0)) or G1ExpAir(num_io,
range_check="logup") (default 16) under test_config over a mesh of `shards`
shards (default 8), the first `shards` cards, or all on DEV when a device is
named (scaling_curve's modes), with parallel.sharded's counters reset just before, verifies
the proof, and prints a markdown table of the calls, the bytes delivered
between shards and the bytes copied between distinct devices of each
collective kind, then each sharded commit's K1 and leaf-hasher launches per
shard. The analogue of the JAX package's count of collectives in the
compiled HLO (scripts/collectives_report.py): here the single controller
issues every collective itself, so it counts them as they run.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .. import bn254
from ..parallel import sharded
from ..stark import StarkConfig, prove, verify
from .scaling_curve import mesh_of, mode_of, statement


def run(kind: str = "fq_mul", num_io: int = 16, shards: int = 8, device=None,
        cfg: StarkConfig | None = None) -> dict:
    """{"collectives": {kind: {calls, bytes, copy_bytes}}, "shard_launches":
    [...], "mesh": shards, "devices": [...]} of one prove over the mesh."""
    cfg = cfg or StarkConfig.test_config()
    mesh = mesh_of(shards, device)  # too few cards and no device named: raise before any work
    if kind == "g1":
        air, trace, pi = statement("g1", num_io)
    else:
        from ..airs.fq_mul import FqMulAir

        rng = np.random.default_rng(0)

        def fq():
            return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN

        air = FqMulAir(256)
        trace = air.generate_trace([(fq(), fq()) for _ in range(250)])
        pi = np.zeros(0, dtype=np.uint64)
    sharded.reset_counters()
    proof = prove(air, trace, pi, cfg, mesh=mesh)
    table = {k: dict(calls=sharded.CALLS[k], bytes=sharded.BYTES[k],
                     copy_bytes=sharded.COPY_BYTES[k]) for k in sharded.KINDS}
    launches = [dict(r) for r in sharded.SHARD_LAUNCHES]
    if verify(air, proof, cfg) is not True:
        raise AssertionError("collectives_report: the mesh proof was not accepted")
    print(f"{type(air).__name__} {tuple(trace.shape)} over {shards} shards "
          f"({', '.join(sorted({str(x) for x in mesh.devices}))})")
    print("| collective | calls | bytes between shards | bytes copied between devices |")
    print("|---|---|---|---|")
    for k, r in table.items():
        print(f"| `{k}` | {r['calls']} | {r['bytes']} | {r['copy_bytes']} |")
    for r in launches:
        print(f"{r['fn']} ({r['hasher']} leaves): K1 launches per shard {r['k1']}, "
              f"leaf-hash launches per shard {r['leaf']}")
    return dict(collectives=table, shard_launches=launches, mesh=shards, mode=mode_of(device),
                devices=[str(x) for x in mesh.devices])


if __name__ == "__main__":
    args = sys.argv[1:]
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
    kind = args[0] if args else "fq_mul"
    num_io = int(args[1]) if kind == "g1" and len(args) > 1 else 16
    shards = int(args[2 if kind == "g1" else 1]) if len(args) > (2 if kind == "g1" else 1) else 8
    print(json.dumps(run(kind, num_io, shards, device=device)))
