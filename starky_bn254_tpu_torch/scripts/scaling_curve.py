"""Prove time of the sharded prove against the mesh size.

    python3 -m starky_bn254_tpu_torch.scripts.scaling_curve [--device DEV] [g1_16|fq_18 ...]

Workloads (the JAX package's scripts/scaling_curve.py): g1_16, G1ExpAir(16,
range_check="logup") (8192 x 1229); fq_18, FqExpAir(512,
range_check="logup") (2^18 rows); under test_config, inputs from
default_rng(5). Each is proved once without a mesh (the d = 1 point) and
then over meshes of 2, 4 and 8 shards, first and warm, each proof verified
and held byte for byte against the first size's; each point records the
bytes its last prove's collectives moved between shards and, of those,
copied between two cards.

A run takes one of two modes, for every size alike, and each record names
it. "cards" (no device named): the mesh of d shards is the first d cards;
the run raises before any work when the host has fewer cards than the
largest size. "one_device" (`--device cuda:0`, `run(..., device=...)`):
every shard of every size sits on that one device, which measures what
sharding costs, not how it scales: the shards run one after another there,
each replaying the whole constraint evaluation over its rows ("cpu" puts
them all on the CPU). One JSON line per (workload, mesh size), with the
mode, the devices and the card's name.

    python3 -m starky_bn254_tpu_torch.scripts.scaling_curve --device cuda:0 g1_16   # one card
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import bn254, xnp
from ..parallel import sharded
from ..stark import StarkConfig, proof_to_bytes, prove, verify
from ..stark.prover import _prove_device

WORKLOADS = {"g1_16": ("g1", 16), "fq_18": ("fq", 512)}


def statement(family: str, num_io: int):
    """(air, trace, public inputs) of the workload's family at num_io."""
    rng = np.random.default_rng(5)

    def scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    if family == "g1":
        from ..airs.g1_exp import G1ExpAir

        def point():
            return bn254.g1_mul(bn254.G1_GEN, scalar())

        air = G1ExpAir(num_io, range_check="logup")
        inputs = [(point(), point(), scalar()) for _ in range(num_io)]
    elif family == "fq":
        from ..airs.fq_exp import FqExpAir

        def fq():
            return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN

        air = FqExpAir(num_io, range_check="logup")
        inputs = [(fq(), fq(), scalar()) for _ in range(num_io)]
    else:
        raise ValueError(f"unknown family {family!r}")
    trace, pi = air.generate_trace_and_pi(inputs)
    return air, trace, pi


def mesh_of(d: int, device) -> sharded.Mesh:
    """d shards: the first d cards when no device is named (make_mesh raises
    when the host has fewer), else d shards on that one device."""
    return sharded.make_mesh(d) if device is None else sharded.make_mesh(d, device=_prove_device(device))


def mode_of(device) -> str:
    return "cards" if device is None else "one_device"


def run(workloads=("g1_16", "fq_18"), sizes=(1, 2, 4, 8), device=None, num_io: int | None = None,
        repeat: int = 2, cfg: StarkConfig | None = None) -> list[dict]:
    """One record per (workload, mesh size): prove_first_s, prove_warm_s
    (the last of `repeat` proves), speedup and efficiency against the first
    size. num_io overrides the workloads' instance count."""
    cfg = cfg or StarkConfig.test_config()
    meshes = {d: mesh_of(d, device) for d in sizes if d > 1}  # too few cards: raise before any work
    dev = _prove_device(device)
    cuda = dev.type == "cuda"
    out = []
    for wl in workloads:
        family, default_io = WORKLOADS[wl]
        air, trace_np, pi = statement(family, num_io or default_io)
        trace = xnp.to_torch(trace_np, dev)
        base = first_bytes = None
        for d in sizes:
            mesh = meshes.get(d)
            times = []
            for _ in range(repeat):
                sharded.reset_counters()
                t0 = time.perf_counter()
                proof = prove(air, trace, pi, cfg, mesh=mesh, device=None if mesh else dev)
                if cuda:
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if verify(air, proof, cfg) is not True:
                raise AssertionError(f"scaling_curve: {wl} at mesh {d} was not accepted")
            first_bytes = first_bytes or proof_to_bytes(proof)
            if proof_to_bytes(proof) != first_bytes:
                raise AssertionError(f"scaling_curve: {wl} at mesh {d} differs from mesh {sizes[0]}")
            base = base or times[-1]
            rec = dict(workload=wl, rows=int(trace.shape[0]), columns=int(trace.shape[1]), mesh=d,
                       mode=mode_of(device), mesh_devices=sorted({str(x) for x in mesh.devices}) if mesh else [str(dev)],
                       prove_first_s=times[0], prove_warm_s=times[-1],
                       speedup_vs_first=base / times[-1], efficiency=base / times[-1] / d,
                       bytes_between_shards=sum(sharded.BYTES.values()),
                       bytes_copied_between_cards=sum(sharded.COPY_BYTES.values()),
                       device=torch.cuda.get_device_name(dev) if cuda else str(dev))
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
    run(args or ("g1_16", "fq_18"), device=device)
