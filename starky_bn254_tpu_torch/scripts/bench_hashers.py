"""Merkle leaf hashing, Poseidon (K3) against Keccak (K2), at one shape.

    python3 -m starky_bn254_tpu_torch.scripts.bench_hashers [log2_rows] [cols]   # default 17 404

[2^17, 404] is the G1ExpAir(128) trace LDE's leaves (the JAX package's
scripts/bench_hashers.py). Per hasher: hash_or_noop's mean time (CUDA events
on a card), cells and permutations per second, and on a card its bound
(utils/bounds.py) and share of it. `run(..., device="cpu")` times the CPU
instead, with no bound. Prints one JSON line per hasher.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import xnp
from ..hashing import get_hasher
from ..stark.prover import _prove_device
from .bench_kernels import time_ms


def run(log_rows: int = 17, cols: int = 404, device=None, reps: int = 3) -> list[dict]:
    dev = _prove_device(device)
    cuda = dev.type == "cuda"
    bounds = None
    if cuda:
        from ..utils.bounds import card_bounds

        bounds = card_bounds(dev)
    n = 1 << log_rows
    x = xnp.to_torch(np.random.default_rng(0).integers(0, 1 << 63, size=(n, cols), dtype=np.uint64),
                     dev)
    out = []
    for name in ("keccak", "poseidon"):
        h = get_hasher(name)
        ms = time_ms(lambda: h.hash_or_noop(x), dev, reps)
        perms = -(-cols // h.RATE) + (1 if name == "keccak" else 0)
        rec = dict(hasher=name, shape=[n, cols], ms=ms, cells_per_s=n * cols / ms * 1e3,
                   perm_per_s=n * perms / ms * 1e3,
                   device=torch.cuda.get_device_name(dev) if cuda else str(dev))
        if bounds is not None:
            b = bounds.keccak(n, cols) if name == "keccak" else bounds.poseidon(n, perms, cols, 4)
            rec.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"], bound_share=b["bound_ms"] / ms)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    run(*(args + [17, 404][len(args):]))
