"""Where a warm prove's wall clock goes, function by function.

    python3 -m starky_bn254_tpu_torch.scripts.profile_prove [num_io]   # G1ExpAir, default 128

Proves G1ExpAir(num_io) (inputs from default_rng(0)) under
standard_fast_config() once cold and once warm (on the CPU, which has no
kernels to build and no allocator to grow, one prove is both), then once
more with the transcript, selector, opening, commit, grind and composition
entry points wrapped in cumulative timers, and prints the timers (largest first) and the
TimingTree of that prove (the JAX package's scripts/profile_prove.py). On a
card every timer and every scope boundary synchronizes the card, so each
function's time includes the device work it launched. Runs on the current
CUDA card unless `run(..., device=)` names another.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np
import torch

from .. import bn254, merkle, ntt, xnp
from .. import challenger as chmod
from ..airs.g1_exp import G1ExpAir
from ..stark import StarkConfig, fri, prove
from ..stark import prover as pmod
from ..stark.prover import _prove_device
from ..utils.timing import TimingTree

# (owner, attribute, label): each looked up on its owner when it is called
TIMED = [(chmod.Challenger, name, f"challenger.{name}")
         for name in ("observe_cap", "observe_elements", "get_n_challenges", "get_ext_challenge",
                      "get_indices")]
TIMED += [(pmod, "_ext_inv_x_minus", "prover.inv_x_minus"),
          (pmod, "compute_z_columns", "prover.z_columns"),
          (pmod, "_batch_opening_poly", "prover.batch_open_poly"),
          (pmod, "_lde_selectors", "prover.lde_selectors"),
          (pmod, "compute_logup_columns", "logup.columns"),
          (pmod, "evaluate_composition", "composition.eval"),
          (ntt, "eval_from_lde", "ntt.eval_from_lde"),
          (ntt, "interpolate_coeffs", "ntt.interpolate_coeffs"),
          (ntt, "interpolate_coset", "ntt.interpolate_coset"),
          (ntt, "lde_from_coeffs", "ntt.lde_from_coeffs"),
          (merkle, "build_merkle_tree", "merkle.build_tree"),
          (fri, "grind", "fri.grind")]


def g1_inputs(num_io: int) -> list[tuple]:
    rng = np.random.default_rng(0)

    def scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [(bn254.g1_mul(bn254.G1_GEN, scalar()), bn254.g1_mul(bn254.G1_GEN, scalar()), scalar())
            for _ in range(num_io)]


def run(num_io: int = 128, cfg: StarkConfig | None = None, device=None) -> dict:
    """The record: first_s, warm_s, instrumented_s, functions {label: ms},
    phases (TimingTree.as_dict())."""
    cfg = cfg or StarkConfig.standard_fast_config()
    dev = _prove_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    air = G1ExpAir(num_io)
    trace_np, pi = air.generate_trace_and_pi(g1_inputs(num_io))
    trace = xnp.to_torch(trace_np, dev)
    rec = dict(num_io=num_io, rows=int(trace.shape[0]), columns=int(trace.shape[1]),
               merkle_hash=cfg.fri.merkle_hash,
               device=torch.cuda.get_device_name(dev) if cuda else str(dev))
    times = []
    for _ in range(2 if cuda else 1):
        sync()
        t0 = time.perf_counter()
        prove(air, trace, pi, cfg, device=dev)
        sync()
        times.append(time.perf_counter() - t0)
    rec["first_s"], rec["warm_s"] = times[0], times[-1]

    totals: dict[str, float] = {}
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in TIMED]

    def timed(fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            totals[label] = totals.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return wrapper

    for (owner, name, label), (_, _, fn) in zip(TIMED, saved):
        setattr(owner, name, timed(fn, label))
    try:
        tt = TimingTree("prove", dev)
        t0 = time.perf_counter()
        prove(air, trace, pi, cfg, timing=tt, device=dev)
        sync()
        rec["instrumented_s"] = time.perf_counter() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    rec["functions"] = dict(sorted(totals.items(), key=lambda kv: -kv[1]))
    rec["phases"] = tt.as_dict()
    for label, ms in rec["functions"].items():
        print(f"{label:32s} {ms:10.1f} ms")
    return rec


if __name__ == "__main__":
    print(json.dumps(run(int(sys.argv[1]) if len(sys.argv) > 1 else 128)))
