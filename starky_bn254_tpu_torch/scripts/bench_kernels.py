"""The hot-path kernels at one shape, each beside its plain torch version
and its bound on an H100.

    python3 -m starky_bn254_tpu_torch.scripts.bench_kernels [log_rows] [cols]   # default 19 120

At [2^log_rows, cols] (the JAX package's scripts/bench_kernels.py): the
Poseidon sponge absorb (K3) of the whole chunks of a random block into a
zero state, the forward NTT (K1), the arity-4 FRI fold step on [2^(log_rows
+ 1), 2] extension values (torch ops: no hand kernel), and a whole commit
(prover.commit: K1 INTT and LDE, K3 leaves, the tree). On a card each time
is the mean of CUDA-event-timed launches after a warm-up; each kernel is
checked equal to its plain version, timed beside it, and given its bound
(utils/bounds.py: bytes over 3.35 TB/s, or its integer instructions over
the card's int32 rate, whichever is larger; the fold's from its bytes
alone). `run(..., device="cpu")` times the CPU instead, with no plain
column and no bound. Prints one JSON line per row.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import goldilocks as gl
from .. import ntt, poseidon, xnp
from ..stark import StarkConfig
from ..stark.fri import _fold_step4
from ..stark.prover import _prove_device, commit


def time_ms(fn, dev: torch.device, reps: int = 3) -> float:
    """Mean ms of fn() over reps calls after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def row(name: str, shape, ms: float, plain_ms=None, bound: dict | None = None, **extra) -> dict:
    r = dict(name=name, shape=list(shape), ms=ms, plain_ms=plain_ms, **extra)
    if bound is not None:
        r.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                 bound_share=bound["bound_ms"] / ms)
    print(json.dumps(r), flush=True)
    return r


def run(log_rows: int = 19, cols: int = 120, device=None, reps: int = 3) -> dict:
    dev = _prove_device(device)
    cuda = dev.type == "cuda"
    bounds = None
    if cuda:
        from ..utils.bounds import card_bounds

        bounds = card_bounds(dev)
    n = 1 << log_rows
    rng = np.random.default_rng(0)
    x = xnp.to_torch(rng.integers(0, gl.P, (n, cols), dtype=np.uint64), dev)
    block = x[:, : cols // poseidon.RATE * poseidon.RATE].contiguous()
    state = torch.zeros((n, poseidon.WIDTH), dtype=torch.int64, device=dev)
    rows = []

    def plain(kernel, reference, what):
        """The plain version's ms, after checking the kernel against it."""
        if not cuda:
            return None
        if not torch.equal(kernel(), reference()):
            raise AssertionError(f"bench_kernels: {what} disagrees with its plain version")
        return time_ms(reference, dev, 1)

    sponge = lambda: poseidon.sponge_absorb(state, block)  # noqa: E731
    sponge_plain = lambda: poseidon._sponge_plain(state, block, poseidon.WIDTH)  # noqa: E731
    rows.append(row("poseidon sponge_absorb", block.shape, time_ms(sponge, dev, reps),
                    plain(sponge, sponge_plain, "the sponge"),
                    bounds and bounds.poseidon(n, block.shape[1] // poseidon.RATE,
                                               block.shape[1] + poseidon.WIDTH, poseidon.WIDTH)))
    fwd = lambda: ntt.ntt(x)  # noqa: E731
    rows.append(row("ntt forward", x.shape, time_ms(fwd, dev, reps),
                    plain(fwd, lambda: ntt._ntt_plain(x), "the ntt"),
                    bounds and bounds.ntt(n, cols, False)))
    del block, state

    m = 2 * n
    fv = xnp.to_torch(rng.integers(0, gl.P, (m, 2), dtype=np.uint64), dev)
    w_m_inv = pow(gl.primitive_root_of_unity(m.bit_length() - 1), gl.P - 2, gl.P)
    s_inv = pow(gl.GENERATOR, gl.P - 2, gl.P)
    rows.append(row("fri fold4 (torch ops)", fv.shape,
                    time_ms(lambda: _fold_step4(fv, (3, 5), w_m_inv, s_inv), dev, reps), None,
                    bounds and bounds((m * 2 + m // 4 * 2) * 8, 0)))
    del fv

    cfg = StarkConfig.standard_fast_config()
    commit_ms = time_ms(lambda: commit(x, cfg).tree.cap, dev, max(reps - 1, 1))
    commit_bound = None
    if bounds is not None:  # its three kernels' bounds, summed
        parts = [bounds.ntt(n, cols, True), bounds.ntt(2 * n, cols, False),
                 bounds.poseidon(2 * n, -(-cols // poseidon.RATE), cols, 4)]
        commit_bound = dict(bound_ms=sum(p["bound_ms"] for p in parts), bound_by="kernels")
    rows.append(row("commit (INTT, LDE, leaves, tree)", x.shape, commit_ms, None, commit_bound))
    return dict(device=torch.cuda.get_device_name(dev) if cuda else str(dev), rows=rows)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    run(*(args + [19, 120][len(args):]))
