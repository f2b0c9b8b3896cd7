#!/usr/bin/env python3
"""On-card smoke run of starky_bn254_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels build from
starky_bn254_tpu_torch/csrc/ at first use). Phases, each printing its own
lines; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the three kernels, timed;
3. kernels: each kernel against its plain torch version on the same inputs
   on the card, at the main path's shapes; exact equality (all arithmetic
   is exact mod p), kernel and plain times;
4. fidelity: FqMulAir(256) under test_config (the JAX package's fixture
   statement) must reproduce tests/fixtures/fq_mul_256_test_config.npz byte
   for byte; the seed-7 digest and the keccak test-config digest pinned by
   the CPU tests must match;
5. slice: FqMulAir(65536) (812 trace + 888 permutation columns) under
   standard_fast_config("keccak"): trace generation, a first and a warm
   prove, verify, a tampered opening rejected; phase table, times, proof
   size and each kernel's launch count on this path (all must be > 0);
6. the kernel JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq_mul_256_test_config.npz")
SEED7_DIGEST = "10cb158ab61caf68"
KECCAK_DIGEST = "d9399851e8b42e5a"
SLICE_ROWS = 1 << 16

KERNELS = {  # name -> (module attribute holding the launch count, source, replaces)
    "ntt": ("ntt", "starky_bn254_tpu_torch/csrc/ntt.cu",
            "starky_bn254_tpu/pallas/ntt_kernel.py:237"),
    "keccak_sponge": ("keccak", "starky_bn254_tpu_torch/csrc/keccak.cu",
                      "starky_bn254_tpu/pallas/keccak_kernel.py:146"),
    "poseidon_sponge_and_grind": ("poseidon", "starky_bn254_tpu_torch/csrc/poseidon.cu",
                                  "starky_bn254_tpu/pallas/poseidon_kernel.py:192"),
}


def fq_inputs(seed: int, count: int, p_bn: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        (int.from_bytes(rng.bytes(40), "little") % p_bn,
         int.from_bytes(rng.bytes(40), "little") % p_bn)
        for _ in range(count)
    ]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over u64 words (0.0 when identical)."""
    from starky_bn254_tpu_torch import xnp

    if tuple(a.shape) != tuple(b.shape):
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    neq = a != b
    if not bool(neq.any()):
        return 0.0
    x = xnp.to_numpy(a[neq]).astype(object)
    y = xnp.to_numpy(b[neq]).astype(object)
    return float(max(abs(x - y)))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    return smi


def phase_build():
    from starky_bn254_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, HERE)}")


def phase_kernels(dev) -> dict:
    import numpy as np
    import torch

    from starky_bn254_tpu_torch import goldilocks as gl
    from starky_bn254_tpu_torch import keccak, ntt, poseidon, xnp

    rng = np.random.default_rng(1)

    def field(*shape):
        return xnp.to_torch(rng.integers(0, gl.P, shape, dtype=np.uint64), dev)

    out = {}

    def check(name, got, want):
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
        return err

    # K1: every main-path transform shape, both directions, plus 1-D and c = 2
    errs = []
    for shape in [(65536, 812), (131072, 888), (131072, 2), (131072,), (65536, 4)]:
        x = field(*shape)
        for inverse in (False, True):
            errs.append(check(f"ntt{shape} inverse={inverse}",
                              ntt.ntt(x, inverse), ntt._ntt_plain(x, inverse)))
            print(f"kernels: ntt {shape} inverse={inverse}: equal", flush=True)
    x = field(131072, 888)
    out["ntt"] = dict(max_abs_err=max(errs), shape=[131072, 888],
                      ms=cuda_ms(lambda: ntt.ntt(x)), plain_ms=cuda_ms(lambda: ntt._ntt_plain(x), 1))
    del x

    # K2: Merkle leaf hashing of the trace LDE
    leaves = xnp.to_torch(rng.integers(0, 1 << 64, (131072, 812), dtype=np.uint64), dev)
    err = check("keccak hash_no_pad", keccak.hash_no_pad(leaves),
                keccak._sponge_plain(None, leaves, True, keccak.DIGEST))
    out["keccak_sponge"] = dict(
        max_abs_err=err, shape=[131072, 812],
        ms=cuda_ms(lambda: keccak.hash_no_pad(leaves)),
        plain_ms=cuda_ms(lambda: keccak._sponge_plain(None, leaves, True, keccak.DIGEST), 1),
    )
    del leaves
    print("kernels: keccak hash_no_pad [131072, 812]: equal", flush=True)

    # K3: sponge absorb over 8 rate chunks, and the 16-bit grind
    state, block = field(131072, 12), field(131072, 64)
    err = check("poseidon sponge_absorb", poseidon.sponge_absorb(state, block),
                poseidon._sponge_plain(state, block, poseidon.WIDTH))
    sponge_ms = cuda_ms(lambda: poseidon.sponge_absorb(state, block))
    sponge_plain_ms = cuda_ms(lambda: poseidon._sponge_plain(state, block, poseidon.WIDTH), 1)
    print("kernels: poseidon sponge_absorb [131072, 64]: equal", flush=True)
    bits = 16
    batch, threshold = 1 << (bits + 2), 1 << (64 - bits)
    for seed in (0x1234_5678_9ABC, 0x0F0F_F0F0_1234_5678):
        start = (seed >> 24) & 0xFFFFFFFF
        got = poseidon.grind_batch(seed, start, batch, threshold, dev)
        want = poseidon._grind_plain(seed, start, batch, threshold, dev)
        if got != want:
            raise AssertionError(f"poseidon grind: kernel {got} != plain {want}")
    print("kernels: poseidon grind 16 bits: equal", flush=True)
    out["poseidon_sponge_and_grind"] = dict(
        max_abs_err=err, shape=[batch, 12],  # the grind batch's states
        ms=cuda_ms(lambda: poseidon.grind_batch(7, 0, batch, threshold, dev)),
        plain_ms=cuda_ms(lambda: poseidon._grind_plain(7, 0, batch, threshold, dev), 1),
        sponge_ms=sponge_ms, sponge_plain_ms=sponge_plain_ms,
    )
    for name, r in out.items():
        print(f"kernels: {name} {r['shape']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    print(f"kernels: poseidon sponge_absorb [131072, 64]: kernel {sponge_ms:.3f} ms, "
          f"plain {sponge_plain_ms:.3f} ms")
    torch.cuda.empty_cache()
    return out


def phase_fidelity(dev):
    import numpy as np

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import FriConfig, StarkConfig, load_proof, proof_to_bytes, prove
    from starky_bn254_tpu_torch.stark.proof import proof_digest

    air = FqMulAir(256)
    pi = np.zeros(0, dtype=np.uint64)
    cfg = StarkConfig.test_config()
    trace42 = xnp.to_torch(air.generate_trace(fq_inputs(42, 250, bn254.P_BN)), dev)
    got = proof_to_bytes(prove(air, trace42, pi, cfg))
    if got != proof_to_bytes(load_proof(FIXTURE)):
        raise AssertionError("FqMulAir(256) test_config proof differs from the fixture")
    print(f"fidelity: FqMulAir(256) test_config proof == fixture ({len(got)} bytes)")
    trace7 = xnp.to_torch(air.generate_trace(fq_inputs(7, 64, bn254.P_BN)), dev)
    d7 = proof_digest(prove(air, trace7, pi, cfg))
    if d7 != SEED7_DIGEST:
        raise AssertionError(f"seed-7 digest {d7} != {SEED7_DIGEST}")
    print(f"fidelity: seed-7 digest {d7}")
    f = cfg.fri
    kcfg = StarkConfig(num_challenges=cfg.num_challenges, fri=FriConfig(
        rate_bits=f.rate_bits, cap_height=f.cap_height, proof_of_work_bits=f.proof_of_work_bits,
        num_query_rounds=f.num_query_rounds, final_poly_bits=f.final_poly_bits,
        merkle_hash="keccak"))
    dk = proof_digest(prove(air, trace42, pi, kcfg))
    if dk != KECCAK_DIGEST:
        raise AssertionError(f"keccak test-config digest {dk} != {KECCAK_DIGEST}")
    print(f"fidelity: keccak test-config digest {dk}")


def phase_slice(dev) -> dict:
    import numpy as np
    import torch

    from starky_bn254_tpu_torch import bn254, keccak, ntt, poseidon, xnp
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import (StarkConfig, VerificationError, proof_from_bytes,
                                              proof_to_bytes, prove, verify)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon}
    air = FqMulAir(SLICE_ROWS)
    cfg = StarkConfig.standard_fast_config("keccak")
    pi = np.zeros(0, dtype=np.uint64)
    t0 = time.perf_counter()
    trace_np = air.generate_trace(fq_inputs(0, SLICE_ROWS, bn254.P_BN))
    trace = xnp.to_torch(trace_np, dev)
    tracegen_s = time.perf_counter() - t0
    print(f"slice: FqMulAir({SLICE_ROWS}) trace {tuple(trace.shape)}, "
          f"{len(air.permutation_pairs())} permutation pairs, tracegen {tracegen_s:.2f} s", flush=True)

    for m in modules.values():
        m.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prove(air, trace, pi, cfg)
    torch.cuda.synchronize()
    prove_first_s = time.perf_counter() - t0
    tt = TimingTree("prove", dev)
    t0 = time.perf_counter()
    proof = prove(air, trace, pi, cfg, timing=tt)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = verify(air, proof, cfg)
    verify_s = time.perf_counter() - t0
    launches = {name: modules[attr].LAUNCHES for name, (attr, _, _) in KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    if ok is not True:
        raise AssertionError("verify did not accept the slice proof")
    if proof.openings.trace_zeta.shape != (air.num_columns, 2):
        raise AssertionError("unexpected trace opening shape")
    bad = proof_from_bytes(proof_to_bytes(proof))
    bad.openings.trace_zeta[0, 0] ^= np.uint64(1)
    try:
        verify(air, bad, cfg)
    except VerificationError as e:
        print(f"slice: tampered opening rejected ({e})")
    else:
        raise AssertionError("a tampered opening was accepted")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    print("slice: warm prove phases")
    print(tt.render())
    size = len(proof_to_bytes(proof))
    print(f"slice: prove_first_s {prove_first_s:.3f} prove_s {prove_s:.3f} verify_s {verify_s:.3f} "
          f"tracegen_s {tracegen_s:.3f} proof_bytes {size} peak_device_GiB {peak_gib:.2f}")
    print(f"slice: launches {json.dumps(launches)}")
    return launches


def main() -> int:
    smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kernel_stats = phase_kernels(dev)
    phase_fidelity(dev)
    launches = phase_slice(dev)
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        r = kernel_stats[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
