#!/usr/bin/env python3
"""On-card smoke run of starky_bn254_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels build from
starky_bn254_tpu_torch/csrc/ at first use). Phases, each printing its own
lines; any failure raises and the exit code is non-zero:

1. device: the card's name, power limit and maximum SM clock (nvidia-smi);
2. build: the three kernels, one nvcc per source side by side, and the
   native witness generator (g++ on native/witness.cpp) beside them, each
   timed; ptxas's registers and spills for every kernel entry (a K3 entry
   that spills fails the run); the integer instructions of each unit of
   work the bounds count (a Goldilocks multiply, an add and a subtract of
   canonical words, a Poseidon MDS layer, a Keccak round) and of a whole
   K1 butterfly and K3 round as the kernels run them, counted in the SASS
   of csrc/sass_probes.cu (cuobjdump);
3. kernels: each kernel against its plain torch version on the same inputs
   on the card, at every path's shapes (FqMulAir's, and G1ExpAir(128)'s,
   FqExpAir(128)'s, G2ExpAir(128)'s, Fq12ExpAir(128)'s and
   Fq12ExpU64Air(512)'s: K2 at the leaf widths of the keccak paths, K3 at
   those of the Poseidon paths);
   exact equality (all arithmetic is exact mod p); kernel and plain times;
   each kernel's bound, the larger of its compulsory bytes over the HBM
   rate and the integer instructions of the work its function needs over
   the int32 rate (SMs x 64 lanes x the maximum SM clock), and which of the
   two it is. K3 also runs at the challenger's shapes, in both state
   layouts and under a dense-MDS parameter set, and a row sweep times the
   two layouts against each other (the crossover behind
   poseidon.COOP_MAX_ROWS);
4. fidelity: FqMulAir(256) under test_config must reproduce
   tests/fixtures/fq_mul_256_test_config.npz byte for byte, and
   G1ExpAir(2, logup, rlc) under test_config
   tests/fixtures/g1_exp_2_rlc_test_config.npz (both made by the JAX
   package), and likewise FqExpAir(2, logup, rlc), G2ExpAir(1, logup, rlc),
   Fq12ExpAir(1, logup, rlc) and the two-term prove_fq12_multiexp(u64=True)
   (Fq12ExpU64Air(2, logup, rlc)) against their fixtures; the seed-7 digest
   and the keccak test-config digest pinned by the CPU tests must match;
5. slice: FqMulAir(65536) (812 trace + 888 permutation columns) under
   standard_fast_config("keccak"): trace generation, a first prove through
   `prove`'s default device (the card) with every kernel's launch count
   reset just before and read just after (all must be > 0), WARM_PROVES
   warm proves (median time and phase table), verify, a tampered opening
   rejected, then torch.profiler over one more warm prove: device busy
   share and kernel time by name;
6. g1, the bench's main path: G1ExpAir(128) (65536 x 404 trace, logup_u16
   range check, RLC IO binding: 390 aux columns) under
   standard_fast_config("keccak"), inputs as bench.py makes them: tracegen
   cold and warm, a first prove with the launch counts reset and read as
   in 5, G1_WARM_PROVES warm proves (median and phase table, with the
   logup and rlc aux sub-phases), verify, a tampered opening and an
   instance-swapped proof rejected, the profile of one more warm prove, the
   logUp column build by both routes (equal, each timed), and one prove
   under standard_fast_config("poseidon"), verified;
7. fq, the bench's second statement (STARKY_BENCH_AIR=fq): FqExpAir(128)
   (65536 x 164 trace, 152 aux columns) under the keccak config, inputs as
   bench.py makes them: tracegen cold and warm, the steps of 6 (first
   prove with launch counts, warm proves, verify, tampered and
   instance-swapped proofs rejected);
8. g2: G2ExpAir(128) (65536 x 788 trace, 770 aux columns), inputs
   g2_mul(G2_GEN, scalar) from default_rng(0): the steps of 7, peak device
   memory, the profile of one warm prove and the composition probe (one
   more warm prove: the row blocks, the kernel launches and the peak device
   memory of the constraint composition, as live int64 words per committed
   cell of a block);
9. g1-pipelined, the bench's service tier (bench.py:196-236): four
   G1ExpAir(128) batches, each from its own seed, through prove_pipelined
   with the launch counts reset and read around it; each proof must equal
   the bytes of a sequential prove of its batch and verify; the steady and
   fill rates beside the serial num_io / (tracegen + prove) of the same
   batches;
10. fq12: the Fq12 multi-exponentiation entry point,
   prove_fq12_multiexp(xs, exps) with 128 terms under its default config
   (standard_fast_config(), Poseidon leaves), which proves Fq12ExpAir(128)
   (65536 x 4412 trace, 2672 aux columns): tracegen cold and warm, the
   entry point's call with the launch counts reset and read around it (its
   proof must equal the warm prove's bytes), FQ12_WARM_PROVES warm proves
   (phase table), verify_fq12_multiexp true, and false for a wrong result,
   a tampered opening and an instance-swapped proof rejected, the rlc aux
   phase's whole-trace copy to the host timed, peak device memory, the
   profile of one more prove (its wall clock against the unprofiled warm
   prove: the profiler's overhead) and the composition probe;
11. fq12-u64: the same through prove_fq12_multiexp(u64=True) with 512
   terms (exponents below 2^63) under standard_fast_config("keccak"), which
   proves Fq12ExpU64Air(512) (65536 x 4402 trace, 2672 aux columns), with
   a profile;
12. msm: prove_g1_msm / verify_g1_msm over 128 points (the result equal to
   the host oracle's sum) and prove_hash_to_g2 / verify_hash_to_g2 on one
   message, each under its default config, with the launch counts reset
   just before and read just after each of the two entry points (each
   path's kernels checked on its own count);
13. the kernel JSON line, the card's line, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq_mul_256_test_config.npz")
G1_FIXTURE = os.path.join(HERE, "tests", "fixtures", "g1_exp_2_rlc_test_config.npz")
G1_FIXTURE_SEED = 2026  # tests/test_torch_g1_e2e.py: the fixture's pinned inputs
FQ_EXP_FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq_exp_2_rlc_test_config.npz")
G2_FIXTURE = os.path.join(HERE, "tests", "fixtures", "g2_exp_1_rlc_test_config.npz")
FQ12_FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq12_exp_1_rlc_test_config.npz")
FQ12_U64_FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq12_exp_u64_2_rlc_test_config.npz")
FQ12_U64_FIXTURE_SEED = 2027  # tests/test_torch_fq12_u64_e2e.py: the fixture's pinned terms
SEED7_DIGEST = "10cb158ab61caf68"
KECCAK_DIGEST = "d9399851e8b42e5a"
SLICE_ROWS = 1 << 16
WARM_PROVES = 3  # the slice's prove_s is their median
G1_NUM_IO = 128  # bench.py's default: 65536 rows
G1_SHAPES = ((1 << 16, 404), 390)  # its trace and its aux columns, uncut
G1_WARM_PROVES = 3  # the g1 phase's prove_s is their median
FQ_EXP_SHAPES = ((1 << 16, 164), 152)
G2_SHAPES = ((1 << 16, 788), 770)
EXP_WARM_PROVES = 3  # the fq and g2 phases' prove_s is their median
PIPE_BATCHES = 4  # bench.py's n_pipe
FQ12_NUM_IO = 128  # Fq12ExpAir(128): 128 terms x 512 rows
FQ12_SHAPES = ((1 << 16, 4412), 2672)
FQ12_U64_NUM_IO = 512  # Fq12ExpU64Air(512): 512 terms x 128 rows
FQ12_U64_SHAPES = ((1 << 16, 4402), 2672)
FQ12_WARM_PROVES = 1  # ~18-20 s each: one keeps the whole run well inside its limit
MSM_POINTS = 128
# K1 shapes of each exp path: its trace and aux columns (inverse at 65536
# rows, forward LDE at 131072); its leaves (131072 rows of each width) are
# hashed by K2 on the keccak paths and by K3 on the Poseidon path (fq12)
PATH_WIDTHS = {"g1": (404, 390), "fq": (164, 152), "g2": (788, 770), "fq12": (4412, 2672),
               "fq12_u64": (4402, 2672)}
KECCAK_PATHS = ("g1", "fq", "g2", "fq12_u64")
POSEIDON_PATHS = ("fq12",)
NARROW_NTT_SHAPES = [(131072, 2), (131072,), (65536, 4)]  # quotient and FRI final poly
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT32_LANES_PER_SM = 64

KERNELS = {  # name -> (module attribute holding the launch count, source, replaces)
    "ntt": ("ntt", "starky_bn254_tpu_torch/csrc/ntt.cu",
            "starky_bn254_tpu/pallas/ntt_kernel.py:237"),
    "keccak_sponge": ("keccak", "starky_bn254_tpu_torch/csrc/keccak.cu",
                      "starky_bn254_tpu/pallas/keccak_kernel.py:146"),
    "poseidon_sponge_and_grind": ("poseidon", "starky_bn254_tpu_torch/csrc/poseidon.cu",
                                  "starky_bn254_tpu/pallas/poseidon_kernel.py:192"),
}
# kernel names in the profiler's trace, by the kernel they belong to
TRACE_NAMES = {"ntt": ("ntt_pass_kernel",), "keccak_sponge": ("keccak_sponge_kernel",),
               "poseidon_sponge_and_grind": ("poseidon_sponge_kernel", "poseidon_coop_kernel",
                                             "poseidon_grind_kernel")}


def fq_inputs(seed: int, count: int, p_bn: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        (int.from_bytes(rng.bytes(40), "little") % p_bn,
         int.from_bytes(rng.bytes(40), "little") % p_bn)
        for _ in range(count)
    ]


def g1_inputs(seed: int, count: int, bn254):
    """(x, offset, scalar) per instance, generated as bench.py:61-88 does
    (and tests/test_torch_g1_e2e.py, whose fixture pins seed 2026)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [(bn254.g1_mul(bn254.G1_GEN, rand_scalar()), bn254.g1_mul(bn254.G1_GEN, rand_scalar()),
             rand_scalar()) for _ in range(count)]


def fq_exp_inputs(seed: int, count: int, bn254):
    """(x, offset, exponent) per instance, generated as bench.py:89-97 does
    (and tests/test_torch_fq_exp_e2e.py, whose fixture pins seed 2026)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    def rand_fq():
        return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN

    return [(rand_fq(), rand_fq(), rand_scalar()) for _ in range(count)]


def g2_inputs(seed: int, count: int, bn254):
    """(x, offset, scalar) per instance, x and offset multiples of the G2
    generator (tests/test_torch_g2_e2e.py, whose fixture pins seed 2026)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [(bn254.g2_mul(bn254.G2_GEN, rand_scalar()), bn254.g2_mul(bn254.G2_GEN, rand_scalar()),
             rand_scalar()) for _ in range(count)]


def fq12_inputs(seed: int, count: int, bn254):
    """(x, offset, exponent) per instance: random Fq12 values and a 256-bit
    scalar, drawn as scripts/heavy_standard_config.py:31-40 draws them (and
    tests/test_torch_fq12_e2e.py, whose fixture pins seed 2026)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_fq12():
        return bn254.Fq12.from_fq_list(
            [int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(12)])

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [(rand_fq12(), rand_fq12(), rand_scalar()) for _ in range(count)]


def multiexp_terms(seed: int, count: int, u64: bool, bn254):
    """(xs, exps) of an Fq12 multi-exponentiation: random Fq12 values, and
    256-bit scalars or (u64) exponents below 2^63 (as
    tests/test_torch_fq12_u64_e2e.py, whose fixture pins seed 2027)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_fq12():
        return bn254.Fq12.from_fq_list(
            [int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(12)])

    xs = [rand_fq12() for _ in range(count)]
    if u64:
        return xs, [int(e) for e in rng.integers(0, 1 << 63, size=count, dtype=np.uint64)]
    return xs, [int.from_bytes(rng.bytes(40), "little") % bn254.R_BN for _ in range(count)]


def path_kernels(cfg) -> list[str]:
    """The kernels a prove under cfg launches: K2 hashes the Merkle leaves
    only under the keccak config (K3 hashes them under Poseidon)."""
    return [k for k in KERNELS if k != "keccak_sponge" or cfg.fri.merkle_hash == "keccak"]


def swap_instances(pi, num_io: int):
    """The public inputs with the first two instances' blocks exchanged."""
    import numpy as np

    blk = pi.shape[0] // num_io
    return np.concatenate([pi[blk : 2 * blk], pi[:blk], pi[2 * blk :]])


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


def timed_call(fn):
    """(fn(), its device time in ms) from CUDA events around one call: the
    plain versions at the widest shapes take seconds, so their check run is
    their timed run."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_equal(name, got, want) -> float:
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
    return err


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


def show(label: str, r: dict) -> None:
    plain = f", plain {r['plain_ms']:.3f} ms" if r.get("plain_ms") is not None else ""
    print(f"kernels: {label}: kernel {r['ms']:.3f} ms{plain}; bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['int_ops'] / 1e9:.3f} G int ops), "
          f"bound share {100 * r['bound_ms'] / r['ms']:.0f} %", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {smi}; max SM clock {clock} MHz, {sms} SMs; torch {torch.__version__} "
          f"cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    return smi, sms, float(clock)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_build(sms: int, clock_mhz: float) -> tuple[Bounds, float]:
    """Returns the bounds and the native library's build seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from starky_bn254_tpu_torch import cuda_lib, native

    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        native_job = pool.submit(_timed, native.build)
        path, cuda_s = _timed(lambda: (cuda_lib.build(), cuda_lib.lib())[0])
        native_path, native_s = native_job.result()
    native.lib()
    print(f"build: {cuda_s:.2f} s -> {os.path.relpath(path, HERE)}")
    print(f"build: native witness generator (g++, beside nvcc) {native_s:.2f} s -> "
          f"{os.path.relpath(native_path, HERE)}")
    spilled = []
    for name, r in sorted(cuda_lib.ptxas_report().items()):
        print(f"build: ptxas {name}: {r.get('registers')} registers, {r.get('stack')} B stack, "
              f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads")
        if "poseidon" in name and (r.get("spill_stores") or r.get("spill_loads")):
            spilled.append(name)
    if spilled:
        raise AssertionError(f"K3 entries spill registers: {spilled}")
    t0 = time.perf_counter()
    ops = cuda_lib.sass_op_counts()
    print(f"build: SASS integer instructions per unit ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(ops, sort_keys=True)}")
    return Bounds(sms, clock_mhz, ops), native_s


def phase_kernels(dev, bounds: Bounds) -> dict:
    import torch

    from starky_bn254_tpu_torch import keccak, ntt, poseidon

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def words(shape, hi_max: int):
        """Random u64 words made on the card (int64 bit patterns), the high
        half below hi_max."""
        hi = torch.randint(0, hi_max, shape, device=dev, generator=gen)
        return (hi << 32) | torch.randint(0, 1 << 32, shape, device=dev, generator=gen)

    def field(*shape):
        """Canonical field elements: a high half below 2^32 - 1 keeps each
        word below 2^64 - 2^32 < p."""
        return words(shape, (1 << 32) - 1)

    out = {}

    # K1: every transform shape of every path, both directions, and a column slice
    errs = []
    # the shapes recorded in the kernel line: each exp path's trace and aux
    # transforms, and the narrow ones every path shares
    recorded: dict[tuple, list[str]] = {}  # shape -> the paths that take it
    for path, widths in PATH_WIDTHS.items():
        for c in widths:
            for n in (65536, 131072):
                recorded.setdefault((n, c), []).append(path)
    for shape in NARROW_NTT_SHAPES:
        recorded[shape] = ["narrow"]
    ntt_rows = {key: [] for key in list(PATH_WIDTHS) + ["narrow"]}
    for shape in [(65536, 812), (131072, 812), (65536, 888), (131072, 888)] + list(recorded):
        x = field(*shape)
        n, c = shape[0], (shape[1] if len(shape) > 1 else 1)
        for inverse in (False, True):
            want, plain_ms = timed_call(lambda: ntt._ntt_plain(x, inverse))
            err = check_equal(f"ntt{shape} inverse={inverse}", ntt.ntt(x, inverse), want)
            del want
            errs.append(err)
            before = ntt.LAUNCHES
            ms = cuda_ms(lambda: ntt.ntt(x, inverse))
            passes = (ntt.LAUNCHES - before) // 4
            r = dict(ms=ms, **bounds.ntt(n, c, inverse))
            if shape in recorded:
                r["plain_ms"] = plain_ms
                for path in recorded[shape]:
                    ntt_rows[path].append(dict(
                        shape=list(shape), inverse=inverse, passes=passes, max_abs_err=err, ms=ms,
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"]))
            show(f"ntt {list(shape)} {'inverse' if inverse else 'forward'} ({passes} passes), equal", r)
        del x
    wide = field(65536, 900)
    view = wide[:, 5:817]  # a column slice: the wrapper reads it in place (row stride 900)
    for inverse in (False, True):
        errs.append(check_equal("ntt column slice", ntt.ntt(view, inverse),
                                ntt._ntt_plain(view.contiguous(), inverse)))
    print("kernels: ntt [65536, 900][:, 5:817] (row stride 900): equal", flush=True)
    del wide, view
    x = field(131072, 888)
    out["ntt"] = dict(max_abs_err=max(errs), shape=[131072, 888], ms=cuda_ms(lambda: ntt.ntt(x)),
                      plain_ms=timed_call(lambda: ntt._ntt_plain(x))[1], **bounds.ntt(131072, 888, False),
                      **{f"{key}_shapes": rows for key, rows in ntt_rows.items()})
    show("ntt [131072, 888] forward", out["ntt"])
    del x

    # K2: Merkle leaf hashing of the trace LDE
    leaves = words((131072, 812), 1 << 32)
    want, plain_ms = timed_call(lambda: keccak._sponge_plain(None, leaves, True, keccak.DIGEST))
    err = check_equal("keccak hash_no_pad", keccak.hash_no_pad(leaves), want)
    out["keccak_sponge"] = dict(
        max_abs_err=err, shape=[131072, 812],
        ms=cuda_ms(lambda: keccak.hash_no_pad(leaves)), plain_ms=plain_ms,
        **bounds.keccak(131072, 812),
    )
    show("keccak hash_no_pad [131072, 812], equal", out["keccak_sponge"])
    leaves = words((131072, 888), 1 << 32)
    check_equal("keccak hash_no_pad [131072, 888]", keccak.hash_no_pad(leaves),
                keccak._sponge_plain(None, leaves, True, keccak.DIGEST))
    show("keccak hash_no_pad [131072, 888] (the Z-column leaves), equal",
         dict(ms=cuda_ms(lambda: keccak.hash_no_pad(leaves)), **bounds.keccak(131072, 888)))
    for path in KECCAK_PATHS:  # each keccak exp path's trace and aux leaves
        rows = []
        for width in PATH_WIDTHS[path]:
            leaves = words((131072, width), 1 << 32)
            want, plain_ms = timed_call(lambda: keccak._sponge_plain(None, leaves, True, keccak.DIGEST))
            err = check_equal(f"keccak hash_no_pad [131072, {width}]", keccak.hash_no_pad(leaves),
                              want)
            r = dict(shape=[131072, width], max_abs_err=err,
                     ms=cuda_ms(lambda: keccak.hash_no_pad(leaves)), plain_ms=plain_ms,
                     **bounds.keccak(131072, width))
            show(f"keccak hash_no_pad [131072, {width}] ({path} leaves), equal", r)
            rows.append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})
        out["keccak_sponge"][f"{path}_shapes"] = rows
    del leaves

    out["poseidon_sponge_and_grind"] = phase_poseidon(dev, bounds, field)
    torch.cuda.empty_cache()
    return out


def phase_poseidon(dev, bounds: Bounds, field) -> dict:
    import torch

    from starky_bn254_tpu_torch import poseidon

    errs = []
    # the main path's calls, in the layout the wrapper picks: the challenger's
    # vector digests (1 and 27 rows of 128 words), one compress, a
    # [131072, 64] absorb (Merkle leaves), the 16-bit grind batch
    timed = {}
    for rows in (1, 27):
        blk = field(rows, 128)
        want, plain_ms = timed_call(lambda: poseidon._sponge_plain(None, blk, 4))
        errs.append(check_equal(f"poseidon hash_no_pad [{rows}, 128]", poseidon.hash_no_pad(blk),
                                want))
        timed[f"digest_{rows}"] = dict(
            ms=cuda_ms(lambda: poseidon.hash_no_pad(blk), 20), plain_ms=plain_ms,
            form=poseidon._sponge_form(rows), **bounds.poseidon(rows, 16, 128, 4))
        show(f"poseidon digest [{rows}, 128] ({poseidon._sponge_form(rows)} layout), equal",
             timed[f"digest_{rows}"])
    left, right = field(1, 4), field(1, 4)
    errs.append(check_equal("poseidon compress", poseidon.compress(left, right),
                            poseidon._sponge_plain(None, torch.cat([left, right], 1), 4)))
    timed["compress_1"] = dict(ms=cuda_ms(lambda: poseidon.compress(left, right), 20),
                               form=poseidon._sponge_form(1), **bounds.poseidon(1, 1, 8, 4))
    show("poseidon compress [1, 4] + [1, 4], equal", timed["compress_1"])
    state, block = field(131072, 12), field(131072, 64)
    want, plain_ms = timed_call(lambda: poseidon._sponge_plain(state, block, poseidon.WIDTH))
    errs.append(check_equal("poseidon sponge_absorb", poseidon.sponge_absorb(state, block), want))
    timed["sponge_131072x64"] = dict(
        ms=cuda_ms(lambda: poseidon.sponge_absorb(state, block)), plain_ms=plain_ms,
        form=poseidon._sponge_form(131072), **bounds.poseidon(131072, 8, 64 + 12, 12))
    show(f"poseidon sponge_absorb [131072, 64] ({poseidon._sponge_form(131072)} layout), equal",
         timed["sponge_131072x64"])
    del state, block
    # the G1 trace leaves under the Poseidon Merkle hash (row layout)
    leaves = field(131072, 404)
    want, plain_ms = timed_call(lambda: poseidon._sponge_plain(None, leaves, 4))
    err = check_equal("poseidon hash_no_pad [131072, 404]", poseidon.hash_no_pad(leaves), want)
    errs.append(err)
    g1_leaves = dict(shape=[131072, 404], max_abs_err=err,
                     ms=cuda_ms(lambda: poseidon.hash_no_pad(leaves)), plain_ms=plain_ms,
                     form=poseidon._sponge_form(131072),
                     **bounds.poseidon(131072, -(-404 // poseidon.RATE), 404, 4))
    show(f"poseidon hash_no_pad [131072, 404] ({g1_leaves['form']} layout, G1 leaves), equal",
         g1_leaves)
    del leaves
    path_leaves = {}
    for path in POSEIDON_PATHS:  # each Poseidon path's trace and aux leaves
        # one plain pass over the widest block serves every width: the sponge
        # state after the first w columns (w a multiple of the rate) is the
        # plain hash of those columns, and the pass goes on from it
        rows, state, absorbed, plain_ms = [], None, 0, 0.0
        leaves = field(131072, max(PATH_WIDTHS[path]))
        for width in sorted(PATH_WIDTHS[path]):
            if absorbed % poseidon.RATE:
                raise AssertionError("a plain pass can only go on from a whole chunk")
            state, ms = timed_call(lambda: poseidon._sponge_plain(state, leaves[:, absorbed:width],
                                                             poseidon.WIDTH))
            plain_ms, absorbed = plain_ms + ms, width
            block = leaves[:, :width].contiguous()
            err = check_equal(f"poseidon hash_no_pad [131072, {width}]", poseidon.hash_no_pad(block),
                              state[:, :4])
            errs.append(err)
            r = dict(shape=[131072, width], max_abs_err=err,
                     ms=cuda_ms(lambda: poseidon.hash_no_pad(block)),
                     plain_ms=plain_ms, form=poseidon._sponge_form(131072),
                     **bounds.poseidon(131072, -(-width // poseidon.RATE), width, 4))
            show(f"poseidon hash_no_pad [131072, {width}] ({r['form']} layout, {path} leaves), equal",
                 r)
            rows.append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})
            del block
        path_leaves[f"{path}_shapes"] = rows
        del leaves, state
    bits = 16
    batch, threshold = 1 << (bits + 2), 1 << (64 - bits)
    for seed in (0x1234_5678_9ABC, 0x0F0F_F0F0_1234_5678):
        start = (seed >> 24) & 0xFFFFFFFF
        got = poseidon.grind_batch(seed, start, batch, threshold, dev)
        want = poseidon._grind_plain(seed, start, batch, threshold, dev)
        if got != want:
            raise AssertionError(f"poseidon grind: kernel {got} != plain {want}")
    grind = dict(ms=cuda_ms(lambda: poseidon.grind_batch(7, 0, batch, threshold, dev)),
                 plain_ms=cuda_ms(lambda: poseidon._grind_plain(7, 0, batch, threshold, dev), 1),
                 **bounds(8, batch * bounds.perm))  # reads nothing, writes one word
    show(f"poseidon grind batch 2^{bits + 2} at {bits} bits, same nonce as plain", grind)

    # both layouts, both MDS forms, against the plain version
    try:
        for params in ("default", "dense"):
            if params == "dense":
                poseidon.set_params(mds_row=(1 << 40, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37),
                                    mds_diag=(0,) * 11 + (1 << 33,))
            for rows in (1, 27, 4096):
                blk, st = field(rows, 128), field(rows, 12)
                for state, out_words in ((None, 4), (st, 12)):
                    want = poseidon._sponge_plain(state, blk, out_words)
                    for form in ("coop", "row"):
                        errs.append(check_equal(f"poseidon {params} {form} [{rows}, 128]",
                                                poseidon._sponge_cuda(state, blk, out_words, form),
                                                want))
            got = poseidon.grind_batch(3, 11, 1 << 16, 1 << 54, dev)
            if got != poseidon._grind_plain(3, 11, 1 << 16, 1 << 54, dev):
                raise AssertionError(f"poseidon grind ({params} MDS) disagrees with plain")
            print(f"kernels: poseidon {params} MDS ({'small' if poseidon._small_mds() else 'dense'} "
                  f"form): both layouts equal at rows 1, 27, 4096; grind equal", flush=True)
    finally:
        poseidon.set_params(seed=poseidon._DEFAULT_SEED, mds_row=poseidon.DEFAULT_MDS_ROW,
                            mds_diag=(0,) * 12)

    # the two layouts against each other over the row count
    sweep = {}
    for rows in (1, 27, 256, 1024, 2048, 4096, 6144, 8192, 12288, 16384):
        blk = field(rows, 128)
        sweep[rows] = {form: cuda_ms(lambda: poseidon._sponge_cuda(None, blk, 4, form), 10)
                       for form in ("coop", "row")}
        print(f"kernels: poseidon layouts at [{rows}, 128]: coop {sweep[rows]['coop']:.4f} ms, "
              f"row {sweep[rows]['row']:.4f} ms", flush=True)
    coop_wins = [r for r in sweep if sweep[r]["coop"] < sweep[r]["row"]]
    last = max((r for r in coop_wins if all(q in coop_wins for q in sweep if q <= r)), default=0)
    print(f"kernels: poseidon coop layout faster up to {last} rows of those swept; "
          f"COOP_MAX_ROWS = {poseidon.COOP_MAX_ROWS}")
    return dict(max_abs_err=max(errs), shape=[batch, 12], **grind,
                **{f"{k}_{f}": v[f] for k, v in timed.items() for f in ("ms", "bound_ms")},
                sweep={str(r): v for r, v in sweep.items()},
                g1_shapes=[{k: v for k, v in g1_leaves.items() if k not in ("bytes", "int_ops")}],
                **path_leaves)


def phase_fidelity(dev):
    import numpy as np

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import FriConfig, StarkConfig, load_proof, proof_to_bytes, prove
    from starky_bn254_tpu_torch.stark.proof import proof_digest

    air = FqMulAir(256)
    pi = np.zeros(0, dtype=np.uint64)
    cfg = StarkConfig.test_config()
    trace42 = air.generate_trace(fq_inputs(42, 250, bn254.P_BN))  # numpy, moved by prove
    got = proof_to_bytes(prove(air, trace42, pi, cfg, device=dev))
    if got != proof_to_bytes(load_proof(FIXTURE)):
        raise AssertionError("FqMulAir(256) test_config proof differs from the fixture")
    print(f"fidelity: FqMulAir(256) test_config proof == fixture ({len(got)} bytes)")
    trace7 = air.generate_trace(fq_inputs(7, 64, bn254.P_BN))
    d7 = proof_digest(prove(air, trace7, pi, cfg, device=dev))
    if d7 != SEED7_DIGEST:
        raise AssertionError(f"seed-7 digest {d7} != {SEED7_DIGEST}")
    print(f"fidelity: seed-7 digest {d7}")
    f = cfg.fri
    kcfg = StarkConfig(num_challenges=cfg.num_challenges, fri=FriConfig(
        rate_bits=f.rate_bits, cap_height=f.cap_height, proof_of_work_bits=f.proof_of_work_bits,
        num_query_rounds=f.num_query_rounds, final_poly_bits=f.final_poly_bits,
        merkle_hash="keccak"))
    dk = proof_digest(prove(air, trace42, pi, kcfg, device=dev))
    if dk != KECCAK_DIGEST:
        raise AssertionError(f"keccak test-config digest {dk} != {KECCAK_DIGEST}")
    print(f"fidelity: keccak test-config digest {dk}")

    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir

    g1 = G1ExpAir(2, range_check="logup", io_binding="rlc")
    g1_trace, g1_pi = g1.generate_trace_and_pi(g1_inputs(G1_FIXTURE_SEED, 2, bn254))
    with np.load(G1_FIXTURE) as f:
        want_pi, want = f["public_inputs"], f["proof_bytes"].tobytes()
    if not np.array_equal(g1_pi, want_pi):
        raise AssertionError("G1ExpAir(2) public inputs differ from the fixture's")
    got = proof_to_bytes(prove(g1, g1_trace, g1_pi, cfg, device=dev))
    if got != want:
        raise AssertionError("G1ExpAir(2, logup, rlc) test_config proof differs from the fixture")
    print(f"fidelity: G1ExpAir(2, logup, rlc) test_config proof == fixture ({len(got)} bytes)")

    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir

    for name, path, air, inputs in (
        ("FqExpAir(2, logup, rlc)", FQ_EXP_FIXTURE, FqExpAir(2, range_check="logup", io_binding="rlc"),
         fq_exp_inputs(G1_FIXTURE_SEED, 2, bn254)),
        ("G2ExpAir(1, logup, rlc)", G2_FIXTURE, G2ExpAir(1, range_check="logup", io_binding="rlc"),
         g2_inputs(G1_FIXTURE_SEED, 1, bn254)),
    ):
        trace, pi = air.generate_trace_and_pi(inputs)
        with np.load(path) as f:
            want_pi, want = f["public_inputs"], f["proof_bytes"].tobytes()
        if not np.array_equal(pi, want_pi):
            raise AssertionError(f"{name}: public inputs differ from the fixture's")
        got = proof_to_bytes(prove(air, trace, pi, cfg, device=dev))
        if got != want:
            raise AssertionError(f"{name} test_config proof differs from the fixture")
        print(f"fidelity: {name} test_config proof == fixture ({len(got)} bytes)")

    from starky_bn254_tpu_torch.airs.fq12_exp import Fq12ExpAir
    from starky_bn254_tpu_torch.compose import prove_fq12_multiexp

    air = Fq12ExpAir(1, range_check="logup", io_binding="rlc")
    trace, pi = air.generate_trace_and_pi(fq12_inputs(G1_FIXTURE_SEED, 1, bn254))
    with np.load(FQ12_FIXTURE) as f:
        want_pi, want = f["public_inputs"], f["proof_bytes"].tobytes()
    if not np.array_equal(pi, want_pi):
        raise AssertionError("Fq12ExpAir(1): public inputs differ from the fixture's")
    got = proof_to_bytes(prove(air, trace, pi, cfg, device=dev))
    if got != want:
        raise AssertionError("Fq12ExpAir(1, logup, rlc) test_config proof differs from the fixture")
    print(f"fidelity: Fq12ExpAir(1, logup, rlc) test_config proof == fixture ({len(got)} bytes)")
    xs, exps = multiexp_terms(FQ12_U64_FIXTURE_SEED, 2, True, bn254)
    proof = prove_fq12_multiexp(xs, exps, u64=True, cfg=cfg, io_binding="rlc")[0]  # the card
    with np.load(FQ12_U64_FIXTURE) as f:
        want = f["proof_bytes"].tobytes()
    got = proof_to_bytes(proof)
    if got != want:
        raise AssertionError("prove_fq12_multiexp(u64=True) test_config proof differs from the fixture")
    print(f"fidelity: prove_fq12_multiexp(2 terms, u64=True): Fq12ExpU64Air(2, logup, rlc) "
          f"test_config proof == fixture ({len(got)} bytes)")


def _phase_ms(tt) -> dict[str, float]:
    """The TimingTree's scopes as {"a/b": ms}."""
    flat = {}

    def walk(node, prefix):
        for c in node.get("children", []):
            flat[prefix + c["name"]] = c["ms"]
            walk(c, prefix + c["name"] + "/")

    d = tt.as_dict()
    flat["prove"] = d["ms"]
    walk(d, "")
    return flat


def _kernels_by_name(prof) -> dict[str, list[float]]:
    """The device kernels of a finished torch.profiler run: {name: [ms]},
    read from the profiler's events (the card's activities but copies and
    memsets), not from an exported trace: a million-launch prove's trace
    file takes a minute to write and parse."""
    import torch

    by_name: dict[str, list[float]] = {}
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if e.device_type() != torch.autograd.DeviceType.CUDA or raw.startswith(("Memcpy", "Memset")):
            continue
        name = raw.split("(")[0].split("<")[0].replace("void ", "").strip()
        by_name.setdefault(name, []).append(e.duration_ns() / 1e6)
    return by_name


def profile_prove(label: str, run) -> dict:
    """torch.profiler over one warm prove: kernel launches, kernel time and
    the device busy share (kernel time over the host wall clock of the
    prove), kernel time by name. Where the trace holds fewer launches of a
    hand kernel than its wrapper counted, the profiler dropped events and
    the launches and busy share are printed as lower bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from starky_bn254_tpu_torch import keccak, ntt, poseidon

    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon}
    before = {k: m.LAUNCHES for k, m in modules.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = _kernels_by_name(prof)
    total_ms = sum(sum(v) for v in by_name.values())
    launches = sum(len(v) for v in by_name.values())
    if launches == 0:
        raise AssertionError("the profiler saw no kernel on the card during a prove")
    busy = 100 * total_ms / (wall_s * 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in ranked[:12]:
        print(f"{label}: kernel {name}: {sum(durs):.2f} ms in {len(durs)} launches")
    hand = {}
    for kernel, names in TRACE_NAMES.items():
        ms = sum(sum(by_name.get(n, [])) for n in names)
        count = sum(len(by_name.get(n, [])) for n in names)
        counted = modules[KERNELS[kernel][0]].LAUNCHES - before[KERNELS[kernel][0]]
        hand[kernel] = dict(ms=ms, launches=count, counted=counted)
        print(f"{label}: {kernel} kernels: {ms:.3f} ms in {count} launches in the trace "
              f"({counted} by the wrapper's count)")
    dropped = sum(h["counted"] - h["launches"] for h in hand.values())
    # the profiler drops events when a prove launches about a million
    # kernels: every count and the busy share below are then lower bounds
    print(f"{label}: profiled warm prove: {'at least ' if dropped else ''}{launches} kernel "
          f"launches, {total_ms:.1f} ms of kernel time in {wall_s * 1e3:.1f} ms of wall clock: "
          f"device busy {'>= ' if dropped else ''}{busy:.1f} %"
          f"{f' (a lower bound: the trace lacks {dropped} launches the wrappers counted)' if dropped else ''}")
    return dict(kernel_launches=launches, kernel_ms=total_ms, wall_ms=wall_s * 1e3, busy_pct=busy,
                hand_kernels=hand, dropped=dropped)


def drive(label: str, air, trace, pi, cfg, warm: int, first=None, check=None,
          profile: bool = False) -> dict:
    """A path through the user's entry points on the card: a first prove
    through `prove`'s default device with every kernel's launch count reset
    just before and read just after (each must be > 0), `warm` timed warm
    proves (median and phase table), verify, and a tampered opening
    rejected. trace: an int64 tensor on the card. first: the entry point to
    count instead of `prove(air, trace, pi, cfg)`, a callable returning the
    proof (its time is then `first_s`, not `prove_first_s`). check: the
    entry point's verify to take instead of `verify(air, proof, cfg)`.
    profile: after the timed warm proves, profile one more prove
    (profile_prove) and print its wall clock against the unprofiled
    median: the profiler's overhead."""
    import numpy as np
    import torch

    from starky_bn254_tpu_torch import keccak, ntt, poseidon
    from starky_bn254_tpu_torch.stark import (VerificationError, proof_from_bytes, proof_to_bytes,
                                              prove, verify)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon}
    dev = trace.device
    torch.cuda.reset_peak_memory_stats(dev)
    for m in modules.values():
        m.LAUNCHES = 0
    t0 = time.perf_counter()
    first_proof = (first or (lambda: prove(air, trace, pi, cfg)))()  # no device named: the card
    torch.cuda.synchronize()
    prove_first_s = time.perf_counter() - t0
    launches = {name: modules[attr].LAUNCHES for name, (attr, _, _) in KERNELS.items()}
    missing = [k for k in path_kernels(cfg) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the main path: {missing}")

    times, phases, stats = [], [], None
    for _ in range(warm):
        tt = TimingTree("prove", dev)
        t0 = time.perf_counter()
        proof = prove(air, trace, pi, cfg, timing=tt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(_phase_ms(tt))
    if profile:  # one more prove, profiled: its wall clock against the unprofiled median
        stats = profile_prove(label, lambda: prove(air, trace, pi, cfg))
        stats["overhead_pct"] = 100 * (stats["wall_ms"] / 1e3 / statistics.median(times) - 1)
        print(f"{label}: the profiled prove took {stats['wall_ms'] / 1e3:.3f} s against the "
              f"unprofiled median {statistics.median(times):.3f} s: profiler overhead "
              f"{stats['overhead_pct']:.1f} %")
    t0 = time.perf_counter()
    ok = (check or (lambda p: verify(air, p, cfg)))(proof)
    verify_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    if ok is not True:
        raise AssertionError(f"{label}: verify did not accept the proof")
    if proof.openings.trace_zeta.shape != (air.num_columns, 2):
        raise AssertionError(f"{label}: unexpected trace opening shape")
    bad = proof_from_bytes(proof_to_bytes(proof))
    bad.openings.trace_zeta[0, 0] ^= np.uint64(1)
    try:
        verify(air, bad, cfg)
    except VerificationError as e:
        print(f"{label}: tampered opening rejected ({e})")
    else:
        raise AssertionError(f"{label}: a tampered opening was accepted")

    print(f"{label}: warm prove phases, median of {warm} (ms)")
    medians = {}
    for key in phases[0]:
        medians[key] = statistics.median([p[key] for p in phases if key in p])
        print(f"{label}:   {medians[key]:9.1f}  {key}")
    size = len(proof_to_bytes(proof))
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    print(f"{label}: prove_s median {statistics.median(times):.3f} (quartiles {q[0]:.3f} / {q[1]:.3f} / "
          f"{q[2]:.3f}; {warm} warm proves) {'first_s' if first else 'prove_first_s'} "
          f"{prove_first_s:.3f} verify_s {verify_s:.3f} proof_bytes {size} "
          f"peak_device_GiB {peak_gib:.2f}")
    print(f"{label}: launches in the {'entry point' if first else 'first prove'} "
          f"{json.dumps(launches)}")
    return dict(launches=launches, proof=proof, first_proof=first_proof,
                prove_s=statistics.median(times), phases=medians, verify_s=verify_s,
                peak_gib=peak_gib, profile=stats)


def phase_slice(dev) -> dict:
    import numpy as np

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import StarkConfig, prove

    air = FqMulAir(SLICE_ROWS)
    cfg = StarkConfig.standard_fast_config("keccak")
    pi = np.zeros(0, dtype=np.uint64)
    t0 = time.perf_counter()
    trace_np = air.generate_trace(fq_inputs(0, SLICE_ROWS, bn254.P_BN))
    tracegen_s = time.perf_counter() - t0
    trace = xnp.to_torch(trace_np, dev)  # on the card before the timed proves
    print(f"slice: FqMulAir({SLICE_ROWS}) trace {tuple(trace.shape)}, "
          f"{len(air.permutation_pairs())} permutation pairs, tracegen_s {tracegen_s:.3f}", flush=True)
    r = drive("slice", air, trace, pi, cfg, WARM_PROVES)
    profile_prove("slice", lambda: prove(air, trace, pi, cfg))
    return r["launches"]


def exp_statement(label: str, air, inputs, shapes, dev, note: str = "", warm: bool = True):
    """Tracegen of an exp AIR's statement, cold (the chain's first use in
    this process) and (warm) again; its trace on the card, its shapes
    checked against `shapes` ((rows, columns), aux columns). Returns
    (trace, pi, aux columns)."""
    from starky_bn254_tpu_torch import xnp
    from starky_bn254_tpu_torch.stark import StarkConfig, logup

    nc = StarkConfig.standard_fast_config("keccak").num_challenges
    gen_s = []
    for _ in range(2 if warm else 1):
        t0 = time.perf_counter()
        trace_np, pi = air.generate_trace_and_pi(inputs)
        gen_s.append(time.perf_counter() - t0)
    trace = xnp.to_torch(trace_np, dev)
    del trace_np
    aux_w = nc * (logup.table_aux_width(air.lookup_tables()) + air.aux_extra_width())
    print(f"{label}: {type(air).__name__}({air.num_io}) {air.range_check} range check, "
          f"{air.io_binding} IO binding: trace {tuple(trace.shape)}, {aux_w} aux columns; "
          f"{note + ', ' if note else ''}tracegen_s cold {gen_s[0]:.3f}"
          f"{f' warm {gen_s[1]:.3f}' if warm else ''}",
          flush=True)
    if (tuple(trace.shape), aux_w) != shapes:
        raise AssertionError(f"{label}: unexpected shapes {tuple(trace.shape)}, {aux_w} aux columns")
    return trace, pi, aux_w


def reject_swapped(label: str, air, trace, pi, cfg, probe: bool = False) -> dict | None:
    """The proof of the trace under the public inputs with the first two
    instances exchanged must be rejected (the RLC IO binding). probe: run
    that prove (the same work as a warm prove of the statement) under the
    composition probe and return its measures."""
    from starky_bn254_tpu_torch.stark import VerificationError, prove, verify

    def run():
        return prove(air, trace, swap_instances(pi, air.num_io), cfg)

    swapped, seen = composition_probe(label, run) if probe else (run(), None)
    try:
        verify(air, swapped, cfg)
    except VerificationError as e:
        print(f"{label}: proof of two swapped instances rejected ({e})")
    else:
        raise AssertionError(f"{label}: the proof of two swapped instances was accepted")
    return seen


def phase_g1(dev, native_build_s: float) -> dict:
    """The bench's main path (bench.py:48-238) at its full size."""
    import torch

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig, logup, prove, verify
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    air = G1ExpAir(G1_NUM_IO)
    cfg = StarkConfig.standard_fast_config("keccak")
    inputs = g1_inputs(0, G1_NUM_IO, bn254)  # bench.py: default_rng(0)
    trace, pi, aux_w = exp_statement("g1", air, inputs, G1_SHAPES, dev,
                                     f"native build {native_build_s:.2f} s")
    r = drive("g1", air, trace, pi, cfg, G1_WARM_PROVES)
    reject_swapped("g1", air, trace, pi, cfg)

    r["profile"] = profile_prove("g1", lambda: prove(air, trace, pi, cfg))

    # the logUp column build by both routes at this shape
    tables, gammas = air.lookup_tables(), [0x1234_5678_9ABC, 0xFEDC_BA98_7654]
    cols = {route: logup.compute_logup_columns(trace, tables, gammas, route)
            for route in ("fermat", "table")}
    check_equal("logup columns, table route against the fermat route", cols["table"], cols["fermat"])
    del cols
    route_ms = {route: cuda_ms(lambda: logup.compute_logup_columns(trace, tables, gammas, route), 2)
                for route in ("fermat", "table")}
    default = logup.pick_route(trace.shape[0], tables)
    print(f"g1: logup columns [{trace.shape[0]}, {aux_w - 2 * air.aux_extra_width()}], both routes "
          f"equal: fermat {route_ms['fermat']:.2f} ms, table {route_ms['table']:.2f} ms; "
          f"compute_logup_columns takes {default!r}")
    if route_ms[default] > min(route_ms.values()):
        raise AssertionError(f"g1: the default logUp route {default!r} is the slower one here")
    r["logup_route_ms"] = route_ms

    pcfg = StarkConfig.standard_fast_config("poseidon")
    tt = TimingTree("prove", dev)
    t0 = time.perf_counter()
    proof = prove(air, trace, pi, pcfg, timing=tt)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if verify(air, proof, pcfg) is not True:
        raise AssertionError("g1: verify did not accept the poseidon-config proof")
    verify_s = time.perf_counter() - t0
    ph = _phase_ms(tt)
    print(f"g1: standard_fast_config('poseidon'): prove {prove_s:.3f} s, trace commit "
          f"{ph['trace commit']:.1f} ms, aux commit/commit {ph['aux (Z/logup) commit/commit']:.1f} ms, "
          f"verify_s {verify_s:.3f}, accepted")
    return r


def composition_probe(label: str, run) -> tuple:
    """run(), a warm prove, with its constraint composition watched: the row
    blocks (composition.pick_block_rows), the kernel launches (torch.profiler
    over the composition alone) and the peak device memory above what was
    allocated when it began, as live int64 words per committed cell of a
    block (the measure composition._TEMPS_PER_CELL is set from). Returns
    (run's result, the measures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from starky_bn254_tpu_torch.stark import composition, prover

    seen = {}
    plain = prover.evaluate_composition

    def watched(air_, trace_lde, z_lde, *args, **kwargs):
        n_lde, dev = trace_lde.shape[0], trace_lde.device
        width = air_.num_columns + (z_lde.shape[1] if z_lde is not None else 0)
        block = kwargs.get("block_rows") or composition.pick_block_rows(n_lde, width, dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = plain(air_, trace_lde, z_lde, *args, **kwargs)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        seen.update(n_lde=n_lde, width=width, block_rows=block, blocks=-(-n_lde // block),
                    peak_gib=peak / 2**30, wall_ms=wall_ms, words_per_cell=peak / (8 * block * width),
                    prof=prof)
        return out

    prover.evaluate_composition = watched
    try:
        result = run()
    finally:
        prover.evaluate_composition = plain
    seen["launches"] = sum(len(v) for v in _kernels_by_name(seen.pop("prof")).values())
    print(f"{label}: composition probe: {seen['blocks']} row blocks of {seen['block_rows']} over "
          f"{seen['n_lde']} LDE rows x {seen['width']} committed columns "
          f"(_TEMPS_PER_CELL = {composition._TEMPS_PER_CELL}), {seen['launches']} kernel launches, "
          f"{seen['wall_ms']:.1f} ms under the profiler, peak {seen['peak_gib']:.2f} GiB above its "
          f"start = {seen['words_per_cell']:.2f} live int64 words per committed cell of a block")
    return result, seen


def phase_exp(label: str, air, inputs, shapes, dev, profile: bool) -> dict:
    """A further exp statement through the user's entry points under the
    bench's config: the steps of phase_g1 but the logUp and Poseidon
    comparisons."""
    from starky_bn254_tpu_torch.stark import StarkConfig, prove

    cfg = StarkConfig.standard_fast_config("keccak")
    trace, pi, _ = exp_statement(label, air, inputs, shapes, dev)
    r = drive(label, air, trace, pi, cfg, EXP_WARM_PROVES)
    for sub in ("logup", "rlc aux"):
        if f"aux (Z/logup) commit/column build/{sub}" not in r["phases"]:
            raise AssertionError(f"{label}: no {sub!r} phase in the prove's timing tree")
    r["composition"] = reject_swapped(label, air, trace, pi, cfg, probe=profile)
    if profile:
        r["profile"] = profile_prove(label, lambda: prove(air, trace, pi, cfg))
    return r


def phase_fq12(label: str, u64: bool, dev) -> dict:
    """The Fq12 multi-exponentiation entry point (compose/msm.py) at full
    width: prove_fq12_multiexp with FQ12_NUM_IO 256-bit terms under its
    default config, or (u64) FQ12_U64_NUM_IO u64 terms under the keccak
    config; the steps of phase_exp with the entry point as the counted
    run and verify_fq12_multiexp as the check, the time of the rlc aux
    phase's whole-trace copy to the host, and (fq12) the composition
    probe."""
    import torch

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs import Fq12ExpAir, Fq12ExpU64Air
    from starky_bn254_tpu_torch.compose import (Fq12MultiExp, pad_instances, prove_fq12_multiexp,
                                                verify_fq12_multiexp)
    from starky_bn254_tpu_torch.stark import StarkConfig, proof_to_bytes

    num_io = FQ12_U64_NUM_IO if u64 else FQ12_NUM_IO
    xs, exps = multiexp_terms(0, num_io, u64, bn254)  # default_rng(0)
    cfg_arg = StarkConfig.standard_fast_config("keccak") if u64 else None  # None: the default
    cfg = cfg_arg or StarkConfig.standard_fast_config()
    t0 = time.perf_counter()
    inputs, result = Fq12MultiExp(u64=u64).build_inputs(xs, exps)
    oracle_s = time.perf_counter() - t0
    # the AIR the entry point builds: "auto" binds the IO by RLC from 128 instances on
    air_cls = Fq12ExpU64Air if u64 else Fq12ExpAir
    air = air_cls(num_io, range_check="logup", io_binding="auto")
    trace, pi, _ = exp_statement(label, air, pad_instances(inputs),
                                 FQ12_U64_SHAPES if u64 else FQ12_SHAPES, dev,
                                 f"host oracle of the chain {oracle_s:.3f} s", warm=False)
    run = {}

    def entry():  # the warm tracegen is the one inside the entry point, timed here
        plain_gen = air_cls.generate_trace_and_pi

        def timed_gen(*args, **kwargs):
            t0 = time.perf_counter()
            out = plain_gen(*args, **kwargs)
            run["tracegen_s"] = time.perf_counter() - t0
            return out

        air_cls.generate_trace_and_pi = timed_gen
        try:
            run["out"] = prove_fq12_multiexp(xs, exps, u64=u64, cfg=cfg_arg)
        finally:
            air_cls.generate_trace_and_pi = plain_gen
        return run["out"][0]

    def check(p):  # the entry point's verify, of the warm proof (the same statement)
        return verify_fq12_multiexp(p, result, air, num_io, u64=u64, cfg=cfg_arg)

    r = drive(label, air, trace, pi, cfg, FQ12_WARM_PROVES, first=entry, check=check, profile=True)
    print(f"{label}: tracegen_s warm {run['tracegen_s']:.3f} (in the entry point)")
    proof, res, run_air, n_real = run["out"]
    if (type(run_air), run_air.num_io, n_real) != (type(air), num_io, num_io) \
            or res.coeffs != result.coeffs \
            or proof_to_bytes(proof) != proof_to_bytes(r["proof"]):
        raise AssertionError(f"{label}: the entry point proved another statement")
    if verify_fq12_multiexp(proof, res * xs[0], run_air, n_real, u64=u64, cfg=cfg_arg):
        raise AssertionError(f"{label}: verify_fq12_multiexp accepted a wrong result")
    print(f"{label}: verify_fq12_multiexp accepts the proof (verify_s above), the entry point's "
          f"proof equals the warm prove's bytes, and a wrong result is refused")
    for sub in ("logup", "rlc aux"):
        if f"aux (Z/logup) commit/column build/{sub}" not in r["phases"]:
            raise AssertionError(f"{label}: no {sub!r} phase in the prove's timing tree")
    if not u64:  # the u64 AIR's eval is the same multiply and chain
        r["composition"] = reject_swapped(label, air, trace, pi, cfg, probe=True)
    else:
        reject_swapped(label, air, trace, pi, cfg)
    # the rlc aux phase's host copy: prove hands the whole trace to
    # Air.generate_aux, which reads 2 * num_io of its rows
    from starky_bn254_tpu_torch import xnp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xnp.to_numpy(trace)
    copy_ms = (time.perf_counter() - t0) * 1e3
    rlc_ms = r["phases"]["aux (Z/logup) commit/column build/rlc aux"]
    print(f"{label}: rlc aux: the whole-trace copy to the host ({trace.numel() * 8 / 1e9:.2f} GB) "
          f"{copy_ms:.1f} ms of the phase's {rlc_ms:.1f} ms")
    r["rlc_copy_ms"] = copy_ms
    return r


def phase_msm(dev) -> dict:
    """The remaining entry points of compose/msm.py on the card, each under
    its default config: a G1 MSM over MSM_POINTS points, its result held
    against the host oracle's sum, and hash-to-G2 on one message."""
    import numpy as np

    from starky_bn254_tpu_torch import bn254, keccak, ntt, poseidon
    from starky_bn254_tpu_torch.compose import (prove_g1_msm, prove_hash_to_g2, verify_g1_msm,
                                                verify_hash_to_g2)
    from starky_bn254_tpu_torch.stark import StarkConfig

    rng = np.random.default_rng(0)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    points = [bn254.g1_mul(bn254.G1_GEN, rand_scalar()) for _ in range(MSM_POINTS)]
    scalars = [rand_scalar() for _ in range(MSM_POINTS)]
    want = None
    for p, k in zip(points, scalars):
        want = bn254.g1_add(want, bn254.g1_mul(p, k))
    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon}

    def counted(label: str, cfg, run):
        """run() with every launch count reset just before and read just
        after; each kernel of a prove under cfg must have launched."""
        for m in modules.values():
            m.LAUNCHES = 0
        out = run()
        launches = {name: modules[attr].LAUNCHES for name, (attr, _, _) in KERNELS.items()}
        missing = [k for k in path_kernels(cfg) if launches[k] <= 0]
        if missing:
            raise AssertionError(f"msm: kernels not launched in {label}: {missing}")
        print(f"msm: launches in {label} {json.dumps(launches)}")
        return out, launches

    cfg = StarkConfig.standard_fast_config()  # both entry points' default
    t0 = time.perf_counter()
    (proof, result, air, n_real), g1_launches = counted(
        "prove_g1_msm", cfg, lambda: prove_g1_msm(points, scalars))  # the card
    prove_s = time.perf_counter() - t0
    if result != want:
        raise AssertionError("msm: prove_g1_msm's result differs from the host oracle's sum")
    t0 = time.perf_counter()
    if verify_g1_msm(proof, result, air, n_real) is not True:
        raise AssertionError("msm: verify_g1_msm did not accept")
    verify_s = time.perf_counter() - t0
    if verify_g1_msm(proof, bn254.g1_double(result), air, n_real):
        raise AssertionError("msm: verify_g1_msm accepted a wrong result")
    print(f"msm: prove_g1_msm({MSM_POINTS} points) -> {type(air).__name__}({air.num_io}, "
          f"{air.range_check}, {air.io_binding}) {prove_s:.3f} s (oracle, tracegen and prove); "
          f"result equals the host oracle's sum; verify_g1_msm accepts ({verify_s:.3f} s) and "
          f"refuses a wrong result")
    msg = b"chip_smoke hash-to-G2"
    t0 = time.perf_counter()
    (proof, p_twist, result, air), h2g2_launches = counted(
        "prove_hash_to_g2", cfg, lambda: prove_hash_to_g2(msg))
    prove_s = time.perf_counter() - t0
    if not bn254.g2_is_on_curve(p_twist) or verify_hash_to_g2(msg, proof, result, air) is not True:
        raise AssertionError("msm: verify_hash_to_g2 did not accept")
    print(f"msm: prove_hash_to_g2 -> G2ExpAir(1, {air.range_check}, {air.io_binding}) {prove_s:.3f} s; "
          f"verify_hash_to_g2 accepts")
    return dict(g1_launches=g1_launches, h2g2_launches=h2g2_launches)


def phase_pipelined(dev) -> dict:
    """The bench's service tier (bench.py:196-236): PIPE_BATCHES batches of
    G1ExpAir(128), each from its own seed, through prove_pipelined, against
    sequential proves of the same batches."""
    import torch

    from starky_bn254_tpu_torch import bn254, keccak, ntt, poseidon, xnp
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import (StarkConfig, pipeline, proof_to_bytes, prove,
                                              prove_pipelined, verify)

    air = G1ExpAir(G1_NUM_IO)
    cfg = StarkConfig.standard_fast_config("keccak")
    batches = [g1_inputs(seed, G1_NUM_IO, bn254) for seed in range(1, PIPE_BATCHES + 1)]
    # the worker alone: tracegen at its thread cap, through the pipe into
    # pinned memory, with no prove beside it
    t0 = time.perf_counter()
    pipeline._Tracegen(air, batches[0]).join(pin=True)
    worker_s = time.perf_counter() - t0

    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon}
    for m in modules.values():
        m.LAUNCHES = 0
    stamps: list[float] = []
    spans: list[tuple[float, float]] = []  # each prove's host start and end inside the pipeline
    plain_prove = pipeline.prove

    def timed_prove(*args, **kwargs):
        start = time.time()
        out = plain_prove(*args, **kwargs)  # the proof is on the host when it returns
        spans.append((start, time.time()))
        return out

    pipeline.prove = timed_prove
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        proofs = prove_pipelined(air, batches, cfg, on_proof=lambda i, t: stamps.append(t))
    finally:
        pipeline.prove = plain_prove
    pipe_s = time.time() - t0
    waits = [spans[0][0] - t0] + [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    launches = {name: modules[attr].LAUNCHES for name, (attr, _, _) in KERNELS.items()}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"g1-pipelined: kernels not launched: {missing}")
    fill = PIPE_BATCHES * G1_NUM_IO / pipe_s
    steady = (PIPE_BATCHES - 1) * G1_NUM_IO / (stamps[-1] - stamps[0])

    gen_s, prove_s = [], []
    for i, (inputs, proof) in enumerate(zip(batches, proofs)):
        t0 = time.perf_counter()
        trace, pi = air.generate_trace_and_pi(inputs)
        gen_s.append(time.perf_counter() - t0)
        trace = xnp.to_torch(trace, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = prove(air, trace, pi, cfg)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        if proof_to_bytes(proof) != proof_to_bytes(want):
            raise AssertionError(f"g1-pipelined: proof {i} differs from the sequential prove")
        if verify(air, proof, cfg) is not True:
            raise AssertionError(f"g1-pipelined: proof {i} was not accepted")
        del trace
    serial = G1_NUM_IO / (statistics.median(gen_s) + statistics.median(prove_s))
    print(f"g1-pipelined: {PIPE_BATCHES} x G1ExpAir({G1_NUM_IO}) in {pipe_s:.3f} s; every proof "
          f"equals its sequential prove's bytes and verifies; proofs done at "
          f"{', '.join(f'{t - stamps[0]:.3f}' for t in stamps)} s after the first")
    print(f"g1-pipelined: e2e_pipelined_per_s {steady:.3f} (steady), e2e_pipelined_fill_per_s "
          f"{fill:.3f}; serial num_io / (tracegen + prove) {serial:.3f} (tracegen median "
          f"{statistics.median(gen_s):.3f} s, prove median {statistics.median(prove_s):.3f} s)")
    print(f"g1-pipelined: per batch, wait for its trace / prove (s): "
          f"{'; '.join(f'{w:.3f} / {b - a:.3f}' for w, (a, b) in zip(waits, spans))}; "
          f"the worker alone (tracegen at STARKY_NATIVE_THREADS=2, pipe, pinned) {worker_s:.3f} s")
    print(f"g1-pipelined: launches in the pipelined run {json.dumps(launches)}")
    return dict(launches=launches, steady=steady, fill=fill, serial=serial, waits=waits,
                worker_s=worker_s)


def main() -> int:
    start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"chip_smoke: {phase} done at {time.perf_counter() - start:.1f} s", flush=True)

    smi, sms, clock = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    bounds, native_build_s = phase_build(sms, clock)
    done("build")
    kernel_stats = phase_kernels(dev, bounds)
    done("kernels")
    phase_fidelity(dev)
    done("fidelity")
    slice_launches = phase_slice(dev)
    torch.cuda.empty_cache()
    done("slice")
    g1 = phase_g1(dev, native_build_s)
    torch.cuda.empty_cache()
    done("g1")

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir

    fq = phase_exp("fq", FqExpAir(G1_NUM_IO), fq_exp_inputs(0, G1_NUM_IO, bn254), FQ_EXP_SHAPES,
                   dev, profile=False)
    torch.cuda.empty_cache()
    done("fq")
    g2 = phase_exp("g2", G2ExpAir(G1_NUM_IO), g2_inputs(0, G1_NUM_IO, bn254), G2_SHAPES, dev,
                   profile=True)
    torch.cuda.empty_cache()
    done("g2")
    pipelined = phase_pipelined(dev)
    torch.cuda.empty_cache()
    done("g1-pipelined")
    fq12 = phase_fq12("fq12", False, dev)
    torch.cuda.empty_cache()
    done("fq12")
    fq12_u64 = phase_fq12("fq12-u64", True, dev)
    torch.cuda.empty_cache()
    done("fq12-u64")
    msm_run = phase_msm(dev)
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        r = kernel_stats[name]
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=g1["launches"][name], launches_fq_mul=slice_launches[name],
                   launches_fq_exp=fq["launches"][name], launches_g2_exp=g2["launches"][name],
                   launches_g1_pipelined=pipelined["launches"][name],
                   launches_fq12_exp=fq12["launches"][name],
                   launches_fq12_exp_u64=fq12_u64["launches"][name],
                   launches_g1_msm=msm_run["g1_launches"][name],
                   launches_hash_to_g2=msm_run["h2g2_launches"][name],
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=None, shape=r["shape"])
        row.update({k: v for k, v in r.items() if k not in row and k not in ("bytes", "int_ops")})
        kernels.append(row)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
