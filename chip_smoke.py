#!/usr/bin/env python3
"""On-card smoke run of starky_bn254_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels build from
starky_bn254_tpu_torch/csrc/ at first use). Phases, each printing its own
lines; any failure raises and the exit code is non-zero:

1. device: the card's name, power limit and maximum SM clock (nvidia-smi);
2. build: the four kernel sources, one nvcc per source side by side, and the
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
   those of the Poseidon paths; K2 and K3 also with a random carried
   sponge state at the streaming commit's shapes: an absorb of one block
   of whole chunks, and the finalize of a last block with its tail);
   exact equality (all arithmetic is exact mod p); kernel and plain times;
   each kernel's bound, the larger of its compulsory bytes over the HBM
   rate and the integer instructions of the work its function needs over
   the int32 rate (SMs x 64 lanes x the maximum SM clock), and which of the
   two it is. K3 also runs at the challenger's shapes, in both state
   layouts and under a dense-MDS parameter set, and a row sweep times the
   two layouts against each other (the crossover behind
   poseidon.COOP_MAX_ROWS). K1 also runs at the north-star shapes,
   [2^20, 404/390] inverse and [2^21, 404/390] forward, in three passes
   (its plain version over 64-column blocks), and the quotient's [2^21, 2]
   inverse and [2^21, 4] forward; K2 at the north-star leaves [2^21,
   404/390]; the u16 path's shapes (1165 trace, 1528 aux columns) under
   K1 and K2, the parity path's leaves (404, 390) under K3; the sharded
   phase's per-shard shapes (K1 [65536, 101] / [65536, 98] inverse read in
   place from 404 / 392 columns and [131072, 101] / [131072, 98] forward;
   K2 and K3 over row shards [32768, 404] / [32768, 390]); K3's parity grind from a
   random base state at every nonce slot 0-7 (and a batch with no hit), at
   16 bits and 2^18 states, against its plain version, the default grind
   timed again after it;
3b. field: the field kernels (csrc/field.cu: add, sub, mul, neg,
   mul_const, sum_mod) against the plain torch chain (goldilocks.py's
   torch engine) on the card at a composition block's operand shapes of
   each benchmark cell (B = 131072 LDE rows at g1-exp-128, 16384 at
   fq12-exp-16): equal words, one launch a call, the kernel's device time
   (profiler), its host wall a call, the plain chain's time and the bound;
   their registers and spills; then one whole composition block of
   G1ExpAir(128) and Fq12ExpAir(16) on random LDE words at the cells'
   widths, equal to the plain chain's on the card, its `block` span's
   field_launches equal to its calls of the six ops, the aten ops that
   remain (TorchDispatchMode: all, and those that launch), and both walls;
4. fidelity: FqMulAir(256) under test_config must reproduce
   tests/fixtures/fq_mul_256_test_config.npz byte for byte, and
   G1ExpAir(2, logup, rlc) under test_config
   tests/fixtures/g1_exp_2_rlc_test_config.npz (both made by the JAX
   package), and likewise FqExpAir(2, logup, rlc), G2ExpAir(1, logup, rlc),
   Fq12ExpAir(1, logup, rlc) and the two-term prove_fq12_multiexp(u64=True)
   (Fq12ExpU64Air(2, logup, rlc)) against their fixtures; the seed-7 digest
   and the keccak test-config digest pinned by the CPU tests must match;
   both shared-FRI batches of tests/fixtures/batch_fri_fq_mul_test_config.npz
   (prove_batch_fri), the mixed-height one also with its LDEs offloaded,
   must give the fixture's bytes; the parity fixture's FqMulAir(256) proof
   and two-statement batch (test_config with the parity transcript) and
   the u16 fixture's FqExpAir(128, "u16") proof
   (tests/fixtures/parity_fq_mul_256.npz, fq_exp_128_u16_test_config.npz)
   must give their bytes;
5. parity: G1ExpAir(128) under StarkConfig.parity_config() (Poseidon
   leaves, every vector observed element by element, plonky2's proof of
   work): the steps of drive(), with the parity grind's launches in the
   first prove counted (K3's grind entry from the challenger's state,
   fri.grind_parity; the default grind must not run); a tampered pow_nonce,
   the proof under standard_fast_config("poseidon") and a
   standard_fast_config("poseidon") proof (g1-poseidon: timed with its
   phases and verified) under parity_config() rejected;
   prove_batch_fri of G1ExpAir(128) and FqExpAir(128) under parity_config()
   with its launches counted, verify_batch_fri, a tampered nonce rejected;
6. u16: G1ExpAir(128, range_check="u16") (65536 x 1165, 762 permutation
   pairs: 1528 aux columns) under standard_fast_config("keccak"): the steps
   of drive(), and a checked cell of 2^16 refused at tracegen;
7. slice: FqMulAir(65536) (812 trace + 888 permutation columns) under
   standard_fast_config("keccak"): trace generation, a first prove through
   `prove`'s default device (the card) with every kernel's launch count
   reset just before and read just after (all must be > 0), WARM_PROVES
   warm prove (time and phase table), verify, a tampered opening
   rejected, then torch.profiler over one more warm prove: device busy
   share and kernel time by name;
8. g1, the bench's main path: G1ExpAir(128) (65536 x 404 trace, logup_u16
   range check, RLC IO binding: 390 aux columns) under
   standard_fast_config("keccak"), inputs as bench.py makes them: tracegen
   cold and warm, a first prove with the launch counts reset and read as
   in 7, G1_WARM_PROVES warm proves (median and phase table, with the
   logup and rlc aux sub-phases), verify, a tampered opening and an
   instance-swapped proof rejected, the profile of one more warm prove, the
   logUp column build by both routes (equal, each timed) (the prove under
   standard_fast_config("poseidon") runs in 5);
9. fq, the bench's second statement (STARKY_BENCH_AIR=fq): FqExpAir(128)
   (65536 x 164 trace, 152 aux columns) under the keccak config, inputs as
   bench.py makes them: tracegen cold and warm, the steps of 8 (first
   prove with launch counts, warm proves, verify, tampered and
   instance-swapped proofs rejected);
10. g2: G2ExpAir(128) (65536 x 788 trace, 770 aux columns), inputs
   g2_mul(G2_GEN, scalar) from default_rng(0): the steps of 9, peak device
   memory, the profile of one warm prove and the composition probe (one
   more warm prove: the row blocks, the kernel launches and the peak device
   memory of the constraint composition, as live int64 words per committed
   cell of a block);
11. g1-pipelined, the bench's service tier (bench.py:196-236): four
   G1ExpAir(128) batches, each from its own seed, through prove_pipelined
   with the launch counts reset and read around it; each proof must equal
   the bytes of a sequential prove of its batch and verify; the steady and
   fill rates beside the serial num_io / (tracegen + prove) of the same
   batches;
11b. sharded: the g1 statement over a mesh of SHARDS (4) shards of the one
   card (parallel.sharded.make_mesh(4, device=cuda:0)) under the keccak
   config and under the Poseidon config: each first prove with the kernel
   counts and the shard counters reset just before and read just after (K1
   and the leaf hasher, K2 or K3, launched on every shard of both sharded
   commits), its bytes equal to the single prove's (g1's; the parity
   phase's g1-poseidon), verified; a tampered opening rejected; one more
   keccak prove timed with its phases against g1's, the collectives' calls
   and bytes, peak device memory; graft_entry.entry() on the card against
   its plain path; graft_entry.dryrun_multichip(8, device=cuda:0) (its
   G1ExpAir(16) prove and verify included); prove_pipelined of the first
   two g1-pipelined batches over 2 shards, each proof its sequential
   prove's bytes;
12. fq12: the Fq12 multi-exponentiation entry point,
   prove_fq12_multiexp(xs, exps) with 128 terms under its default config
   (standard_fast_config(), Poseidon leaves), which proves Fq12ExpAir(128)
   (65536 x 4412 trace, 2672 aux columns): tracegen cold and warm, the
   entry point's call with the launch counts reset and read around it (its
   proof must equal the warm prove's bytes), FQ12_WARM_PROVES warm proves
   (phase table), verify_fq12_multiexp true, and false for a wrong result,
   a tampered opening and an instance-swapped proof rejected, the rlc aux
   phase's whole-trace copy to the host timed, peak device memory (no
   profile and no composition probe: under the profiler they took 63 s of
   the phase's 217 s, and the run's time limit is 1200 s);
13. fq12-u64: the same through prove_fq12_multiexp(u64=True) with 512
   terms (exponents below 2^63) under standard_fast_config("keccak"), which
   proves Fq12ExpU64Air(512) (65536 x 4402 trace, 2672 aux columns);
14. msm: prove_g1_msm / verify_g1_msm over 128 points (the result equal to
   the host oracle's sum), prove_g2_msm / verify_g2_msm over 128 points,
   prove_fq_multiexp / verify_fq_multiexp over 128 terms (each result equal
   to the host oracle's, a wrong result refused) and prove_hash_to_g2 /
   verify_hash_to_g2 on one message, each under its default config, with
   the launch counts reset just before and read just after each entry
   point (each path's kernels checked on its own count);
15. batch: prove_batch_fri over G1ExpAir(128), G1ExpAir(128), FqExpAir(128)
   (65536 rows each) and G1ExpAir(32) (16384 rows: a mixed height) under
   standard_fast_config("keccak"), each traced natively from its seed: a
   first batch prove with the launch counts reset and read around it and
   checked against the counts the four single proves give (each
   statement's share and one shared FRI), BATCH_WARM_PROVES warm batch
   proves (median, phase table, the shared FRI's time), verify_batch_fri
   accepts, a tampered opening of the small statement and a flipped trace
   cap of a large one are rejected; the batch's bytes against the four
   single proofs' (each proved and timed in this run); peak device memory;
16. batch-offload: the same batch with STARKY_LDE_DEVICE_BYTES=0 (every LDE
   in pinned host memory): every statement's bytes and the K1/K2/K3 launch
   counts equal the on-card batch's (the commits, quotient and FRI ran on
   the card); each reader of an LDE (composition, openings, combine) is
   handed host LDEs, copies all of their bytes to the card and leaves its
   result there (watch_lde_readers); its prove time, peak device memory
   and bytes copied from host to card, by reader; the
   streaming commit in blocks of several chunks (the sponge state carried
   across them) against the whole-matrix commit at the G1 trace's shape,
   under both Merkle hashes;
17. verify-batch: verify_batch over the g1, fq and g2 phases' proofs and
   the batch fixture's single FqMulAir(256) proof, one of them tampered and
   one with a chain check that fails: exactly those two reported;
18. northstar: the north-star entry point
   (starky_bn254_tpu_torch/scripts/northstar_g1.py, `run`) at 2^20 rows,
   G1ExpAir(2048) (1048576 x 404) under standard_fast_config("keccak"):
   inputs, tracegen, one prove on the card and verify, with the launch
   counts reset just before and read just after; its phase table, peak
   device memory, host RSS after each step, composition's row blocks, the
   caching allocator's retries and whether the retained LDE went past
   STARKY_LDE_DEVICE_BYTES;
19. the kernel JSON line, the card's line, then the result line.

    python3 chip_smoke.py --lde-budget

runs 1 and 2 and then only the probe of the device budget of retained LDE
(STARKY_LDE_DEVICE_BYTES; `phase_lde_budget`): one Fq12ExpAir(128) and a
batch just under the budget, each proved on the card and offloaded, and a
batch just over it; each with its time, peak device memory, bytes copied
from host to card and its compositions' row blocks. Set
STARKY_LDE_DEVICE_BYTES to probe another budget.
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
WARM_PROVES = 1  # the slice's prove_s (one warm prove: the run's time limit)
G1_NUM_IO = 128  # bench.py's default: 65536 rows
G1_SHAPES = ((1 << 16, 404), 390)  # its trace and its aux columns, uncut
G1_WARM_PROVES = 3  # the g1 phase's prove_s is their median
FQ_EXP_SHAPES = ((1 << 16, 164), 152)
G2_SHAPES = ((1 << 16, 788), 770)
EXP_WARM_PROVES = 2  # the fq and g2 phases' prove_s is their median
PIPE_BATCHES = 4  # bench.py's n_pipe
SHARDS = 4  # the sharded phase's mesh: 4 shards of the one card
PIPE_MESH_SHARDS = 2  # prove_pipelined's mesh there
DRYRUN_SHARDS = 8  # graft_entry.dryrun_multichip's
FQ12_NUM_IO = 128  # Fq12ExpAir(128): 128 terms x 512 rows
FQ12_SHAPES = ((1 << 16, 4412), 2672)
FQ12_U64_NUM_IO = 512  # Fq12ExpU64Air(512): 512 terms x 128 rows
FQ12_U64_SHAPES = ((1 << 16, 4402), 2672)
FQ12_WARM_PROVES = 1  # ~18-20 s each: one keeps the whole run well inside its limit
MSM_POINTS = 128  # prove_g1_msm's and prove_g2_msm's points, prove_fq_multiexp's terms
BATCH_FIXTURE = os.path.join(HERE, "tests", "fixtures", "batch_fri_fq_mul_test_config.npz")
# the batch phase's statements: (label, AIR, num_io, input seed); 65536
# rows but the last, 16384 (ratio 4: one fold layer down the shared ladder)
BATCH_STATEMENTS = (("g1-a", "G1ExpAir", 128, 11), ("g1-b", "G1ExpAir", 128, 12),
                    ("fq", "FqExpAir", 128, 13), ("g1-small", "G1ExpAir", 32, 14))
BATCH_WARM_PROVES = 2  # the batch phase's prove_s is their median
STREAM_BLOCK_CELLS = 1 << 24  # blocks of 128 columns at 131072 LDE rows: several per G1 commit
PARITY_FIXTURE = os.path.join(HERE, "tests", "fixtures", "parity_fq_mul_256.npz")
U16_FIXTURE = os.path.join(HERE, "tests", "fixtures", "fq_exp_128_u16_test_config.npz")
U16_FIXTURE_SEED = 2028  # tests/test_torch_u16_range_check.py: the fixture's pinned inputs
PARITY_WARM_PROVES = 2  # the parity phase's prove_s is their median
# G1ExpAir(128, "u16"): its trace, and its aux columns (2 challenges x (762
# permutation Z columns + 2 RLC))
U16_SHAPES = ((1 << 16, 1165), 1528)
U16_WARM_PROVES = 2  # the u16 phase's prove_s is their median
# the north-star entry point's shape: 2^20 rows, 2^11 G1 instances (the
# 2^19 shape runs through the entry point itself, beside this script: the
# run's time limit leaves no room for it)
NORTHSTAR_LOG_ROWS = 20
# K1 at the north-star trace's transforms (three passes): its trace and
# aux columns, interpolated at 2^20 rows and extended to 2^21
NORTHSTAR_NTT_SHAPES = (((1 << 20, 404), True), ((1 << 20, 390), True),
                        ((1 << 21, 404), False), ((1 << 21, 390), False),
                        ((1 << 21, 2), True), ((1 << 21, 4), False))  # + the quotient's
NORTHSTAR_LEAF_WIDTHS = (404, 390)  # its trace and aux leaves, 2^21 rows, hashed by K2
NTT_PLAIN_COLUMNS = 64  # the plain NTT at 2^20-2^21 rows runs over column blocks of this width
# K1 shapes of each exp path: its trace and aux columns (inverse at 65536
# rows, forward LDE at 131072); its leaves (131072 rows of each width) are
# hashed by K2 on the keccak paths and by K3 on the Poseidon paths
# (g1_poseidon: the g1-poseidon and parity phases' G1ExpAir(128); fq12)
PATH_WIDTHS = {"g1": (404, 390), "fq": (164, 152), "g2": (788, 770), "fq12": (4412, 2672),
               "fq12_u64": (4402, 2672), "g1_poseidon": (404, 390), "u16": (1165, 1528)}
KECCAK_PATHS = ("g1", "fq", "g2", "fq12_u64", "u16")
POSEIDON_PATHS = ("g1_poseidon", "fq12")
# the quotient's transforms ([131072, 2] inverse, [131072, 4] forward at
# 65536 rows) and the FRI final polynomial's
NARROW_NTT_SHAPES = [(131072, 2), (131072, 4), (131072,), (65536, 4)]

KERNELS = {  # name -> (module attribute holding the launch count, source, replaces)
    "ntt": ("ntt", "starky_bn254_tpu_torch/csrc/ntt.cu",
            "starky_bn254_tpu/pallas/ntt_kernel.py:237"),
    "keccak_sponge": ("keccak", "starky_bn254_tpu_torch/csrc/keccak.cu",
                      "starky_bn254_tpu/pallas/keccak_kernel.py:146"),
    "poseidon_sponge_and_grind": ("poseidon", "starky_bn254_tpu_torch/csrc/poseidon.cu",
                                  "starky_bn254_tpu/pallas/poseidon_kernel.py:192"),
    "field": ("goldilocks", "starky_bn254_tpu_torch/csrc/field.cu",
              "none: XLA fused these ops in the JAX package's jitted segments"),
}
# kernel names in the profiler's trace, by the kernel they belong to
TRACE_NAMES = {"ntt": ("ntt_pass_kernel",), "keccak_sponge": ("keccak_sponge_kernel",),
               "poseidon_sponge_and_grind": ("poseidon_sponge_kernel", "poseidon_coop_kernel",
                                             "poseidon_grind_kernel"),
               "field": ("field_elementwise_kernel", "field_sum_kernel")}
# the kernels whose launches a prove's regions account for: its statements'
# commits and one FRI. The field kernels also run in the opening combine,
# outside those regions (a batch's combine adds a term a statement), and in
# each composition block, whose count follows the LDE's memory budget; so
# the region and offload comparisons of the batch phases cover these three.
REGION_KERNELS = ("ntt", "keccak_sponge", "poseidon_sponge_and_grind")


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


def batch_fixture_statements(fixture: dict, key: str):
    """The statements of the batch fixture (tests/test_torch_batch_fri.py)
    from the inputs it holds: key "eq", three FqMulAir(256); "mixed",
    FqMulAir(1024) and FqMulAir(256). [(air, trace)]"""
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir

    names = sorted(k[: -len("_rows")] for k in fixture if k.startswith(key + "_") and k.endswith("_rows"))
    out = []
    for name in names:
        air = FqMulAir(int(fixture[f"{name}_rows"]))
        pairs = [(int.from_bytes(a.tobytes(), "little"), int.from_bytes(b.tobytes(), "little"))
                 for a, b in fixture[f"{name}_pairs"]]
        out.append((air, air.generate_trace(pairs)))
    return out


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


def show(label: str, r: dict) -> None:
    plain = f", plain {r['plain_ms']:.3f} ms" if r.get("plain_ms") is not None else ""
    print(f"kernels: {label}: kernel {r['ms']:.3f} ms{plain}; bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['int_ops'] / 1e9:.3f} G int ops), "
          f"bound share {100 * r['bound_ms'] / r['ms']:.0f} %", flush=True)


def carried_state_rows(name: str, h, rand, bounds: Bounds) -> list[dict]:
    """Hasher h (keccak or poseidon) with a random carried sponge state at
    the streaming commit's shapes (131072 LDE rows): sponge_absorb of one
    block of whole chunks as the default block cells give it, and finalize
    of a last block with its tail (the G1 trace's 404 columns), each
    against its plain version on the same inputs."""
    from starky_bn254_tpu_torch.stark import prover

    rows_n = 131072
    block_cols = (prover.COMMIT_BLOCK_CELLS // rows_n) // h.RATE * h.RATE
    state = rand(rows_n, h.WIDTH)
    keccak = name == "keccak"
    out = []
    for kind, width in (("sponge_absorb", block_cols), ("finalize", 404)):
        block = rand(rows_n, width)
        absorb = kind == "sponge_absorb"
        run = (lambda: h.sponge_absorb(state, block)) if absorb else (lambda: h.finalize(state, block))
        words = h.WIDTH if absorb else 4
        if keccak:
            want, plain_ms = timed_call(lambda: h._sponge_plain(state, block, not absorb, words))
            perms = width // h.RATE + (0 if absorb else 1)
            b = bounds(8 * rows_n * (h.WIDTH + width + words),
                       rows_n * perms * 24 * bounds.ops["probe_keccak_round"])
        else:
            want, plain_ms = timed_call(lambda: h._sponge_plain(state, block, words))
            b = bounds.poseidon(rows_n, -(-width // h.RATE), width + h.WIDTH, words)
        err = check_equal(f"{name} {kind} [{rows_n}, {width}] with a carried state", run(), want)
        r = dict(kind=kind, shape=[rows_n, width], max_abs_err=err, ms=cuda_ms(run), plain_ms=plain_ms, **b)
        show(f"{name} {kind} [{rows_n}, {width}] with a random carried state, equal", r)
        out.append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})
        del block, want
    return out


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
    from starky_bn254_tpu_torch.utils.bounds import Bounds

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

    def words_any(*shape):
        """Any u64 words (Keccak lanes)."""
        return words(shape, 1 << 32)

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
    out["ntt"]["northstar_shapes"] = ntt_northstar_rows(field, bounds)
    out["ntt"]["max_abs_err"] = max([out["ntt"]["max_abs_err"]] +
                                    [r["max_abs_err"] for r in out["ntt"]["northstar_shapes"]])

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
    rows = []
    for width in NORTHSTAR_LEAF_WIDTHS:  # the north-star commits' leaves, 2^21 rows
        leaves = words((1 << 21, width), 1 << 32)
        want, plain_ms = timed_call(lambda: keccak._sponge_plain(None, leaves, True, keccak.DIGEST))
        err = check_equal(f"keccak hash_no_pad [{1 << 21}, {width}]", keccak.hash_no_pad(leaves), want)
        del want
        r = dict(shape=[1 << 21, width], max_abs_err=err,
                 ms=cuda_ms(lambda: keccak.hash_no_pad(leaves)), plain_ms=plain_ms,
                 **bounds.keccak(1 << 21, width))
        show(f"keccak hash_no_pad [{1 << 21}, {width}] (north-star leaves), equal", r)
        rows.append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})
    out["keccak_sponge"]["northstar_shapes"] = rows
    del leaves
    out["keccak_sponge"]["carried_state_shapes"] = carried_state_rows("keccak", keccak, words_any,
                                                                      bounds)

    out["poseidon_sponge_and_grind"] = phase_poseidon(dev, bounds, field)
    out["poseidon_sponge_and_grind"]["carried_state_shapes"] = carried_state_rows(
        "poseidon", poseidon, field, bounds)
    for kernel, rows in sharded_shape_rows(field, words_any, bounds).items():
        out[kernel]["sharded_shapes"] = rows
    torch.cuda.empty_cache()
    return out


# the benchmark cells' statements, one composition block each: (label, AIR
# module, class, num_io, range check, IO binding, LDE rows)
FIELD_BLOCKS = (("g1-exp-128", "g1_exp", "G1ExpAir", 128, "logup_u16", "rlc", 1 << 17),
                ("fq12-exp-16", "fq12_exp", "Fq12ExpAir", 16, "logup", "pulse", 1 << 14))
FIELD_REPS = 20  # launches a field-kernel timing averages
FIELD_NAMES = TRACE_NAMES["field"]


def field_op_rows(dev, bounds: Bounds, rows: int, width: int, label: str) -> list[dict]:
    """Each field kernel against its plain torch chain on the card at a
    composition block's operand shapes (rows LDE rows of a width-column
    block): equal words; the kernel's device time (the profiler's, a
    launch, with L2 scrubbed before each), its host wall a call, the plain
    chain's device time (one warm call), and the bound (compulsory bytes
    over the HBM rate, or the op's SASS instructions over the int32
    rate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from starky_bn254_tpu_torch import goldilocks as gl

    gen = torch.Generator(device=dev)
    gen.manual_seed(rows + width)

    def words(*shape):  # any u64 words, canonical or not
        return (torch.randint(0, 1 << 32, shape, device=dev, generator=gen) << 32) | torch.randint(
            0, 1 << 32, shape, device=dev, generator=gen)

    block = words(rows + 2, width)
    lanes, cols, outer = words(rows, 16), block[:rows, 0:16], words(rows, 16, 31)
    mul_ops, add_ops = bounds.ops["probe_gl_mul"], bounds.ops["probe_add_canonical"]
    k = 16
    cases = [  # (name, kernel call, plain call, bytes, int ops)
        ("add [B,16] + [B,16]", lambda: gl.add(lanes, cols), lambda: gl._add_plain(lanes, cols),
         24 * rows * k, add_ops * rows * k),
        ("sub of column slices in place (row stride = width)",
         lambda: gl.sub(block[:rows, 16:32], block[2 : rows + 2, 32:48]),
         lambda: gl._sub_plain(block[:rows, 16:32], block[2 : rows + 2, 32:48]),
         24 * rows * k, bounds.ops["probe_sub_canonical"] * rows * k),
        ("mul [B,16] x lane weights [16]", lambda: gl.mul(lanes, lanes[0]),
         lambda: gl._mul_plain(lanes, lanes[0]), 16 * rows * k, mul_ops * rows * k),
        ("mul column [B,1] x [B,16]", lambda: gl.mul(block[:rows, 48, None], lanes),
         lambda: gl._mul_plain(block[:rows, 48, None], lanes), 8 * rows * (2 * k + 1),
         mul_ops * rows * k),
        ("mul [B,16,1] x [B,1,16]", lambda: gl.mul(lanes[:, :, None], cols[:, None, :]),
         lambda: gl._mul_plain(lanes[:, :, None], cols[:, None, :]), 8 * rows * (2 * k + k * k),
         mul_ops * rows * k * k),
        ("mul [B] x 0-d", lambda: gl.mul(lanes[:, 0], lanes[0, 0]),
         lambda: gl._mul_plain(lanes[:, 0], lanes[0, 0]), 16 * rows, mul_ops * rows),
        ("add [B,16] + host scalar", lambda: gl.add(lanes, 3), lambda: gl._add_plain(lanes, 3),
         16 * rows * k, add_ops * rows * k),
        ("neg [B,16]", lambda: gl.neg(lanes), lambda: gl._neg_plain(lanes), 16 * rows * k,
         bounds.ops["probe_sub_canonical"] * rows * k),
        ("mul_const [B,16] x 65536", lambda: gl.mul_const(lanes, 65536),
         lambda: gl._mul_const_plain(lanes, 65536), 16 * rows * k, mul_ops * rows * k),
        ("sum_mod [B,16] along -1", lambda: gl.sum_mod(lanes, -1),
         lambda: gl._sum_mod_plain(lanes, -1), 8 * rows * (k + 1), add_ops * rows * k),
        ("sum_mod [B,16,31] along -2", lambda: gl.sum_mod(outer, -2),
         lambda: gl._sum_mod_plain(outer, -2), 8 * rows * 31 * (k + 1), add_ops * rows * 31 * k),
        ("sum_mod [B,32] along 0 (split)", lambda: gl.sum_mod(block[:rows, :32], 0),
         lambda: gl._sum_mod_plain(block[:rows, :32], 0), 8 * (rows * 32 + 32),
         add_ops * rows * 32),
    ]
    scrub = torch.empty(1 << 24, dtype=torch.int64, device=dev)  # 128 MB, past the 50 MB L2
    out = []
    for name, kernel, plain, nbytes, ops in cases:
        plain()
        want, plain_ms = timed_call(plain)
        before = gl.LAUNCHES
        err = check_equal(f"field {label} {name}", kernel(), want)
        if gl.LAUNCHES - before != 1:
            raise AssertionError(f"field {label} {name}: {gl.LAUNCHES - before} launches, not 1")
        del want
        kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FIELD_REPS):
            kernel()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / FIELD_REPS * 1e6
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(FIELD_REPS):
                scrub.zero_()
                kernel()
            torch.cuda.synchronize()
        times = [t for n_, ts in _kernels_by_name(prof).items() if n_.startswith(FIELD_NAMES)
                 for t in ts]
        if len(times) != FIELD_REPS:
            raise AssertionError(f"field {label} {name}: {len(times)} kernels in the trace, "
                                 f"not {FIELD_REPS}")
        r = dict(name=name, rows=rows, ms=sum(times) / len(times), wall_us=wall_us,
                 plain_ms=plain_ms, max_abs_err=err, **bounds(nbytes, ops))
        show(f"field {label} {name} (B = {rows}), equal; host wall {wall_us:.1f} us a call", r)
        out.append({k_: v for k_, v in r.items() if k_ not in ("bytes", "int_ops")})
    return out


class aten_ops:
    """Inside the block, every aten op dispatched (torch's
    TorchDispatchMode), by name: `all`; `non_view`, all but views (the
    count that gave 353,554 ops a parent's Fq12 block and 44,807 a g1
    one); `launching`, also without the allocations, which launch
    nothing."""

    VIEWS = {"slice", "select", "unsqueeze", "view", "expand", "t", "transpose", "squeeze",
             "alias", "as_strided", "_unsafe_view", "detach", "permute", "unbind", "split",
             "lift_fresh"}

    def __enter__(self):
        from collections import Counter

        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counts[str(func.overloadpacket).split(".")[-1]] += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)

    @property
    def all(self) -> int:
        return sum(self.counts.values())

    @property
    def non_view(self) -> int:
        return sum(v for k, v in self.counts.items() if k not in self.VIEWS)

    @property
    def launching(self) -> int:
        return self.non_view - self.counts["empty"]


def field_composition_block(dev, label, module, cls, num_io, range_check, io_binding,
                            n_lde) -> dict:
    """One composition block of a benchmark cell's AIR on random LDE words
    (trace and aux at the cell's widths, n_lde rows), through
    evaluate_composition under a Recorder: its `block` span's
    field_launches against the block's calls of the six dispatched ops; the
    remaining aten ops a block (TorchDispatchMode); the block's wall with
    the field kernels and with the plain torch chain on the card (equal
    quotient values)."""
    import importlib

    import numpy as np
    import torch

    from starky_bn254_tpu_torch import goldilocks as gl
    from starky_bn254_tpu_torch import xnp
    from starky_bn254_tpu_torch.stark import StarkConfig, composition
    from starky_bn254_tpu_torch.stark.logup import table_aux_width
    from starky_bn254_tpu_torch.utils import timing as tm

    air = getattr(importlib.import_module(f"starky_bn254_tpu_torch.airs.{module}"), cls)(
        num_io, range_check, io_binding)
    cfg = StarkConfig.standard_fast_config("poseidon")
    nc = cfg.num_challenges
    aux_w = nc * (len(air.permutation_pairs()) + table_aux_width(air.lookup_tables())
                  + air.aux_extra_width())
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_lde)

    def field(*shape):  # canonical words
        return (torch.randint(0, (1 << 32) - 1, shape, device=dev, generator=gen) << 32) | (
            torch.randint(0, 1 << 32, shape, device=dev, generator=gen))

    lde, z_lde = field(n_lde, air.num_columns), field(n_lde, aux_w)
    rng = np.random.default_rng(n_lde)
    pi = rng.integers(0, gl.P, air.num_public_inputs, dtype=np.uint64)
    alphas = [int(v) for v in rng.integers(0, gl.P, nc, dtype=np.uint64)]
    gammas = [int(v) for v in rng.integers(0, gl.P, nc, dtype=np.uint64)]
    n = n_lde >> cfg.fri.rate_bits

    def run():
        return composition.evaluate_composition(air, lde, z_lde, pi, alphas, gammas, n, cfg)

    def walled():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    run()  # warm: the allocator, the selector tables
    names = ("add", "sub", "mul", "neg", "mul_const", "sum_mod")
    saved = {k: getattr(gl, k) for k in names}
    calls = {k: 0 for k in names}

    def counted(k):
        def f(*args, **kwargs):
            calls[k] += 1
            return saved[k](*args, **kwargs)
        return f

    rec = tm.Recorder()
    for k in names:
        setattr(gl, k, counted(k))
    try:
        with tm.recording(rec):
            got, ms = walled()
    finally:
        for k, f in saved.items():
            setattr(gl, k, f)
    blocks = [s for s in rec.spans if s.name == "block"]
    launches = sum(s.counts["field_launches"] for s in blocks)
    if launches != sum(calls.values()):
        raise AssertionError(f"field {label}: field_launches {launches} != field calls {calls}")
    _, ms2 = walled()
    with aten_ops() as ops:
        run()
        torch.cuda.synchronize()
    plain_on_card = gl._on_card
    gl._on_card = lambda x: False  # the plain torch chain, on the card
    try:
        want, plain_ms = walled()
    finally:
        gl._on_card = plain_on_card
    check_equal(f"field {label} composition block", got, want)
    del lde, z_lde, got, want
    torch.cuda.empty_cache()
    r = dict(label=label, width=air.num_columns, aux_width=aux_w, n_lde=n_lde, blocks=len(blocks),
             field_launches=launches, field_calls=calls, aten_ops=ops.all,
             aten_non_view=ops.non_view, aten_launching=ops.launching,
             aten_empty=ops.counts["empty"],
             aten_top=ops.counts.most_common(8), ms=min(ms, ms2), plain_ms=plain_ms)
    print(f"field: {label} composition ({n_lde} x {air.num_columns} + {aux_w}, {len(blocks)} "
          f"block): equal to the plain chain on the card; field_launches {launches} = field calls "
          f"{json.dumps(calls)}; aten ops {ops.all}, {ops.non_view} but views (launching "
          f"{ops.launching}, allocations "
          f"{ops.counts['empty']}; top {ops.counts.most_common(8)}); {min(ms, ms2):.1f} ms "
          f"(the plain chain {plain_ms:.1f} ms)", flush=True)
    return r


def phase_field(dev, bounds: Bounds) -> dict:
    """The field kernels (csrc/field.cu) against the plain torch chain on the
    card, at the composition blocks' shapes of both benchmark cells, and one
    whole composition block of each cell's AIR. The kernel line's figures
    are the g1 block's outer-product mul's, the composition's largest op."""
    from starky_bn254_tpu_torch import cuda_lib

    ptxas = {k: v for k, v in cuda_lib.ptxas_report().items() if "field_" in k}
    spilled = [k for k, v in ptxas.items() if v.get("spill_stores") or v.get("spill_loads")]
    regs = sorted({v.get("registers") for v in ptxas.values()})
    print(f"field: {len(ptxas)} kernel instances, registers {regs}, spilling {spilled or 'none'}")
    out = {"registers": regs, "spilled": spilled}
    for label, _, _, _, _, _, n_lde in FIELD_BLOCKS:
        out[f"{label}_ops"] = field_op_rows(dev, bounds, n_lde, 404 if "g1" in label else 4475,
                                            label)
    out["blocks"] = [field_composition_block(dev, *b) for b in FIELD_BLOCKS]
    g1_rows = out[f"{FIELD_BLOCKS[0][0]}_ops"]
    (main,) = [r for r in g1_rows if r["name"].startswith("mul [B,16,1] x [B,1,16]")]
    out.update({k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
               shape=[main["rows"], 16, 16])
    return out


def check_field_launches(label: str, launches: dict, block: dict) -> None:
    """A prove's field launches, counted from its own run: at least one
    composition block's (every prove composes at least one block on the
    card, and its aux, openings and FRI add more)."""
    if launches["field"] < max(1, block["field_launches"]):
        raise AssertionError(f"{label}: {launches['field']} field launches in the prove, fewer than "
                             f"one {block['label']} composition block's {block['field_launches']}")
    print(f"{label}: {launches['field']} field launches in the prove (one {block['label']} "
          f"composition block: {block['field_launches']})")


def ntt_plain_by_columns(x, inverse: bool):
    """The plain NTT of x, NTT_PLAIN_COLUMNS columns at a time (the columns
    are independent transforms): at 2^21 rows the whole matrix's plain
    temporaries would not fit beside the kernel's output."""
    import torch

    from starky_bn254_tpu_torch import ntt

    out = torch.empty_like(x)
    for c0 in range(0, x.shape[1], NTT_PLAIN_COLUMNS):
        out[:, c0 : c0 + NTT_PLAIN_COLUMNS] = ntt._ntt_plain(
            x[:, c0 : c0 + NTT_PLAIN_COLUMNS].contiguous(), inverse)
    return out


def ntt_northstar_rows(field, bounds: Bounds) -> list[dict]:
    """K1 at the north-star shapes (NORTHSTAR_NTT_SHAPES), each against its
    plain version on the same inputs, in the passes its plan gives (three
    for the trace and aux transforms)."""
    import torch

    from starky_bn254_tpu_torch import ntt

    rows = []
    for (n, c), inverse in NORTHSTAR_NTT_SHAPES:
        x = field(n, c)
        want, plain_ms = timed_call(lambda: ntt_plain_by_columns(x, inverse))
        err = check_equal(f"ntt [{n}, {c}] inverse={inverse}", ntt.ntt(x, inverse), want)
        del want
        before = ntt.LAUNCHES
        ms = cuda_ms(lambda: ntt.ntt(x, inverse))
        passes = (ntt.LAUNCHES - before) // 4
        planned = len(ntt._pass_plan(n.bit_length() - 1, c))
        if passes != planned:
            raise AssertionError(f"ntt [{n}, {c}]: {passes} passes, the plan says {planned}")
        r = dict(shape=[n, c], inverse=inverse, passes=passes, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, **bounds.ntt(n, c, inverse))
        show(f"ntt {[n, c]} {'inverse' if inverse else 'forward'} ({passes} passes, north-star), "
             f"equal", r)
        rows.append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})
        del x
        torch.cuda.empty_cache()
    return rows


def phase_poseidon(dev, bounds: Bounds, field) -> dict:
    import torch

    from starky_bn254_tpu_torch import poseidon, xnp

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
    path_leaves = {}
    for path in POSEIDON_PATHS:  # each Poseidon path's trace and aux leaves
        # one plain pass over the widest block serves every width: the sponge
        # state after the first w columns (w a multiple of the rate) is the
        # plain hash of those columns, and the pass goes on from it (past a
        # partial chunk a new pass starts)
        rows, state, absorbed, plain_ms = [], None, 0, 0.0
        leaves = field(131072, max(PATH_WIDTHS[path]))
        for width in sorted(PATH_WIDTHS[path]):
            if absorbed % poseidon.RATE:
                state, absorbed, plain_ms = None, 0, 0.0
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
    # the parity grind (the same entry: a base state, the nonce at slot k,
    # the test on slot 7): a random base state for every input slot, and
    # one batch with no hit
    bases = [[int(v) for v in xnp.to_numpy(field(poseidon.WIDTH))] for _ in range(poseidon.RATE)]
    for k, base in enumerate(bases):
        for thr in (threshold, 1):
            got = poseidon.grind_parity_batch(base, k, 0, batch, thr, dev)
            want = poseidon._grind_parity_plain(base, k, 0, batch, thr, dev)
            if got != want:
                raise AssertionError(f"poseidon parity grind, slot {k}: kernel {got} != plain {want}")
    grind_parity = dict(
        ms=cuda_ms(lambda: poseidon.grind_parity_batch(bases[3], 3, 0, batch, threshold, dev)),
        plain_ms=cuda_ms(lambda: poseidon._grind_parity_plain(bases[3], 3, 0, batch, threshold,
                                                             dev), 1),
        max_abs_err=0.0, shape=[batch, poseidon.WIDTH], slots=list(range(poseidon.RATE)),
        **bounds(8, batch * bounds.perm))
    show(f"poseidon parity grind batch 2^{bits + 2} at {bits} bits, slots 0-7 (and no hit), same "
         f"nonce as plain", grind_parity)
    # the default grind again in the same call, after the parity one: the
    # shared entry's cost against its own spread
    grind["ms_again"] = cuda_ms(lambda: poseidon.grind_batch(7, 0, batch, threshold, dev))
    print(f"kernels: poseidon grind batch, default transcript, timed again: {grind['ms_again']:.3f} "
          f"ms (first {grind['ms']:.3f} ms)", flush=True)

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
            got = poseidon.grind_parity_batch(bases[5], 5, 11, 1 << 16, 1 << 54, dev)
            if got != poseidon._grind_parity_plain(bases[5], 5, 11, 1 << 16, 1 << 54, dev):
                raise AssertionError(f"poseidon parity grind ({params} MDS) disagrees with plain")
            print(f"kernels: poseidon {params} MDS ({'small' if poseidon._small_mds() else 'dense'} "
                  f"form): both layouts equal at rows 1, 27, 4096; both grinds equal", flush=True)
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
                grind_parity={k: v for k, v in grind_parity.items() if k not in ("bytes", "int_ops")},
                **{f"{k}_{f}": v[f] for k, v in timed.items() for f in ("ms", "bound_ms")},
                sweep={str(r): v for r, v in sweep.items()},
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
    fidelity_batch(cfg)
    fidelity_parity_u16(cfg)


def fidelity_parity_u16(cfg) -> None:
    """The parity fixture's single FqMulAir(256) proof and two-statement
    batch under test_config with the parity transcript, and the u16
    fixture's FqExpAir(128, "u16") proof under test_config, proved on the
    card, give the fixtures' bytes (all three made by the JAX package)."""
    import dataclasses

    import numpy as np

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import proof_to_bytes, prove, prove_batch_fri

    pcfg = dataclasses.replace(cfg, fri=dataclasses.replace(cfg.fri, parity=True))
    pi = np.zeros(0, dtype=np.uint64)
    with np.load(PARITY_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}

    def statement(name):
        air = FqMulAir(256)
        pairs = [(int.from_bytes(a.tobytes(), "little"), int.from_bytes(b.tobytes(), "little"))
                 for a, b in fixture[f"{name}_pairs"]]
        return air, air.generate_trace(pairs), pi

    air, trace, _ = statement("single")
    got = proof_to_bytes(prove(air, trace, pi, pcfg))  # the card
    if got != fixture["single"].tobytes():
        raise AssertionError("parity FqMulAir(256) proof differs from the fixture")
    print(f"fidelity: FqMulAir(256) parity test_config proof == fixture ({len(got)} bytes)")
    names = sorted(k[: -len("_pairs")] for k in fixture if k.startswith("batch_") and k.endswith("_pairs"))
    batch = prove_batch_fri([statement(n) for n in names], pcfg)
    if [proof_to_bytes(st) for st in batch.statements] != [fixture[n].tobytes() for n in names]:
        raise AssertionError("parity prove_batch_fri differs from the fixture")
    print(f"fidelity: prove_batch_fri of the parity batch ({len(names)} x FqMulAir(256)) == fixture")

    air = FqExpAir(G1_NUM_IO, range_check="u16")
    trace, upi = air.generate_trace_and_pi(fq_exp_inputs(U16_FIXTURE_SEED, G1_NUM_IO, bn254))
    with np.load(U16_FIXTURE) as f:
        want_pi, want = f["public_inputs"], f["proof_bytes"].tobytes()
    if not np.array_equal(upi, want_pi):
        raise AssertionError("FqExpAir(128, u16): public inputs differ from the fixture's")
    got = proof_to_bytes(prove(air, trace, upi, cfg))
    if got != want:
        raise AssertionError("FqExpAir(128, u16) test_config proof differs from the fixture")
    print(f"fidelity: FqExpAir(128, u16) ({trace.shape[0]} x {trace.shape[1]}, "
          f"{len(air.permutation_pairs())} permutation pairs) test_config proof == fixture "
          f"({len(got)} bytes)")


def fidelity_batch(cfg) -> None:
    """Both batches of the batch fixture through prove_batch_fri on the
    card (the mixed one also offloaded) give the fixture's bytes."""
    import numpy as np

    from starky_bn254_tpu_torch.stark import proof_to_bytes, prove_batch_fri

    with np.load(BATCH_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    for key, offload in (("eq", None), ("mixed", None), ("mixed", "0")):
        stmts = batch_fixture_statements(fixture, key)
        with env_set("STARKY_LDE_DEVICE_BYTES", offload):
            batch = prove_batch_fri([(a, t, np.zeros(0, dtype=np.uint64)) for a, t in stmts],
                                    cfg)  # the card
        if [proof_to_bytes(st) for st in batch.statements] != \
                [fixture[f"{key}_{j}"].tobytes() for j in range(len(stmts))]:
            raise AssertionError(f"prove_batch_fri ({key}, offload {offload}) differs from the fixture")
        print(f"fidelity: prove_batch_fri of the {key} batch "
              f"({', '.join(f'FqMulAir({a.num_rows})' for a, _ in stmts)})"
              f"{' with STARKY_LDE_DEVICE_BYTES=0' if offload else ''} == fixture")


class env_set:
    """Environment variable `name` set to `value` inside the block (None:
    unset) and restored after it."""

    def __init__(self, name: str, value: str | None):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.pop(self.name, None)
        if self.value is not None:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        os.environ.pop(self.name, None)
        if self.saved is not None:
            os.environ[self.name] = self.saved


def launch_counts() -> dict[str, int]:
    from starky_bn254_tpu_torch import goldilocks, keccak, ntt, poseidon

    modules = {"ntt": ntt, "keccak": keccak, "poseidon": poseidon, "goldilocks": goldilocks}
    return {name: modules[attr].LAUNCHES for name, (attr, _, _) in KERNELS.items()}


def reset_launches() -> None:
    from starky_bn254_tpu_torch import goldilocks, keccak, ntt, poseidon

    for m in (ntt, keccak, poseidon, goldilocks):
        m.LAUNCHES = 0


class launch_regions:
    """Inside the block, the kernel launches of every call of a prove's
    regions: a statement's path (`_prove_statement`, for `prove` and for a
    batch), its FRI (`fri_prove`) and the proof-of-work grind in it
    (`fri.grind`, or `fri.grind_parity` under the parity transcript: the one
    data-dependent count). `log[region]`: one {kernel: launches} per call,
    in call order."""

    def __enter__(self):
        from starky_bn254_tpu_torch.stark import batch_prove, fri, prover

        self.log = {"statement": [], "fri": [], "grind": [], "grind_parity": []}
        self.saved = []
        for mod, attr, region in ((prover, "_prove_statement", "statement"),
                                  (batch_prove, "_prove_statement", "statement"),
                                  (prover, "fri_prove", "fri"), (batch_prove, "fri_prove", "fri"),
                                  (fri, "grind", "grind"), (fri, "grind_parity", "grind_parity")):
            plain = getattr(mod, attr)
            self.saved.append((mod, attr, plain))

            def counted(*args, _plain=plain, _region=region, **kwargs):
                before = launch_counts()
                out = _plain(*args, **kwargs)
                after = launch_counts()
                self.log[_region].append({k: after[k] - before[k] for k in after})
                return out

            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, plain in self.saved:
            setattr(mod, attr, plain)


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


def _busy_ns(prof, w0: int, w1: int) -> int:
    """The union of the card's activity intervals (kernels, copies and
    memsets, overlapping streams counted once) clipped to [w0, w1), on the
    profiler's clock (time.time_ns())."""
    import torch

    intervals = sorted((max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, w0
    for a, b in intervals:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_prove(label: str, run) -> dict:
    """torch.profiler over one warm prove: kernel launches, kernel time
    (summed, overlap counted twice) and the device busy share (the union of
    the card's activity intervals over the host wall clock of the prove),
    kernel time by name. Where the trace holds fewer launches of a hand
    kernel than its wrapper counted, the profiler dropped events and the
    launches and busy share are printed as lower bounds. The prove records
    no spans (the port's DEVICE_TRACE would keep every profiled prove's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from starky_bn254_tpu_torch.utils import timing as tm

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
        torch.cuda.synchronize()
        w0 = time.time_ns()
        with tm.recording(tm.NOOP):
            run()
        torch.cuda.synchronize()
        w1 = time.time_ns()
    wall_s = (w1 - w0) / 1e9
    by_name = _kernels_by_name(prof)
    total_ms = sum(sum(v) for v in by_name.values())
    launches = sum(len(v) for v in by_name.values())
    if launches == 0:
        raise AssertionError("the profiler saw no kernel on the card during a prove")
    busy = 100 * _busy_ns(prof, w0, w1) / (w1 - w0)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in ranked[:12]:
        print(f"{label}: kernel {name}: {sum(durs):.2f} ms in {len(durs)} launches")
    hand = {}
    for kernel, names in TRACE_NAMES.items():
        ms = sum(sum(by_name.get(n, [])) for n in names)
        count = sum(len(by_name.get(n, [])) for n in names)
        counted = launch_counts()[kernel] - before[kernel]
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

    from starky_bn254_tpu_torch.stark import (VerificationError, proof_from_bytes, proof_to_bytes,
                                              prove, verify)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    dev = trace.device
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    first_proof = (first or (lambda: prove(air, trace, pi, cfg)))()  # no device named: the card
    torch.cuda.synchronize()
    prove_first_s = time.perf_counter() - t0
    launches = launch_counts()
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
    aux_w = nc * (len(air.permutation_pairs()) + logup.table_aux_width(air.lookup_tables())
                  + air.aux_extra_width())
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
    """The bench's main path (bench.py:48-238) at its full size (its
    Poseidon-leaf twin, g1-poseidon, is proved in phase_parity)."""
    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig, logup, prove

    air = G1ExpAir(G1_NUM_IO)
    cfg = StarkConfig.standard_fast_config("keccak")
    inputs = g1_inputs(0, G1_NUM_IO, bn254)  # bench.py: default_rng(0)
    trace, pi, aux_w = exp_statement("g1", air, inputs, G1_SHAPES, dev,
                                     f"native build {native_build_s:.2f} s")
    r = drive("g1", air, trace, pi, cfg, G1_WARM_PROVES)
    reject_swapped("g1", air, trace, pi, cfg)
    r["trace"], r["pi"] = trace, pi  # the sharded phase proves the same statement

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
    phase's whole-trace copy to the host."""
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

    r = drive(label, air, trace, pi, cfg, FQ12_WARM_PROVES, first=entry, check=check)
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
    # no composition probe here (41 s under the profiler; NVIDIA H100 80GB
    # HBM3, 700.00 W): g2's gives the larger of the two words-per-cell
    # measures _TEMPS_PER_CELL is set from
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
    its default config: G1 and G2 MSMs over MSM_POINTS points and an Fq
    multi-exponentiation of MSM_POINTS terms, each result held against the
    host oracle's, and hash-to-G2 on one message."""
    import numpy as np

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.compose import (prove_fq_multiexp, prove_g1_msm, prove_g2_msm,
                                                prove_hash_to_g2, verify_fq_multiexp, verify_g1_msm,
                                                verify_g2_msm, verify_hash_to_g2)
    from starky_bn254_tpu_torch.stark import StarkConfig

    rng = np.random.default_rng(0)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    points = [bn254.g1_mul(bn254.G1_GEN, rand_scalar()) for _ in range(MSM_POINTS)]
    scalars = [rand_scalar() for _ in range(MSM_POINTS)]
    want = None
    for p, k in zip(points, scalars):
        want = bn254.g1_add(want, bn254.g1_mul(p, k))

    def counted(label: str, cfg, run):
        """run() with every launch count reset just before and read just
        after; each kernel of a prove under cfg must have launched."""
        reset_launches()
        out = run()
        launches = launch_counts()
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

    g2_points = [bn254.g2_mul(bn254.G2_GEN, rand_scalar()) for _ in range(MSM_POINTS)]
    g2_scalars = [rand_scalar() for _ in range(MSM_POINTS)]
    g2_want = None
    for p, k in zip(g2_points, g2_scalars):
        g2_want = bn254.g2_add(g2_want, bn254.g2_mul(p, k))
    t0 = time.perf_counter()
    (proof, result, air, n_real), g2_launches = counted(
        "prove_g2_msm", cfg, lambda: prove_g2_msm(g2_points, g2_scalars))  # the card
    prove_s = time.perf_counter() - t0
    if result != g2_want:
        raise AssertionError("msm: prove_g2_msm's result differs from the host oracle's sum")
    t0 = time.perf_counter()
    if verify_g2_msm(proof, result, air, n_real) is not True:
        raise AssertionError("msm: verify_g2_msm did not accept")
    verify_s = time.perf_counter() - t0
    if verify_g2_msm(proof, bn254.g2_double(result), air, n_real):
        raise AssertionError("msm: verify_g2_msm accepted a wrong result")
    print(f"msm: prove_g2_msm({MSM_POINTS} points) -> {type(air).__name__}({air.num_io}, "
          f"{air.range_check}, {air.io_binding}) {prove_s:.3f} s (oracle, tracegen and prove); "
          f"result equals the host oracle's sum; verify_g2_msm accepts ({verify_s:.3f} s) and "
          f"refuses a wrong result")

    xs = [int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(MSM_POINTS)]
    exps = [rand_scalar() for _ in range(MSM_POINTS)]
    fq_want = 1
    for x, e in zip(xs, exps):
        fq_want = fq_want * pow(x, e, bn254.P_BN) % bn254.P_BN
    t0 = time.perf_counter()
    (proof, result, air, n_real), fq_launches = counted(
        "prove_fq_multiexp", cfg, lambda: prove_fq_multiexp(xs, exps))  # the card
    prove_s = time.perf_counter() - t0
    if result != fq_want:
        raise AssertionError("msm: prove_fq_multiexp's result differs from the host oracle's product")
    t0 = time.perf_counter()
    if verify_fq_multiexp(proof, result, air, n_real) is not True:
        raise AssertionError("msm: verify_fq_multiexp did not accept")
    verify_s = time.perf_counter() - t0
    if verify_fq_multiexp(proof, result * xs[0] % bn254.P_BN, air, n_real):
        raise AssertionError("msm: verify_fq_multiexp accepted a wrong result")
    print(f"msm: prove_fq_multiexp({MSM_POINTS} terms) -> {type(air).__name__}({air.num_io}, "
          f"{air.range_check}, {air.io_binding}) {prove_s:.3f} s (oracle, tracegen and prove); "
          f"result equals the host oracle's product; verify_fq_multiexp accepts ({verify_s:.3f} s) "
          f"and refuses a wrong result")
    msg = b"chip_smoke hash-to-G2"
    t0 = time.perf_counter()
    (proof, p_twist, result, air), h2g2_launches = counted(
        "prove_hash_to_g2", cfg, lambda: prove_hash_to_g2(msg))
    prove_s = time.perf_counter() - t0
    if not bn254.g2_is_on_curve(p_twist) or verify_hash_to_g2(msg, proof, result, air) is not True:
        raise AssertionError("msm: verify_hash_to_g2 did not accept")
    print(f"msm: prove_hash_to_g2 -> G2ExpAir(1, {air.range_check}, {air.io_binding}) {prove_s:.3f} s; "
          f"verify_hash_to_g2 accepts")
    return dict(g1_launches=g1_launches, g2_launches=g2_launches, fq_launches=fq_launches,
                h2g2_launches=h2g2_launches)


def phase_pipelined(dev) -> dict:
    """The bench's service tier (bench.py:196-236): PIPE_BATCHES batches of
    G1ExpAir(128), each from its own seed, through prove_pipelined, against
    sequential proves of the same batches."""
    import torch

    from starky_bn254_tpu_torch import bn254, xnp
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

    reset_launches()
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
    launches = launch_counts()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"g1-pipelined: kernels not launched: {missing}")
    fill = PIPE_BATCHES * G1_NUM_IO / pipe_s
    steady = (PIPE_BATCHES - 1) * G1_NUM_IO / (stamps[-1] - stamps[0])

    gen_s, prove_s, seq_bytes = [], [], []
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
        seq_bytes.append(proof_to_bytes(want))
        if proof_to_bytes(proof) != seq_bytes[-1]:
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
                worker_s=worker_s, batches=batches, seq_bytes=seq_bytes)


def check_shard_launches(label: str, cfg, d: int) -> list[dict]:
    """Every sharded commit since the shard counters' reset launched K1 and
    cfg's leaf hasher (K2 under keccak, K3 under Poseidon) on every one of
    its d shards (parallel.sharded.SHARD_LAUNCHES)."""
    from starky_bn254_tpu_torch.parallel import sharded

    recs = [dict(r) for r in sharded.SHARD_LAUNCHES]
    bad = [r for r in recs if r["hasher"] != cfg.fri.merkle_hash or len(r["k1"]) != d
           or min(r["k1"]) <= 0 or min(r["leaf"]) <= 0]
    if not recs or bad:
        raise AssertionError(f"{label}: a sharded commit did not launch K1 and its leaf hasher on "
                             f"every shard: {recs}")
    return recs


def collective_counts() -> dict:
    from starky_bn254_tpu_torch.parallel import sharded

    return {k: dict(calls=sharded.CALLS[k], bytes=sharded.BYTES[k], copy_bytes=sharded.COPY_BYTES[k])
            for k in sharded.KINDS}


def phase_sharded(dev, g1: dict, parity: dict, pipelined: dict) -> dict:
    """Sharded proving on one card: G1ExpAir(128) over SHARDS shards of it
    under the keccak config and under the Poseidon config, each first prove
    with the kernel and shard counters reset just before and read just
    after (K1 and the leaf hasher on every shard of every sharded commit),
    its bytes held against the single prove of the same statement (the g1
    phase's, the parity phase's g1-poseidon), verified; a tampered opening
    rejected; one more keccak prove timed with its phases against g1's; the
    graft entry on the card against its plain path; dryrun_multichip over
    DRYRUN_SHARDS shards of the card; prove_pipelined of two g1 batches over
    two shards, each proof equal to its sequential prove (the g1-pipelined
    phase's)."""
    import numpy as np
    import torch

    from starky_bn254_tpu_torch import graft_entry
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.parallel import sharded
    from starky_bn254_tpu_torch.stark import (StarkConfig, proof_from_bytes, proof_to_bytes, prove,
                                              prove_pipelined, verify)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    air = G1ExpAir(G1_NUM_IO)
    trace, pi = g1.pop("trace"), g1.pop("pi")
    mesh = sharded.make_mesh(SHARDS, device=dev)
    keccak_cfg = StarkConfig.standard_fast_config("keccak")
    out = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for label, cfg, want in (("sharded", keccak_cfg, proof_to_bytes(g1["proof"])),
                             ("sharded-poseidon", StarkConfig.standard_fast_config("poseidon"),
                              parity["g1_poseidon_bytes"])):
        reset_launches()
        sharded.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove(air, trace, pi, cfg, mesh=mesh)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        missing = [k for k in path_kernels(cfg) if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels not launched: {missing}")
        shards = check_shard_launches(label, cfg, SHARDS)
        coll = collective_counts()
        if proof_to_bytes(proof) != want:
            raise AssertionError(f"{label}: the proof over {SHARDS} shards differs from the single "
                                 f"prove's bytes")
        t0 = time.perf_counter()
        if verify(air, proof, cfg) is not True:
            raise AssertionError(f"{label}: verify did not accept the sharded proof")
        verify_s = time.perf_counter() - t0
        print(f"{label}: G1ExpAir({G1_NUM_IO}) over {SHARDS} shards of {dev}: "
              f"{cfg.fri.merkle_hash} leaves, first prove {first_s:.3f} s, the single prove's "
              f"bytes, verify_s {verify_s:.3f}; launches {json.dumps(launches)}")
        for r in shards:
            print(f"{label}: {r['fn']}: K1 launches per shard {r['k1']}, {r['hasher']} leaf "
                  f"launches per shard {r['leaf']}")
        print(f"{label}: collectives (calls, bytes between shards, bytes copied between devices) "
              f"{json.dumps(coll)}")
        out[label] = dict(launches=launches, first_s=first_s, verify_s=verify_s, shards=shards,
                          collectives=coll)
        if label == "sharded":
            bad = proof_from_bytes(proof_to_bytes(proof))
            bad.openings.trace_zeta[0, 0] ^= np.uint64(1)
            expect_rejected(label, "a tampered opening", lambda: verify(air, bad, cfg))
        del proof

    tt = TimingTree("prove", dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove(air, trace, pi, keccak_cfg, timing=tt, mesh=mesh)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    phases = _phase_ms(tt)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"sharded: prove_s {prove_s:.3f} over {SHARDS} shards of one card against the g1 "
          f"phase's {g1['prove_s']:.3f} single; peak_device_GiB {peak_gib:.2f}")
    print(f"sharded: warm prove phases over {SHARDS} shards against g1's median (ms)")
    for key, ms in phases.items():
        print(f"sharded:   {ms:9.1f}  {g1['phases'].get(key, float('nan')):9.1f}  {key}")
    del trace

    fn, args = graft_entry.entry()  # no device named: the card
    reset_launches()
    got = fn(*args)
    entry_launches = launch_counts()
    check_equal("graft_entry.entry()", got, fn(args[0].cpu()).to(dev))
    if entry_launches["ntt"] <= 0 or entry_launches["poseidon_sponge_and_grind"] <= 0:
        raise AssertionError(f"graft_entry.entry(): K1 and K3 not launched: {entry_launches}")
    print(f"sharded: graft_entry.entry() on the card equals its plain path on the CPU; launches "
          f"{json.dumps(entry_launches)}")
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(DRYRUN_SHARDS, device=dev)
    print(f"sharded: dryrun_multichip({DRYRUN_SHARDS}, device={dev}) in "
          f"{time.perf_counter() - t0:.3f} s: {json.dumps(dry)}")

    pipe_mesh = sharded.make_mesh(PIPE_MESH_SHARDS, device=dev)
    reset_launches()
    sharded.reset_counters()
    t0 = time.perf_counter()
    proofs = prove_pipelined(air, pipelined["batches"][:2], keccak_cfg, mesh=pipe_mesh)
    pipe_s = time.perf_counter() - t0
    pipe_launches = launch_counts()
    check_shard_launches("sharded-pipelined", keccak_cfg, PIPE_MESH_SHARDS)
    for i, proof in enumerate(proofs):
        if proof_to_bytes(proof) != pipelined["seq_bytes"][i]:
            raise AssertionError(f"sharded-pipelined: proof {i} differs from its sequential prove")
    print(f"sharded: prove_pipelined of 2 x G1ExpAir({G1_NUM_IO}) over {PIPE_MESH_SHARDS} shards in "
          f"{pipe_s:.3f} s, each proof its sequential prove's bytes; launches "
          f"{json.dumps(pipe_launches)}")
    out.update(prove_s=prove_s, phases=phases, peak_gib=peak_gib, dryrun=dry,
               entry_launches=entry_launches, pipelined_s=pipe_s, pipelined_launches=pipe_launches)
    return out


def sharded_shape_rows(field, words_any, bounds: Bounds) -> dict[str, list[dict]]:
    """K1, K2 and K3 at the per-shard shapes of the sharded phase's G1ExpAir(128)
    over SHARDS shards: each shard's columns (404 / 4 = 101, and 390 padded
    to 392 / 4 = 98) interpolated at 65536 rows, read in place from the
    whole matrix as the commit does, and extended to 131072; each row
    shard's leaves, 131072 / 4 = 32768 rows of 404 and of 390 (a view of
    392 columns), hashed by K2 (keccak) and K3 (Poseidon); each against its
    plain version."""
    from starky_bn254_tpu_torch import keccak, ntt, poseidon

    rows = {"ntt": [], "keccak_sponge": [], "poseidon_sponge_and_grind": []}

    def record(kernel, label, run, plain, b, shape, **extra):
        want, plain_ms = timed_call(plain)
        err = check_equal(label, run(), want)
        del want
        r = dict(shape=shape, max_abs_err=err, ms=cuda_ms(run), plain_ms=plain_ms, **extra, **b)
        show(label + ", equal", r)
        rows[kernel].append({k: v for k, v in r.items() if k not in ("bytes", "int_ops")})

    for width in G1_SHAPES[0][1], G1_SHAPES[1]:
        padded = width + (-width) % SHARDS
        c = padded // SHARDS
        whole = field(65536, padded)
        view = whole[:, :c]  # shard 0's columns, row stride `padded`
        record("ntt", f"ntt [65536, {c}] inverse (shard of {padded}, in place)",
               lambda: ntt.ntt(view, True), lambda: ntt._ntt_plain(view.contiguous(), True),
               bounds.ntt(65536, c, True), [65536, c], inverse=True, row_stride=padded)
        del whole, view
        x = field(131072, c)
        record("ntt", f"ntt [131072, {c}] forward (shard)", lambda: ntt.ntt(x),
               lambda: ntt._ntt_plain(x), bounds.ntt(131072, c, False), [131072, c], inverse=False)
        del x
        n = 131072 // SHARDS
        block = words_any(n, padded)[:, :width]
        record("keccak_sponge", f"keccak hash_no_pad [{n}, {width}] (row shard)",
               lambda: keccak.hash_no_pad(block),
               lambda: keccak._sponge_plain(None, block, True, keccak.DIGEST),
               bounds.keccak(n, width), [n, width], row_stride=padded)
        block = field(n, padded)[:, :width]
        record("poseidon_sponge_and_grind", f"poseidon hash_no_pad [{n}, {width}] (row shard)",
               lambda: poseidon.hash_no_pad(block), lambda: poseidon._sponge_plain(None, block, 4),
               bounds.poseidon(n, -(-width // poseidon.RATE), width, 4), [n, width],
               row_stride=padded, form=poseidon._sponge_form(n))
        del block
    return rows


def _ksum(rows: list[dict]) -> dict[str, int]:
    return {k: sum(r[k] for r in rows) for k in REGION_KERNELS}


def _kdiff(a: dict, b: dict) -> dict[str, int]:
    return {k: a[k] - b[k] for k in REGION_KERNELS}


def phase_batch(dev) -> dict:
    """Shared-FRI batch proving (stark/batch_prove.py) at full width: the
    BATCH_STATEMENTS, mixed families and one mixed height, under the
    bench's config."""
    import numpy as np
    import torch

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import (BatchStarkProof, StarkConfig, VerificationError,
                                              proof_from_bytes, proof_to_bytes, prove,
                                              prove_batch_fri, verify_batch_fri)
    from starky_bn254_tpu_torch.stark.prover import retained_lde_bytes
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    cfg = StarkConfig.standard_fast_config("keccak")
    stmts = []
    for label, cls_name, num_io, seed in BATCH_STATEMENTS:
        g1 = cls_name == "G1ExpAir"
        air = (G1ExpAir if g1 else FqExpAir)(num_io)
        inputs = (g1_inputs if g1 else fq_exp_inputs)(seed, num_io, bn254)
        t0 = time.perf_counter()
        trace, pi = air.generate_trace_and_pi(inputs)
        gen_s = time.perf_counter() - t0
        print(f"batch: {label}: {cls_name}({num_io}, {air.range_check}, {air.io_binding}) trace "
              f"{trace.shape}, {len(pi)} public inputs, tracegen_s {gen_s:.3f}", flush=True)
        stmts.append((label, air, xnp.to_torch(trace, dev), pi))
    items = [(air, trace, pi) for _, air, trace, pi in stmts]
    airs = [air for air, _, _ in items]
    lde_bytes = sum(retained_lde_bytes(air, trace.shape[0], cfg) for air, trace, _ in items)
    print(f"batch: the statements' retained LDEs sum to {lde_bytes / 1e9:.3f} GB")

    # each statement alone, in this run: its launches by region (the
    # counted prove, also the warm-up), then one timed prove and its bytes
    singles = []
    with launch_regions() as single_reg:
        for label, air, trace, pi in stmts:
            before = launch_counts()
            prove(air, trace, pi, cfg)
            after = launch_counts()
            singles.append(dict(label=label, launches={k: after[k] - before[k] for k in KERNELS}))
    for (label, air, trace, pi), single, share, fri_l, grind_l in zip(
            stmts, singles, single_reg.log["statement"], single_reg.log["fri"], single_reg.log["grind"]):
        if _ksum([share, fri_l]) != _ksum([single["launches"]]):
            raise AssertionError(f"batch: {label}: a single prove launched outside its statement "
                                 f"path and FRI")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove(air, trace, pi, cfg)
        torch.cuda.synchronize()
        single.update(prove_s=time.perf_counter() - t0, bytes=len(proof_to_bytes(proof)),
                      share=share, fri=fri_l, grind=grind_l)
        print(f"batch: {label} alone: prove_s {single['prove_s']:.3f}, {single['bytes']} bytes, "
              f"launches {json.dumps(single['launches'])} (its FRI {json.dumps(fri_l)})", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with launch_regions() as reg:
        t0 = time.perf_counter()
        batch = prove_batch_fri(items, cfg)  # no device named: the card
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = launch_counts()
    # the expected counts: each statement's share as it launched alone, and
    # one FRI as a 65536-row statement's, but for the grind's batches
    for single, share in zip(singles, reg.log["statement"]):
        if _ksum([share]) != _ksum([single["share"]]):
            raise AssertionError(f"batch: statement {single['label']} launched {share} in the batch, "
                                 f"{single['share']} alone")
    (fri_b,), (grind_b,) = reg.log["fri"], reg.log["grind"]
    big = singles[0]
    if _kdiff(fri_b, grind_b) != _kdiff(big["fri"], big["grind"]):
        raise AssertionError(f"batch: the shared FRI launched {fri_b} (grind {grind_b}), a "
                             f"{BATCH_STATEMENTS[0][0]} FRI {big['fri']} (grind {big['grind']})")
    expected = _ksum([s["share"] for s in singles] + [fri_b])
    if _ksum([launches]) != expected or min(launches.values()) <= 0:
        raise AssertionError(f"batch: launches {launches}, expected {expected}")
    print(f"batch: launches in the first batch prove {json.dumps(launches)}: but the field kernels', "
          f"the four statements' shares as proved alone + one shared FRI {json.dumps(fri_b)} "
          f"(grind {json.dumps(grind_b)})")

    times, phases = [], []
    for _ in range(BATCH_WARM_PROVES):
        tt = TimingTree("prove_batch", dev)
        t0 = time.perf_counter()
        again = prove_batch_fri(items, cfg, timing=tt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(_phase_ms(tt))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stmt_bytes = [proof_to_bytes(st) for st in batch.statements]
    if [proof_to_bytes(st) for st in again.statements] != stmt_bytes:
        raise AssertionError("batch: two batch proves of the same statements differ")
    t0 = time.perf_counter()
    if verify_batch_fri(airs, batch, cfg) is not True:
        raise AssertionError("batch: verify_batch_fri did not accept")
    verify_s = time.perf_counter() - t0

    def copy_batch():
        return BatchStarkProof([proof_from_bytes(b) for b in stmt_bytes])

    bad_opening = copy_batch()
    tz = bad_opening.statements[-1].openings.trace_zeta
    tz[0, 0] = np.uint64((int(tz[0, 0]) + 1) % ((1 << 64) - (1 << 32) + 1))
    bad_cap = copy_batch()
    bad_cap.statements[0].trace_cap[0, 0] ^= np.uint64(1)
    for what, bad in (("a tampered opening of the small statement", bad_opening),
                      ("a flipped trace cap of a large statement", bad_cap)):
        try:
            verify_batch_fri(airs, bad, cfg)
        except VerificationError as e:
            print(f"batch: {what} rejected ({e})")
        else:
            raise AssertionError(f"batch: {what} was accepted")

    medians = {k: statistics.median([p[k] for p in phases if k in p]) for k in phases[0]}
    print(f"batch: warm batch prove phases, median of {BATCH_WARM_PROVES} (ms)")
    for key, ms in medians.items():
        print(f"batch:   {ms:9.1f}  {key}")
    batch_bytes = sum(len(b) for b in stmt_bytes)
    singles_bytes = sum(s["bytes"] for s in singles)
    singles_s = sum(s["prove_s"] for s in singles)
    prove_s = statistics.median(times)
    print(f"batch: prove_s median {prove_s:.3f} ({BATCH_WARM_PROVES} warm batch proves; first "
          f"{first_s:.3f}) against {singles_s:.3f} for the four single proves; shared fri "
          f"{medians['shared fri']:.1f} ms; verify_batch_fri {verify_s:.3f} s; batch proof "
          f"{batch_bytes} bytes against {singles_bytes} for the four single proofs "
          f"({100 * batch_bytes / singles_bytes:.1f} %); peak_device_GiB {peak_gib:.2f}")
    return dict(launches=launches, items=items, airs=airs, stmt_bytes=stmt_bytes, prove_s=prove_s,
                first_s=first_s, phases=medians, peak_gib=peak_gib, singles=singles,
                batch_bytes=batch_bytes, singles_bytes=singles_bytes, verify_s=verify_s)


def watch_lde_readers():
    """Wrap the three readers of an LDE in a prove (constraint composition,
    the openings' evaluations, the opening combine). Each call appends
    (reader, bytes of the host-held LDEs it was handed, bytes copied from
    host to card during it, the device of its result) to the returned
    list; the second value restores the readers."""
    from starky_bn254_tpu_torch import ntt, xnp
    from starky_bn254_tpu_torch.stark import prover

    reads = []

    def host_bytes(mats):
        return sum(m.numel() * 8 for m in mats if m is not None and m.device.type == "cpu")

    def watch(what, plain, mats_of):
        def reader(*args, **kwargs):
            before = xnp.H2D_BYTES
            out = plain(*args, **kwargs)
            reads.append((what, host_bytes(mats_of(args)), xnp.H2D_BYTES - before, out.device))
            return out
        return reader

    plain = (prover.evaluate_composition, ntt.eval_from_lde, prover._batch_opening_poly)
    prover.evaluate_composition = watch("composition", plain[0], lambda a: a[1:3])
    ntt.eval_from_lde = watch("openings", plain[1], lambda a: a[:1])
    prover._batch_opening_poly = watch("combine", plain[2], lambda a: list(a[0]) + list(a[3]))

    def unwatch():
        prover.evaluate_composition, ntt.eval_from_lde, prover._batch_opening_poly = plain

    return reads, unwatch


def phase_batch_offload(dev, batch: dict) -> dict:
    """The batch phase's statements with STARKY_LDE_DEVICE_BYTES=0: every
    LDE streamed into pinned host memory and read back by its consumers;
    then the streaming commit in blocks of several chunks against the
    whole-matrix commit."""
    import torch

    from starky_bn254_tpu_torch import xnp
    from starky_bn254_tpu_torch.stark import StarkConfig, proof_to_bytes, prove_batch_fri, prover

    cfg = StarkConfig.standard_fast_config("keccak")
    ldes = []
    plain = prover._commit_streaming

    def watched(*args, **kwargs):
        c = plain(*args, **kwargs)
        ldes.append((c.lde.device.type, c.lde.is_pinned()))
        return c

    prover._commit_streaming = watched
    reads, unwatch = watch_lde_readers()
    with env_set("STARKY_LDE_DEVICE_BYTES", "0"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        xnp.H2D_BYTES = 0
        proof = prove_batch_fri(batch["items"], cfg)
        torch.cuda.synchronize()
        launches, h2d = launch_counts(), xnp.H2D_BYTES
        unwatch()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            prove_batch_fri(batch["items"], cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    prover._commit_streaming = plain
    if [proof_to_bytes(st) for st in proof.statements] != batch["stmt_bytes"]:
        raise AssertionError("batch-offload: the offloaded batch differs from the on-card batch")
    if _ksum([launches]) != _ksum([batch["launches"]]) or launches["field"] <= 0:
        raise AssertionError(f"batch-offload: launches {launches}, the on-card batch's "
                             f"{batch['launches']}")
    n_commits = 2 * len(batch["items"])
    if ldes[:n_commits] != [("cpu", True)] * n_commits:
        raise AssertionError(f"batch-offload: the commits' LDEs lay on {ldes[:n_commits]}")
    # every reader of an LDE was handed host LDEs, copied each of their
    # rows to the card (composition: with its halo) and left its result there
    has_aux = [bool(a.permutation_pairs() or a.lookup_tables() or a.aux_extra_width())
               for a in batch["airs"]]
    want_calls = {"composition": len(has_aux), "openings": sum(5 if a else 3 for a in has_aux),
                  "combine": len(has_aux)}
    calls = {k: sum(r[0] == k for r in reads) for k in want_calls}
    if calls != want_calls:
        raise AssertionError(f"batch-offload: LDE readers called {calls}, expected {want_calls}")
    for what, host_bytes, copied, out_dev in reads:
        if host_bytes <= 0 or out_dev != dev or (
                copied < host_bytes if what == "composition" else copied != host_bytes):
            raise AssertionError(f"batch-offload: {what} was handed {host_bytes} bytes of host LDE, "
                                 f"copied {copied} bytes to the card and left its result on {out_dev}")
    by_reader = {k: sum(r[2] for r in reads if r[0] == k) for k in want_calls}
    if peak_gib >= batch["peak_gib"]:
        raise AssertionError(f"batch-offload: peak device memory {peak_gib:.2f} GiB, not below the "
                             f"on-card batch's {batch['peak_gib']:.2f} GiB")
    prove_s = statistics.median(times)
    print(f"batch-offload: every statement's bytes and the launches {json.dumps(launches)} equal "
          f"the on-card batch's but the field kernels' (on the card {batch['launches']['field']}); "
          f"{n_commits} streamed commits, each LDE in pinned host memory")
    print(f"batch-offload: every LDE reader ({json.dumps(calls)} calls) read its host LDEs onto the "
          f"card and computed there; host to card by reader (GB): "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in by_reader.items())
          + f", the commits' uploads of host-built aux columns {(h2d - sum(by_reader.values())) / 1e9:.3f}")
    print(f"batch-offload: prove_s median {prove_s:.3f} (2 warm; on the card {batch['prove_s']:.3f}); "
          f"peak_device_GiB {peak_gib:.2f} (on the card {batch['peak_gib']:.2f}); host to card "
          f"{h2d / 1e9:.3f} GB a batch prove")

    # the streaming commit in several blocks, the sponge state carried
    # across them, at the G1 trace's shape
    trace = batch["items"][0][1]
    with env_set("STARKY_COMMIT_BLOCK_CELLS", str(STREAM_BLOCK_CELLS)):
        for hasher in ("keccak", "poseidon"):
            hcfg = StarkConfig.standard_fast_config(hasher)
            whole = prover.commit(trace, hcfg)
            streamed = prover._commit_streaming(trace, hcfg)
            if not torch.equal(xnp.on_device(streamed.lde, dev), whole.lde) or any(
                    not torch.equal(a, b) for a, b in zip(streamed.tree.levels, whole.tree.levels)):
                raise AssertionError(f"batch-offload: streaming commit ({hasher}) differs from the "
                                     f"whole-matrix commit")
            print(f"batch-offload: streaming commit of [{trace.shape[0]}, {trace.shape[1]}] in blocks "
                  f"of {STREAM_BLOCK_CELLS} cells ({hasher}), offloaded, equals the whole-matrix "
                  f"commit")
            del whole, streamed
    return dict(launches=launches, prove_s=prove_s, peak_gib=peak_gib, h2d_bytes=h2d)


def phase_verify_batch(g1: dict, fq: dict, g2: dict) -> dict:
    """verify_batch (stark/batch_verify.py) over the g1, fq and g2 phases'
    proofs and the batch fixture's single FqMulAir(256) proof, with one
    proof tampered and one chain check that fails."""
    import numpy as np

    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
    from starky_bn254_tpu_torch.compose import G1Msm
    from starky_bn254_tpu_torch.stark import (BatchItem, StarkConfig, proof_from_bytes,
                                              proof_to_bytes, verify_batch)

    cfg = StarkConfig.standard_fast_config("keccak")
    with np.load(BATCH_FIXTURE) as f:
        fq_mul = proof_from_bytes(f["single"].tobytes())
    bad = proof_from_bytes(proof_to_bytes(fq["proof"]))
    bad.public_inputs[0] ^= np.uint64(1)
    items = [
        BatchItem(air=G1ExpAir(G1_NUM_IO), proof=g1["proof"], cfg=cfg, label="g1 (not an MSM chain)",
                  chain_check=lambda pi: G1Msm().check_chain(pi, G1_NUM_IO, bn254.G1_GEN)),
        BatchItem(air=FqExpAir(G1_NUM_IO), proof=fq["proof"], cfg=cfg, label="fq"),
        BatchItem(air=FqExpAir(G1_NUM_IO), proof=bad, cfg=cfg, label="fq (tampered)"),
        BatchItem(air=G2ExpAir(G1_NUM_IO), proof=g2["proof"], cfg=cfg, label="g2"),
        BatchItem(air=FqMulAir(256), proof=fq_mul, cfg=StarkConfig.test_config(),
                  label="FqMulAir(256), the batch fixture's single statement"),
    ]
    res = verify_batch(items)
    if res.results != [False, True, False, True, True] or res.errors[0] != "chain check failed" \
            or not res.errors[2] or res.groups != 4:
        raise AssertionError(f"verify-batch: results {res.results}, errors {res.errors}, "
                             f"groups {res.groups}")
    for it, ok, err, t in zip(items, res.results, res.errors, res.per_proof_s):
        print(f"verify-batch: {it.label}: {'accepted' if ok else 'refused: ' + err} ({t:.3f} s)")
    print(f"verify-batch: {len(items)} proofs in {res.groups} layout groups, {res.total_s:.3f} s; "
          f"exactly the tampered proof and the failing chain check reported")
    return dict(total_s=res.total_s, groups=res.groups)


def phase_lde_budget(dev) -> None:
    """The summed device budget of retained LDE (STARKY_LDE_DEVICE_BYTES)
    measured at its edge, under standard_fast_config(), from host traces.
    The edge batch holds as many Fq12ExpAir(128) statements as fit the
    budget and then as many G2ExpAir(128) (the G2 statements first, so the
    widest compositions run with the most LDE retained). One Fq12ExpAir(128)
    alone and the edge batch are each proved on the card and again
    offloaded (STARKY_LDE_DEVICE_BYTES=0); then the edge batch with one more
    G2 statement, just over the budget, which the default rule offloads.
    Each prove prints its retained bytes, prove_s, peak device memory
    (allocated and reserved), bytes copied from host to card, and per
    statement the composition's ms, row-block height and the memory free
    when it picked that height (the driver's free memory; the allocator's
    cache beside it). The edge batch proved on the card is verified."""
    import torch

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.fq12_exp import Fq12ExpAir
    from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
    from starky_bn254_tpu_torch.compose import Fq12MultiExp, pad_instances
    from starky_bn254_tpu_torch.stark import (StarkConfig, composition, prove, prove_batch_fri, prover,
                                              verify_batch_fri)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    cfg = StarkConfig.standard_fast_config()
    budget = prover._env_int("STARKY_LDE_DEVICE_BYTES", prover.LDE_DEVICE_BYTES)
    t0 = time.perf_counter()
    fq12 = Fq12ExpAir(FQ12_NUM_IO, range_check="logup", io_binding="auto")
    xs, exps = multiexp_terms(0, FQ12_NUM_IO, False, bn254)
    fq12_item = (fq12,) + fq12.generate_trace_and_pi(
        pad_instances(Fq12MultiExp().build_inputs(xs, exps)[0]))
    g2 = G2ExpAir(G1_NUM_IO)
    g2_item = (g2,) + g2.generate_trace_and_pi(g2_inputs(0, G1_NUM_IO, bn254))
    print(f"lde-budget: Fq12ExpAir({FQ12_NUM_IO}) {fq12_item[1].shape} and G2ExpAir({G1_NUM_IO}) "
          f"{g2_item[1].shape} traced in {time.perf_counter() - t0:.3f} s; budget {budget} bytes "
          f"({budget / 2**30:.2f} GiB)", flush=True)
    per_fq12 = prover.retained_lde_bytes(fq12, fq12_item[1].shape[0], cfg)
    per_g2 = prover.retained_lde_bytes(g2, g2_item[1].shape[0], cfg)
    n_fq12 = budget // per_fq12
    n_g2 = (budget - n_fq12 * per_fq12) // per_g2
    if n_fq12 < 1:
        raise AssertionError(f"lde-budget: one Fq12ExpAir({FQ12_NUM_IO}) alone passes the budget")

    blocks = []
    plain_pick = composition.pick_block_rows

    def pick(n_lde, width, device):
        rows = plain_pick(n_lde, width, device)
        free, _ = torch.cuda.mem_get_info(device)
        cache = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        blocks.append(f"{n_lde // rows} x {rows} rows (free {free / 2**30:.1f}, cache {cache / 2**30:.1f} GiB)")
        return rows

    composition.pick_block_rows = pick
    prove(*g2_item, cfg)  # warm-up: device tables, the allocator's first blocks

    def run(label, items, force_offload: bool):
        retained = sum(prover.retained_lde_bytes(a, t.shape[0], cfg) for a, t, _ in items)
        with env_set("STARKY_LDE_DEVICE_BYTES", "0" if force_offload else str(budget)):
            offloaded = prover.offload_ldes(retained)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            xnp.H2D_BYTES = 0
            blocks.clear()
            tt = TimingTree("prove_batch", dev)
            t0 = time.perf_counter()
            batch = prove_batch_fri(items, cfg, timing=tt)
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        peak, reserved = (torch.cuda.max_memory_allocated(dev) / 2**30,
                          torch.cuda.max_memory_reserved(dev) / 2**30)
        ms = _phase_ms(tt)
        print(f"lde-budget: {label}, retained LDE {retained / 2**30:.2f} GiB, "
              f"{'offloaded to pinned host memory' if offloaded else 'on the card'}: prove_s "
              f"{prove_s:.3f}, peak_device_GiB {peak:.2f} (reserved {reserved:.2f} of "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}), host to card "
              f"{xnp.H2D_BYTES / 1e9:.3f} GB", flush=True)
        for j, (item, rows) in enumerate(zip(items, blocks)):
            print(f"lde-budget:   s{j} {type(item[0]).__name__}: composition "
                  f"{ms[f's{j} constraint composition']:.1f} ms, {rows}")
        return batch, offloaded

    for force_offload in (False, True):
        run(f"1 x Fq12ExpAir({FQ12_NUM_IO})", [fq12_item], force_offload)
    edge = [g2_item] * n_g2 + [fq12_item] * n_fq12
    label = f"edge: {n_g2} x G2ExpAir({G1_NUM_IO}) + {n_fq12} x Fq12ExpAir({FQ12_NUM_IO})"
    batch, offloaded = run(label, edge, False)
    if offloaded:
        raise AssertionError("lde-budget: the batch under the budget was offloaded")
    t0 = time.perf_counter()
    if verify_batch_fri([a for a, _, _ in edge], batch, cfg) is not True:
        raise AssertionError("lde-budget: verify_batch_fri did not accept")
    print(f"lde-budget: verify_batch_fri accepts the edge batch ({time.perf_counter() - t0:.3f} s)")
    del batch
    run(label, edge, True)
    _, offloaded = run(f"over: {n_g2 + 1} x G2ExpAir({G1_NUM_IO}) + {n_fq12} x "
                       f"Fq12ExpAir({FQ12_NUM_IO})", [g2_item] + edge, False)
    if not offloaded:
        raise AssertionError("lde-budget: the batch over the budget stayed on the card")
    composition.pick_block_rows = plain_pick


def expect_rejected(label: str, what: str, run) -> None:
    """run() must raise VerificationError."""
    from starky_bn254_tpu_torch.stark import VerificationError

    try:
        run()
    except VerificationError as e:
        print(f"{label}: {what} rejected ({e})")
    else:
        raise AssertionError(f"{label}: {what} was accepted")


def phase_parity(dev) -> dict:
    """Transcript-parity mode at full width: G1ExpAir(128) under
    StarkConfig.parity_config() (Poseidon leaves, element-wise transcript,
    plonky2's proof of work), the parity grind's launches in the first
    prove, three rejections, and a two-statement parity batch."""
    import torch

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import (BatchStarkProof, StarkConfig, proof_from_bytes,
                                              proof_to_bytes, prove, prove_batch_fri, verify,
                                              verify_batch_fri)
    from starky_bn254_tpu_torch.utils.timing import TimingTree

    cfg = StarkConfig.parity_config()
    air = G1ExpAir(G1_NUM_IO)
    trace, pi, _ = exp_statement("parity", air, g1_inputs(0, G1_NUM_IO, bn254), G1_SHAPES, dev,
                                 "parity_config()", warm=False)
    with launch_regions() as reg:
        r = drive("parity", air, trace, pi, cfg, PARITY_WARM_PROVES)
    k3 = "poseidon_sponge_and_grind"
    first = reg.log["grind_parity"][0]
    if reg.log["grind"] or first[k3] <= 0:
        raise AssertionError(f"parity: the first prove's grind launched {first} through the parity "
                             f"entry, and the default grind ran {len(reg.log['grind'])} times")
    print(f"parity: the first prove's parity grind: {json.dumps(first)}; nonce "
          f"{r['first_proof'].fri.pow_nonce}")
    r["grind_parity_launches"] = first

    proof = r["proof"]
    bad = proof_from_bytes(proof_to_bytes(proof))
    bad.fri.pow_nonce += 1
    expect_rejected("parity", "a tampered pow_nonce", lambda: verify(air, bad, cfg))
    pcfg = StarkConfig.standard_fast_config("poseidon")
    expect_rejected("parity", "the parity proof under standard_fast_config('poseidon')",
                    lambda: verify(air, proof, pcfg))
    # the same statement under the default transcript with Poseidon leaves:
    # the g1-poseidon cell, and the proof the parity config must refuse
    tt = TimingTree("prove", dev)
    t0 = time.perf_counter()
    default = prove(air, trace, pi, pcfg, timing=tt)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if verify(air, default, pcfg) is not True:
        raise AssertionError("g1-poseidon: verify did not accept the poseidon-config proof")
    verify_s = time.perf_counter() - t0
    ph = _phase_ms(tt)
    print(f"g1-poseidon: standard_fast_config('poseidon'): prove {prove_s:.3f} s, trace commit "
          f"{ph['trace commit']:.1f} ms, aux commit/commit {ph['aux (Z/logup) commit/commit']:.1f} ms, "
          f"verify_s {verify_s:.3f}, accepted")
    expect_rejected("parity", "a standard_fast_config('poseidon') proof under parity_config()",
                    lambda: verify(air, default, cfg))
    r["g1_poseidon_bytes"] = proof_to_bytes(default)  # the sharded phase's Poseidon reference
    del default

    fq = FqExpAir(G1_NUM_IO)
    fq_trace, fq_pi = fq.generate_trace_and_pi(fq_exp_inputs(13, G1_NUM_IO, bn254))
    items = [(air, trace, pi), (fq, xnp.to_torch(fq_trace, dev), fq_pi)]
    reset_launches()
    with launch_regions() as breg:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = prove_batch_fri(items, cfg)  # the card
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    batch_launches = launch_counts()
    (bgrind,) = breg.log["grind_parity"]
    if breg.log["grind"] or bgrind[k3] <= 0 or any(batch_launches[k] <= 0 for k in path_kernels(cfg)):
        raise AssertionError(f"parity: batch launches {batch_launches}, grind {bgrind}")
    t0 = time.perf_counter()
    if verify_batch_fri([air, fq], batch, cfg) is not True:
        raise AssertionError("parity: verify_batch_fri did not accept the parity batch")
    bverify_s = time.perf_counter() - t0
    bad = [proof_from_bytes(proof_to_bytes(st)) for st in batch.statements]
    bad[0].fri.pow_nonce += 1
    expect_rejected("parity", "the batch with a tampered pow_nonce",
                    lambda: verify_batch_fri([air, fq], BatchStarkProof(bad), cfg))
    print(f"parity: prove_batch_fri of G1ExpAir(128) and FqExpAir(128) under parity_config(): "
          f"{batch_s:.3f} s (the first), verify_batch_fri {bverify_s:.3f} s, "
          f"{sum(len(proof_to_bytes(st)) for st in batch.statements)} bytes; launches "
          f"{json.dumps(batch_launches)} (parity grind {json.dumps(bgrind)})")
    r["batch_launches"], r["batch_s"] = batch_launches, batch_s
    return r


def phase_u16(dev) -> dict:
    """The u16 range check at full width: G1ExpAir(128, "u16") (65536 x
    1165, 762 permutation pairs) under standard_fast_config("keccak"), the
    steps of drive(), and a cell >= 2^16 refused at tracegen."""
    import numpy as np

    from starky_bn254_tpu_torch import bn254, xnp
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig

    cfg = StarkConfig.standard_fast_config("keccak")
    air = G1ExpAir(G1_NUM_IO, range_check="u16")
    trace, pi, aux_w = exp_statement("u16", air, g1_inputs(0, G1_NUM_IO, bn254), U16_SHAPES, dev,
                                     f"{len(air.permutation_pairs())} permutation pairs", warm=False)
    r = drive("u16", air, trace, pi, cfg, U16_WARM_PROVES)
    base = xnp.to_numpy(trace[:, : air.start_lookups])
    col = air.rc_spec.targets[len(air.rc_spec.targets) // 2]
    base[12345, col] = np.uint64(1 << 16)
    try:
        air.rc_spec.generate(base)
    except AssertionError as e:
        print(f"u16: a cell of 2^16 in checked column {col} refused at tracegen ({e})")
    else:
        raise AssertionError("u16: tracegen took a cell of 2^16")
    r["aux_columns"] = aux_w
    return r


def _flat_phases(d: dict, prefix: str = "") -> dict[str, float]:
    """A TimingTree's as_dict() as {"a/b": ms}."""
    out = {}
    for c in d.get("children", []):
        out[prefix + c["name"]] = c["ms"]
        out.update(_flat_phases(c, prefix + c["name"] + "/"))
    return out


def phase_northstar(dev, log_rows: int) -> dict:
    """The north-star entry point (starky_bn254_tpu_torch/scripts/
    northstar_g1.py) at 2^log_rows rows under standard_fast_config("keccak"):
    inputs, tracegen, one prove on the card and verify, through `run`, with
    the launch counts reset just before and read just after; composition's
    row blocks and the caching allocator's retries over the run."""
    import torch

    from starky_bn254_tpu_torch.scripts import northstar_g1
    from starky_bn254_tpu_torch.stark import StarkConfig, composition

    label = f"northstar-{log_rows}"
    cfg = StarkConfig.standard_fast_config("keccak")
    torch.cuda.empty_cache()
    # composition's row blocks, and the caching allocator's retries (each
    # frees the cache and calls cudaMalloc again) and device allocations
    blocks, plain_pick = [], composition.pick_block_rows

    def pick(n_lde, width, device):
        rows = plain_pick(n_lde, width, device)
        free, _ = torch.cuda.mem_get_info(device)
        cache = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        blocks.append(f"{n_lde // rows} x {rows} rows of {width} columns (free {free / 2**30:.1f}, "
                      f"cache {cache / 2**30:.1f} GiB)")
        return rows

    stats0 = torch.cuda.memory_stats(dev)
    composition.pick_block_rows = pick
    try:
        reset_launches()
        rec = northstar_g1.run(log_rows, cfg)  # no device named: the card
        launches = launch_counts()
    finally:
        composition.pick_block_rows = plain_pick
    stats = torch.cuda.memory_stats(dev)
    alloc = {k: stats.get(k, 0) - stats0.get(k, 0)
             for k in ("num_alloc_retries", "num_device_alloc", "num_device_free")}
    print(f"{label}: composition {'; '.join(blocks)}; allocator over the run {json.dumps(alloc)}")
    missing = [k for k in path_kernels(cfg) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    d = rec["detail"]
    phases = _flat_phases(d["phases"])
    print(f"{label}: G1ExpAir({d['num_io']}) {d['rows']} x {d['columns']}: inputs {d['inputs_s']} s, "
          f"tracegen {d['trace_gen_s']} s, prove_first_s {d['prove_first_s']:.3f}, verify_s "
          f"{d['verify_s']:.3f} (verified {d['verified']}), peak_device_GiB {d['peak_device_gib']}, "
          f"host RSS GB {json.dumps(d['host_rss_gb'])}; retained LDE "
          f"{d['retained_lde_bytes'] / 2**30:.2f} GiB, offloaded {d['lde_offloaded']} "
          f"(STARKY_LDE_DEVICE_BYTES {os.environ.get('STARKY_LDE_DEVICE_BYTES', 'default')})")
    print(f"{label}: prove phases (ms)")
    for key, ms in phases.items():
        print(f"{label}:   {ms:9.1f}  {key}")
    print(f"{label}: launches {json.dumps(launches)}")
    return dict(launches=launches, record=rec, phases=phases, blocks=blocks, alloc=alloc)


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
    if sys.argv[1:] == ["--lde-budget"]:
        phase_lde_budget(dev)
        done("lde-budget")
        print(smi)
        return 0
    kernel_stats = phase_kernels(dev, bounds)
    done("kernels")
    kernel_stats["field"] = field_stats = phase_field(dev, bounds)
    done("field")
    phase_fidelity(dev)
    done("fidelity")
    parity = phase_parity(dev)
    torch.cuda.empty_cache()
    done("parity")
    u16 = phase_u16(dev)
    torch.cuda.empty_cache()
    done("u16")
    slice_launches = phase_slice(dev)
    torch.cuda.empty_cache()
    done("slice")
    g1 = phase_g1(dev, native_build_s)
    check_field_launches("g1", g1["launches"], field_stats["blocks"][0])
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
    sharded_run = phase_sharded(dev, g1, parity, pipelined)
    torch.cuda.empty_cache()
    done("sharded")
    fq12 = phase_fq12("fq12", False, dev)
    check_field_launches("fq12", fq12["launches"], field_stats["blocks"][1])
    torch.cuda.empty_cache()
    done("fq12")
    fq12_u64 = phase_fq12("fq12-u64", True, dev)
    torch.cuda.empty_cache()
    done("fq12-u64")
    msm_run = phase_msm(dev)
    torch.cuda.empty_cache()
    done("msm")
    batch = phase_batch(dev)
    torch.cuda.empty_cache()
    done("batch")
    offload = phase_batch_offload(dev, batch)
    torch.cuda.empty_cache()
    done("batch-offload")
    phase_verify_batch(g1, fq, g2)
    done("verify-batch")
    northstar = phase_northstar(dev, NORTHSTAR_LOG_ROWS)
    done(f"northstar-{NORTHSTAR_LOG_ROWS}")
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
                   launches_g2_msm=msm_run["g2_launches"][name],
                   launches_fq_multiexp=msm_run["fq_launches"][name],
                   launches_hash_to_g2=msm_run["h2g2_launches"][name],
                   launches_batch=batch["launches"][name],
                   launches_batch_offload=offload["launches"][name],
                   launches_parity=parity["launches"][name],
                   launches_parity_batch=parity["batch_launches"][name],
                   launches_u16=u16["launches"][name],
                   launches_northstar=northstar["launches"][name],
                   launches_sharded=sharded_run["sharded"]["launches"][name],
                   launches_sharded_poseidon=sharded_run["sharded-poseidon"]["launches"][name],
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
