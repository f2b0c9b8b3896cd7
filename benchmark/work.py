"""The yardstick of the kernel rooflines: each hand kernel's least time on
one NVIDIA H100 SXM, from the work a prove gives it.

A kernel's bound is the larger of its compulsory bytes (each input word
read once, each output word written once) over the card's memory rate and
the integer instructions of its work over the card's int32 rate. The work
is counted in field operations, each as many SASS instructions as its probe
counted on the card when the benchmark was written (the port's
csrc/sass_probes.cu read by cuobjdump); the counts are frozen here, so a
change to the kernels or their compiler flags never moves the ruler.

What one prove launches is counted from the statement's shape alone: its
rows, its trace and aux widths, its public inputs and the STARK config
(`ntt_calls`, `poseidon_calls`). The proof of work is counted by the grind
batches the inputs needed, which the caller reads from the device trace.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SMS = 132  # H100 SXM
INT32_LANES_PER_SM = 64
SM_CLOCK_MHZ = 1980.0  # the H100 SXM's maximum SM clock
INT_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_MHZ * 1e6

# SASS instructions per field operation on canonical Goldilocks words
OP_MUL = 32
OP_ADD = 10
OP_SUB = 8
OP_POSEIDON_MDS = 941  # one MDS layer of the width-12 permutation
OP_KECCAK_ROUND = 194

# Poseidon over Goldilocks, width 12, rate 8: 30 rounds of 12 round-constant
# adds and one MDS layer; an S-box (x^7: 4 multiplies) on 12 lanes in the 8
# full rounds, on 1 lane in the 22 partial ones
POSEIDON_WIDTH, POSEIDON_RATE = 12, 8
POSEIDON_PERM_OPS = 30 * (12 * OP_ADD + OP_POSEIDON_MDS) + (8 * 12 + 22) * 4 * OP_MUL

# K1's launches: one a pass, each pass at most (13 - log2 of its column
# tile) stages, as the port planned its passes when the benchmark was
# written (ntt._pass_plan, TILE_WORDS 2^13, tiles up to 16 columns)
NTT_TILE_LOG_WORDS = 13
NTT_MAX_LOG_W = 4

VECTOR_OBSERVE_MIN = 128  # a transcript observes a vector this long through a digest tree
VECTOR_LEAF_WIDTH = 128
FRI_ARITY = 4
QUOTIENT_CHUNKS = 2


def bound(nbytes: float, ops: float) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, int_ops=ops)


def ntt_bound(n: int, c: int, inverse: bool) -> dict:
    """An NTT of c columns of n rows: n/2 * log2(n) butterflies a column,
    each an add and a subtract, and a multiply unless its twiddle is 1 (the
    j = 0 butterfly of each block of each stage, n - 1 of them). The
    inverse's 1/n is a multiply a word. Bytes: the columns in and out once,
    and an n-word twiddle table."""
    log_n = n.bit_length() - 1
    butterflies = n // 2 * log_n
    ops = c * (butterflies * (OP_ADD + OP_SUB) + (butterflies - (n - 1)) * OP_MUL)
    if inverse:
        ops += n * c * OP_MUL
    return bound(16 * n * c + 8 * n, ops)


def poseidon_bound(rows: int, perms_per_row: int, words_in: int, words_out: int) -> dict:
    return bound(8 * rows * (words_in + words_out), rows * perms_per_row * POSEIDON_PERM_OPS)


def keccak_bound(rows: int, width: int) -> dict:
    perms = width // 17 + 1  # full chunks and the padded block
    return bound(8 * rows * (width + 4), rows * perms * 24 * OP_KECCAK_ROUND)


@dataclass(frozen=True)
class ProveShape:
    """What fixes one prove's kernel work: 2^degree_bits rows, the trace
    and aux widths, the public inputs and the config's FRI parameters."""

    rows: int
    trace_cols: int
    aux_cols: int
    public_inputs: int
    num_challenges: int
    rate_bits: int
    cap_height: int
    final_poly_bits: int
    pow_bits: int

    @property
    def lde_rows(self) -> int:
        return self.rows << self.rate_bits

    def fri_layer_sizes(self) -> list[int]:
        sizes, m = [], self.lde_rows
        while m > (1 << self.final_poly_bits) << self.rate_bits:
            sizes.append(m)
            m //= FRI_ARITY
        return sizes

    def final_domain(self) -> int:
        sizes = self.fri_layer_sizes()
        return sizes[-1] // FRI_ARITY if sizes else self.lde_rows

    def quotient_cols(self) -> int:
        return self.num_challenges * QUOTIENT_CHUNKS

    def opening_elements(self) -> int:
        """[trace | aux] at zeta and g*zeta, the quotient chunks at zeta,
        each an extension pair."""
        return 2 * (2 * self.trace_cols + 2 * self.aux_cols + self.quotient_cols())


def ntt_calls(s: ProveShape) -> list[tuple[int, int, bool]]:
    """(rows, columns, inverse) of each NTT of one prove: the trace and aux
    commits' interpolation and coset LDE, the quotient's interpolation from
    the LDE coset and its chunks' LDE, the FRI final polynomial."""
    calls = []
    for c in (s.trace_cols, s.aux_cols):
        if c:
            calls += [(s.rows, c, True), (s.lde_rows, c, False)]
    calls += [(s.lde_rows, s.num_challenges, True), (s.lde_rows, s.quotient_cols(), False)]
    calls.append((s.final_domain(), 2, True))
    return calls


def ntt_launches(s: ProveShape) -> int:
    """K1 launches of one prove: each call of `ntt_calls` in as many passes
    as the port's plan took when the benchmark was written. A trace that
    holds another count means the calls or the plan have changed, and the
    bound no longer describes the launches timed."""
    total = 0
    for n, c, _ in ntt_calls(s):
        if c:
            t_max = NTT_TILE_LOG_WORDS - min(max(c - 1, 0).bit_length(), NTT_MAX_LOG_W)
            total += max(1, -(-(n.bit_length() - 1) // t_max))
    return total


def _tree_levels(leaf_rows: int, cap_height: int) -> list[int]:
    """Rows of each compress launch from the leaf digests up to the cap."""
    cap = min(cap_height, leaf_rows.bit_length() - 1)
    out, r = [], leaf_rows
    while r > 1 << cap:
        r //= 2
        out.append(r)
    return out


def _merkle(rows: int, width: int, cap_height: int) -> list[tuple[int, int, int, int]]:
    """A Merkle tree over [rows, width]: the leaf sponge (none for leaves
    of 4 words or fewer, which are padded) and the compress levels."""
    calls = []
    if width > 4:
        calls.append((rows, -(-width // POSEIDON_RATE), width, 4))
    calls += [(r, 1, 8, 4) for r in _tree_levels(rows, cap_height)]
    return calls


def _vector_digest(n: int) -> list[tuple[int, int, int, int]]:
    """A transcript's digest of an n-element vector: 128-element leaf
    sponges, then a compress tree (an odd level gets a zero digest)."""
    if n < VECTOR_OBSERVE_MIN:
        return []
    m = -(-n // VECTOR_LEAF_WIDTH)
    calls = [(m, VECTOR_LEAF_WIDTH // POSEIDON_RATE, VECTOR_LEAF_WIDTH, 4)]
    while m > 1:
        m = -(-m // 2)
        calls.append((m, 1, 8, 4))
    return calls


def grind_batch(pow_bits: int) -> int:
    """Permutations in one batch of the proof-of-work search."""
    return 1 << max(pow_bits + 2, 10)


def poseidon_calls(s: ProveShape, grind_batches: int) -> list[tuple[int, int, int, int]]:
    """(rows, permutations a row, words in a row, words out a row) of each
    K3 launch of one prove under Poseidon leaves, in the prover's order."""
    calls = _vector_digest(s.public_inputs)
    calls += _merkle(s.lde_rows, s.trace_cols, s.cap_height)
    if s.aux_cols:
        calls += _merkle(s.lde_rows, s.aux_cols, s.cap_height)
    calls += _merkle(s.lde_rows, s.quotient_cols(), s.cap_height)
    calls += _vector_digest(s.opening_elements())
    for m in s.fri_layer_sizes():
        calls += _merkle(m // FRI_ARITY, 2 * FRI_ARITY, s.cap_height)
    calls += _vector_digest(2 * (s.final_domain() >> s.rate_bits))
    calls += [(grind_batch(s.pow_bits), 1, 0, 0)] * grind_batches
    return calls


def ntt_bound_ms(s: ProveShape) -> float:
    return sum(ntt_bound(n, c, inv)["bound_ms"] for n, c, inv in ntt_calls(s))


def poseidon_bound_ms(s: ProveShape, grind_batches: int) -> float:
    return sum(poseidon_bound(*c)["bound_ms"] for c in poseidon_calls(s, grind_batches))


def grind_bound_ms(s: ProveShape, batches: int) -> float:
    return batches * poseidon_bound(grind_batch(s.pow_bits), 1, 0, 0)["bound_ms"]
