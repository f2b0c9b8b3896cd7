"""Shared-FRI batch proving: one artifact attesting N statements.

The port of the JAX package's stark/batch_prove.py. Each statement commits
its own trace, aux and quotient and opens at its own zeta inside ONE
Fiat-Shamir transcript (per statement: PI, trace cap, gammas, aux cap,
alphas, quotient cap, zeta, openings; then beta, then mu); then one random
linear combination

    F(x) = sum_j mu^j * F_j(x)

of the per-statement batched-opening polynomials runs ONE FRI: one fold
ladder, one proof-of-work grind, one set of query rounds that opens every
statement's oracles at shared indices. Against N separate proofs this
shares the layer commitments and paths, the final polynomial and the proof
of work, and the verifier replays one fold ladder instead of N. The
statements may be of different families (G1, G2, Fq, Fq12 statements of
one protocol).

Heights: a statement's height must be the largest divided by a power of
ARITY = 4. A statement at N_max / 4^k commits its LDEs on the coset
g^(4^k), the fold ladder's domain after k arity-4 folds, so its opening
polynomial is added (mu-weighted) into the running fold values when the
ladder reaches its size (fri_prove's `inject`); the layer commitment binds
it, the queries open its oracles at idx mod N_j, and the verifier injects
the same recomputed values into its fold replay.

The statements' LDEs all stay alive until the shared queries: when their
summed size passes the device budget (prover.offload_ldes) every commit of
the batch keeps its LDE in pinned host memory, as a prove does.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from .. import goldilocks as gl
from .. import xnp
from ..challenger import Challenger
from ..utils import timing as tm
from .air import Air
from .config import StarkConfig
from .fri import ARITY, fri_prove, fri_verify_query_layers
from .proof import FriProof, StarkProof
from .prover import _prove_device, _prove_statement, _trace_on, offload_ldes, retained_lde_bytes
from .verifier import (
    _check_composition,
    _check_initial_merkle,
    _check_shapes,
    _ext_int,
    _layer_openings,
    _recompute_f,
    _replay_fri,
    _replay_statement,
    _require,
)


@dataclass
class BatchStarkProof:
    """N statements, one shared FRI: statements[j] is a StarkProof whose
    `fri` is empty but in statements[0], which carries the shared FriProof
    (layer caps, final polynomial, nonce, and query rounds over ALL
    statements' oracles, statement-major)."""

    statements: list[StarkProof]

    @property
    def shared_fri(self) -> FriProof:
        return self.statements[0].fri


def ladder_shift(n_max: int, n: int) -> int | None:
    """The LDE coset shift of a statement of n rows in a batch whose
    largest has n_max: g^(4^k) for n = n_max / 4^k, else None."""
    if n <= 0 or n_max % n:
        return None
    ratio, k = n_max // n, 0
    while ratio > 1:
        if ratio % ARITY:
            return None
        ratio //= ARITY
        k += 1
    return pow(gl.GENERATOR, ARITY**k, gl.P)


def prove_batch_fri(items: list, cfg: StarkConfig, timing=None, device=None) -> BatchStarkProof:
    """items: [(air, trace [n_j, C_j], public_inputs)], each trace a numpy
    uint64 array or an int64 tensor; heights n_max / 4^k. device: where the
    prover runs; None is the current CUDA card, and raises when there is
    none (as `prove`). timing: a utils.timing recorder (None:
    timing.current(), inside a span "prove_batch")."""
    dev = _prove_device(device)
    n = max(trace.shape[0] for _, trace, _ in items)
    shifts = []
    for _, trace, _ in items:
        shift = ladder_shift(n, trace.shape[0])
        if shift is None:
            raise ValueError(f"statement height {trace.shape[0]} is not {n} over a power of "
                             f"{ARITY}: pad it to one")
        if trace.shape[0] << cfg.fri.rate_bits <= (1 << cfg.fri.final_poly_bits) * cfg.fri.blowup:
            raise ValueError(f"statement height {trace.shape[0]}: the fold ladder ends above it")
        shifts.append(shift)
    offload = offload_ldes(sum(retained_lde_bytes(air, trace.shape[0], cfg)
                               for air, trace, _ in items))

    with np.errstate(over="ignore"), tm.entry(timing, "prove_batch") as tt:
        challenger = Challenger(parity=cfg.fri.parity, device=dev)
        stmts = []
        for j, ((air, trace, pi), shift) in enumerate(zip(items, shifts)):
            holder = [_trace_on(trace, dev)]
            stmts.append(_prove_statement(air, holder, pi, cfg, challenger, tt, dev, shift,
                                          offload, prefix=f"s{j} "))
        beta = challenger.get_ext_challenge()
        mu = np.array(challenger.get_ext_challenge(), dtype=np.uint64)

        with tt.scope("batch opening combine"):
            f_total, inject = None, {}
            mu_pow = np.array([1, 0], dtype=np.uint64)
            for st in stmts:
                f_j = st.opening_poly(beta, dev)
                term = gl.ext_mul(f_j, xnp.as_tensor_like(mu_pow, f_j)[None, :])
                if st.n == n:
                    f_total = term if f_total is None else gl.ext_add(f_total, term)
                else:
                    m = st.n << cfg.fri.rate_bits
                    inject[m] = term if m not in inject else gl.ext_add(inject[m], term)
                mu_pow = gl.ext_mul(mu_pow, mu)
        oracles = [o for st in stmts for o in st.oracles()]
        with tt.scope("shared fri"):
            fri_proof = fri_prove(f_total, gl.GENERATOR, oracles, challenger, cfg.fri, timing=tt,
                                  inject=inject)
        if timing is not None:
            timing.finish()
        empty = FriProof(layer_caps=[], final_coeffs=np.zeros((0, 2), dtype=np.uint64),
                         pow_nonce=0, query_rounds=[])
        return BatchStarkProof([st.proof(fri_proof if j == 0 else empty)
                                for j, st in enumerate(stmts)])


def verify_batch_fri(airs: list[Air], batch: BatchStarkProof, cfg: StarkConfig) -> bool:
    """Replay the shared transcript, check every statement's constraints at
    its zeta, then the shared FRI's queries against the combined
    polynomial, on the host. Raises VerificationError on any failed check."""
    with np.errstate(over="ignore"):
        return _verify_batch_impl(airs, batch, cfg)


def _verify_batch_impl(airs: list[Air], batch: BatchStarkProof, cfg: StarkConfig) -> bool:
    stmts = batch.statements
    _require(len(stmts) > 0 and len(airs) == len(stmts), "airs/statements length")
    n = max(1 << s.degree_bits for s in stmts)
    n_lde = n << cfg.fri.rate_bits
    shifts = [ladder_shift(n, 1 << s.degree_bits) for s in stmts]
    _require(all(sh is not None for sh in shifts), "statement height must be max/ARITY^k")
    # as the prover refuses them: a statement whose LDE is no larger than
    # the final domain has no layer of the ladder to enter, and its F_j
    # would be bound to no commitment
    final = (1 << cfg.fri.final_poly_bits) * cfg.fri.blowup
    _require(all((1 << s.degree_bits) << cfg.fri.rate_bits > final for s in stmts),
             "statement height: the fold ladder ends above it")

    challenger = Challenger(parity=cfg.fri.parity)
    per = []
    for air, s in zip(airs, stmts):
        has_aux = _check_shapes(air, s, cfg)
        per.append((has_aux,) + _replay_statement(challenger, s, has_aux, cfg.num_challenges))
    beta = challenger.get_ext_challenge()
    mu = np.array(challenger.get_ext_challenge(), dtype=np.uint64)

    # each statement's constraints at its zeta, over its own subgroup
    for j, (air, s, (has_aux, gammas, alphas, zeta)) in enumerate(zip(airs, stmts, per)):
        _check_composition(air, s, has_aux, gammas, alphas, zeta, cfg, what=f"statement {j}, ")

    fri = batch.shared_fri
    fri_betas, indices = _replay_fri(challenger, fri, n_lde, cfg)
    idx_np = np.array(indices, dtype=np.int64)

    # the oracles, statement-major, each opened at idx mod its LDE rows
    caps = []
    for s, (has_aux, *_) in zip(stmts, per):
        n_lde_j = (1 << s.degree_bits) << cfg.fri.rate_bits
        caps += [(c, n_lde_j) for c in [s.trace_cap] + ([s.z_cap] if has_aux else [])
                 + [s.quotient_cap]]
    _require(len(fri.query_rounds[0].initial_leaves) == len(caps), "oracle count")
    _check_initial_merkle(fri, caps, idx_np, cfg)

    # the combined F at the query points: sum_j mu^j F_j, a smaller
    # statement's share injected at its layer of the ladder
    f_total, inject = None, {}
    mu_pow = np.array([1, 0], dtype=np.uint64)
    off = 0
    for s, (has_aux, _, _, zeta), shift in zip(stmts, per, shifts):
        k = 3 if has_aux else 2
        n_lde_j = (1 << s.degree_bits) << cfg.fri.rate_bits
        view = SimpleNamespace(openings=s.openings, degree_bits=s.degree_bits)
        f_j = _recompute_f(view, has_aux, idx_np % n_lde_j, _ext_int(zeta), beta, n_lde_j, shift,
                           initial_leaves=[qr.initial_leaves[off : off + k] for qr in fri.query_rounds])
        term = gl.ext_mul(f_j, np.broadcast_to(mu_pow, f_j.shape))
        if n_lde_j == n_lde:
            f_total = term if f_total is None else gl.ext_add(f_total, term)
        else:
            inject[n_lde_j] = term if n_lde_j not in inject else gl.ext_add(inject[n_lde_j], term)
        mu_pow = gl.ext_mul(mu_pow, mu)
        off += k

    layer_leaves, layer_paths = _layer_openings(fri, len(fri_betas))
    _require(
        fri_verify_query_layers(
            f_total, idx_np, layer_leaves, layer_paths, fri.layer_caps, fri_betas,
            fri.final_coeffs, n_lde, gl.GENERATOR, cfg.fri, inject=inject,
        ),
        "shared fri fold/final-poly check failed",
    )
    return True
