"""STARK prover: trace commit -> aux columns -> quotient -> FRI.

  trace [n, C] --INTT--> coeffs --coset NTT--> LDE [N, C] --Merkle--> cap
      |                                            |
      +-- aux block [permutation Z (prefix products) | logUp running sums
      |   | AIR-defined columns (RLC IO binding)] --> aux cap
      +-- composition: AIR.eval over LDE row blocks
      +-- quotient chunks --> cap --> openings at zeta, g*zeta --> FRI

`prove` runs on the CUDA card unless the caller names another device
(`device="cpu"`): every intermediate tensor stays there (the NTTs, Merkle
hashing and grind through the CUDA kernels on a card). The host runs the
Fiat-Shamir transcript and the AIR-defined aux columns (`generate_aux`,
from one copy of the trace per prove).

Retained state: a prove keeps its trace, aux and quotient LDEs alive until
the FRI queries open them (a shared-FRI batch keeps every statement's,
stark/batch_prove.py). When their summed size passes the device budget
(STARKY_LDE_DEVICE_BYTES), each commit streams its LDE into pinned host
memory (`_commit_streaming`) and the aux columns are built off the card;
every consumer (composition, openings, the opening combine, the query
gathers) reads such an LDE back onto the prove's device block by block and
computes there. The proof is the same, byte for byte.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import goldilocks as gl
from .. import merkle, ntt, xnp
from ..challenger import Challenger
from ..hashing import get_hasher
from ..utils import timing as tm
from .air import Air
from .composition import evaluate_composition, evaluate_composition_sharded
from .config import StarkConfig
from .consumer import ConstraintConsumer
from .field_expr import RowView
from .fri import fri_prove
from .logup import compute_logup_columns, compute_logup_columns_streamed, table_aux_width
from .proof import FriProof, StarkOpenings, StarkProof

QUOTIENT_CHUNKS = 2  # constraint degree 3 => quotient degree < 2n

# Device budget (STARKY_LDE_DEVICE_BYTES), bytes, for the LDEs a prove keeps
# alive until its FRI queries, summed over the statements of a batch; past
# it every commit of the prove keeps its LDE in pinned host memory. Set
# from `chip_smoke.py --lde-budget` on an NVIDIA H100 80GB HBM3 (700.00 W),
# the same batch proved on the card and offloaded, two runs: 1 x
# Fq12ExpAir(128) (6.92 GiB) 20.3 / 17.2 s against 24.9 / 23.0 s, 3 x
# (20.77 GiB) 77.2 / 70.3 s against 84.6 / 70.2 s, but 5 x Fq12ExpAir(128)
# + 3 x G2ExpAir(128) (39.19 GiB, peak 65.05 GiB allocated, 74.67
# reserved) 181-363 s against 154 s: with that much retained,
# composition's row blocks (half the free memory) shrink to 2048 rows and
# its launches multiply. So the budget sits at the crossover, just above
# 3 x Fq12ExpAir(128). (The JAX package's 6 GiB was sized for a 16 GB chip
# and would send every Fq12 commit to the host.)
LDE_DEVICE_BYTES = 21 << 30
# Streaming commit (STARKY_COMMIT_BLOCK_CELLS): column blocks of whole hash
# chunks of at most this many LDE cells (512 MiB of LDE at 2^26)
COMMIT_BLOCK_CELLS = 1 << 26


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def retained_lde_bytes(air: Air, n: int, cfg: StarkConfig) -> int:
    """Bytes of the trace, aux and quotient LDEs a prove of `air` at n rows
    keeps alive until its FRI queries."""
    nc = cfg.num_challenges
    aux_w = nc * (len(air.permutation_pairs()) + table_aux_width(air.lookup_tables())
                  + air.aux_extra_width())
    return (n << cfg.fri.rate_bits) * (air.num_columns + aux_w + nc * QUOTIENT_CHUNKS) * 8


def offload_ldes(total_bytes: int) -> bool:
    """Whether a prove that keeps `total_bytes` of LDE alive keeps them in
    host memory: past the device budget, STARKY_LDE_DEVICE_BYTES, or past
    STARKY_LDE_HOST_BYTES when that is set (the JAX package's per-matrix
    bound, here a bound on the same sum, so that any matrix past it is
    offloaded too)."""
    budget = _env_int("STARKY_LDE_DEVICE_BYTES", LDE_DEVICE_BYTES)
    return total_bytes > min(budget, _env_int("STARKY_LDE_HOST_BYTES", budget))


@dataclass
class Commitment:
    lde: torch.Tensor  # [N, C]: on the prove's device, or offloaded to the host
    tree: merkle.MerkleTree


def commit(values, cfg: StarkConfig, offload: bool = False, shift: int = gl.GENERATOR,
           device=None) -> Commitment:
    """INTT, LDE on the coset shift * H_N, Merkle tree over the LDE rows.
    Neither the subgroup values nor the coefficients are kept: openings are
    evaluated barycentrically from the LDE (ntt.eval_from_lde).

    values: [n, C] int64 tensor, or a 1-element list holding it, which
    commit empties (no reference of the caller's then keeps the source
    alive once the transform is done with it). offload: keep the LDE in
    host memory (through `_commit_streaming`). device: where the transforms
    and the hashing run (default: values' device; values on the host are
    copied there)."""
    if isinstance(values, list):
        if len(values) != 1:
            raise ValueError("commit: the ownership form is a list of one matrix")
        values = values.pop()
    if offload:
        return _commit_streaming(values, cfg, shift, device)
    coeffs = ntt.interpolate_coeffs(xnp.on_device(values, values.device if device is None else device))
    del values
    lde = ntt.lde_from_coeffs(coeffs, cfg.fri.rate_bits, shift)
    del coeffs
    cap_h = min(cfg.fri.cap_height, lde.shape[0].bit_length() - 1)
    tree = merkle.build_merkle_tree(lde, cap_h, cfg.fri.merkle_hash)
    return Commitment(lde, tree)


def _commit_streaming(values: torch.Tensor, cfg: StarkConfig, shift: int = gl.GENERATOR,
                      device=None) -> Commitment:
    """`commit` column block by column block, for an LDE kept off the card:
    each block of whole hash-rate chunks (STARKY_COMMIT_BLOCK_CELLS LDE
    cells at most) is copied to `device` (default: values'), goes through
    the INTT and the coset LDE there, is written into the LDE buffer
    (preallocated once in pinned host memory) and is absorbed into the
    leaves' running sponge states. Every block but the last goes through
    the hasher's sponge_absorb with the states carried from the one before;
    the last, its sub-rate tail included, through the hasher's finalize,
    which pads the tail in the same launch: a matrix of one block is hashed
    in one launch, as the whole-matrix commit hashes it. The digests, the
    tree and the LDE equal `commit`'s."""
    h = get_hasher(cfg.fri.merkle_hash)
    n, num_cols = values.shape
    if num_cols <= 4:  # hash_or_noop: leaves this narrow are not hashed
        raise ValueError(f"streaming commit: {num_cols} columns; leaves need more than 4")
    dev = values.device if device is None else torch.device(device)
    n_lde = n << cfg.fri.rate_bits
    cells = _env_int("STARKY_COMMIT_BLOCK_CELLS", COMMIT_BLOCK_CELLS)
    block_cols = max((cells // n_lde) // h.RATE * h.RATE, h.RATE)
    lde = xnp.host_buffer((n_lde, num_cols), dev)
    state = torch.zeros((n_lde, h.WIDTH), dtype=torch.int64, device=dev)
    for off in range(0, num_cols, block_cols):
        blk = ntt.interpolate_coeffs(xnp.on_device(values[:, off : off + block_cols], dev))
        lde_b = ntt.lde_from_coeffs(blk, cfg.fri.rate_bits, shift)
        del blk
        lde[:, off : off + lde_b.shape[1]].copy_(lde_b)
        if off + block_cols < num_cols:
            state = h.sponge_absorb(state, lde_b)
        else:
            digests = h.finalize(state, lde_b)
        del lde_b
    del state
    cap_h = min(cfg.fri.cap_height, n_lde.bit_length() - 1)
    levels = [digests] + merkle._upper_levels(digests, cap_h, cfg.fri.merkle_hash)
    return Commitment(lde, merkle.MerkleTree(levels=levels, cap_height=cap_h))


def compute_z_columns(trace: torch.Tensor, pairs: list[tuple[int, int]], gammas: list[int]) -> torch.Tensor:
    """Grand-product Z columns, challenge-major: [n, len(gammas)*len(pairs)].

    Z[0] = 1, Z[i+1] = Z[i] * (a_i + gamma) / (b_i + gamma); multiset
    equality of columns a and b iff the product wraps to 1, enforced by the
    cyclic transition constraint in `permutation_constraints`."""
    dev = trace.device
    a_vals = trace[:, torch.tensor([p[0] for p in pairs], device=dev)]
    b_vals = trace[:, torch.tensor([p[1] for p in pairs], device=dev)]
    cols = []
    for g in gammas:
        gamma = xnp.as_tensor_like(g % gl.P, trace)
        ratio = gl.mul(gl.add(a_vals, gamma), gl.batch_inv(gl.add(b_vals, gamma)))
        prods = gl.cumprod(ratio)  # inclusive, along rows
        ones = torch.ones((1, ratio.shape[1]), dtype=torch.int64, device=dev)
        cols.append(torch.cat([ones, prods[:-1]], dim=0))
    return torch.cat(cols, dim=1)


def permutation_constraints(
    pairs: list[tuple[int, int]],
    gammas: list,
    lv: RowView,
    nv: RowView,
    z_lv: RowView,
    z_nv: RowView,
    cc: ConstraintConsumer,
    ext: bool,
):
    """Framework-added constraints for the permutation argument, in a fixed
    order: challenge-major, then pair index; first-row constraints then the
    cyclic transition constraints (lane-stacked per challenge)."""
    n_pairs = len(pairs)
    a_idx = [p[0] for p in pairs]
    b_idx = [p[1] for p in pairs]
    for ci, gamma in enumerate(gammas):
        zs = z_lv.cols_idx([ci * n_pairs + k for k in range(n_pairs)])
        zns = z_nv.cols_idx([ci * n_pairs + k for k in range(n_pairs)])
        avs = lv.cols_idx(a_idx)
        bvs = lv.cols_idx(b_idx)
        cc.constraint_first_row(zs - 1)
        # cyclic: Z(gx)*(b+gamma) - Z(x)*(a+gamma) == 0 on every row; at the
        # last row Z(gx) wraps to Z(first)=1, closing the product
        cc.constraint(zns * (bvs + gamma) - zs * (avs + gamma))


@functools.lru_cache(maxsize=None)
def _lde_selectors(n: int, rate_bits: int, shift: int = gl.GENERATOR) -> dict:
    """Selector vectors over the LDE coset (host numpy, exact):
    xs, Z_H, 1/Z_H, L_first, L_last, z_last = x - g^{n-1}."""
    n_lde = n << rate_bits
    w_big = gl.primitive_root_of_unity(n_lde.bit_length() - 1)
    w_n = gl.primitive_root_of_unity(n.bit_length() - 1)
    g_last = pow(w_n, n - 1, gl.P)
    xs = ntt._coset_points(shift, n_lde)
    s_n = pow(shift, n, gl.P)
    with np.errstate(over="ignore"):  # uint64 scalar steps wrap on purpose
        return _selectors_np(xs, n, n_lde, w_big, g_last, s_n)


def _selectors_np(xs, n, n_lde, w_big, g_last, s_n) -> dict:
    # Z_H(x_i) = s^n * (w_big^n)^i - 1; w_big^n has order blowup
    zh = gl.sub(gl.mul(gl.powers_vec(np.uint64(pow(w_big, n, gl.P)), n_lde), np.uint64(s_n)),
                np.uint64(1))
    n_inv = np.uint64(pow(n, gl.P - 2, gl.P))
    zh_inv = gl.batch_inv(zh)
    l_first = gl.mul(gl.mul(zh, n_inv), gl.batch_inv(gl.sub(xs, np.uint64(1))))
    z_last = gl.sub(xs, np.uint64(g_last))
    l_last = gl.mul(gl.mul(zh, np.uint64(g_last * int(n_inv) % gl.P)), gl.batch_inv(z_last))
    return {
        "xs": xs,
        "zh": zh,
        "zh_inv": zh_inv,
        "l_first": l_first,
        "l_last": l_last,
        "z_last": z_last,
        "g_last": g_last,
    }


def _prove_device(device) -> torch.device:
    """`device`, or the current CUDA device when it is None; never a silent
    CPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "prove: no CUDA card is available (torch.cuda.is_available() is False); "
            "pass device='cpu' to prove on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _mesh_device(mesh, device) -> torch.device:
    """The device of a prove over `mesh`: its first shard's. A `device` that
    names another raises."""
    from ..parallel.sharded import canonical_device

    dev = mesh.devices[0]
    if device is not None and canonical_device(device) != dev:
        raise ValueError(f"prove: device {device} is not the mesh's first device {dev}")
    return dev


def _trace_on(trace, dev: torch.device) -> torch.Tensor:
    """A numpy uint64 trace or an int64 tensor, as an int64 tensor on dev."""
    if isinstance(trace, torch.Tensor):
        if trace.dtype != torch.int64:
            raise TypeError(f"prove: expected an int64 trace tensor, got {trace.dtype}")
        return trace.to(dev)
    return xnp.to_torch(trace, dev)


def prove(air: Air, trace, public_inputs: np.ndarray, cfg: StarkConfig,
          timing=None, mesh=None, device=None) -> StarkProof:
    """Prove `air` on `trace` under `cfg`.

    trace: [n, C] field elements, a numpy uint64 array or an int64 tensor
    (xnp.to_torch), moved to `device`. device: where the prover runs; None
    is the current CUDA device, and raises when there is no card.

    mesh: a parallel.sharded.Mesh. The trace and aux commits run sharded
    (sharded_commit_tree: column-sharded K1, all_to_all, row-sharded leaf
    hashing), composition row-sharded with halo rows
    (evaluate_composition_sharded) and the FRI folds row-sharded where they
    split; the transcript, the quotient commit, the openings, the combine
    and the grind run on the mesh's first device, which `device`, if given,
    must name. Every LDE stays on its shards (no offload). The proof is the
    single-device proof, byte for byte.

    timing: a utils.timing recorder for the prove's phases and spans (a
    TimingTree synchronizes the card at each phase); None records into
    timing.current(), which is a no-op unless a caller set a recorder or
    a torch.profiler trace runs."""
    with np.errstate(over="ignore"), tm.entry(timing, "prove") as tt:
        dev = _prove_device(device) if mesh is None else _mesh_device(mesh, device)
        holder = [_trace_on(trace, dev)]
        del trace
        offload = mesh is None and offload_ldes(retained_lde_bytes(air, holder[0].shape[0], cfg))
        challenger = Challenger(parity=cfg.fri.parity, device=dev)
        st = _prove_statement(air, holder, public_inputs, cfg, challenger, tt, dev, offload=offload,
                              mesh=mesh)
        # FRI batch opening proof
        beta = challenger.get_ext_challenge()
        with tt.scope("opening combine"):
            f_values = st.opening_poly(beta, dev)
        with tt.scope("fri"):
            fri_proof = fri_prove(f_values, gl.GENERATOR, st.oracles(), challenger, cfg.fri,
                                  timing=tt, mesh=mesh)
        if timing is not None:
            timing.finish()
        proof = st.proof(fri_proof)
        del st, f_values  # the prove's device state is freed inside its span
        return proof


@dataclass
class _Statement:
    """One statement after its openings: what the FRI of a prove, or the
    shared FRI of a batch (stark/batch_prove.py), takes from it."""

    n: int
    shift: int  # the LDE coset's shift
    public_inputs: np.ndarray
    trace_c: Commitment
    z_c: Commitment | None
    q_c: Commitment
    openings: StarkOpenings
    inv_den_zeta: torch.Tensor  # 1/(x - zeta) over the LDE coset, [N, 2]
    inv_den_gzeta: torch.Tensor

    def oracles(self) -> list[tuple[merkle.MerkleTree, torch.Tensor]]:
        return [(c.tree, c.lde) for c in (self.trace_c, self.z_c, self.q_c) if c is not None]

    def opening_poly(self, beta, device) -> torch.Tensor:
        """The beta-batched opening polynomial over the LDE coset: [N, 2]."""
        o = self.openings
        aux = [self.z_c.lde] if self.z_c else []
        return _batch_opening_poly(
            [self.trace_c.lde] + aux + [self.q_c.lde],
            [o.trace_zeta] + ([o.z_zeta] if self.z_c else []) + [o.quotient_zeta],
            self.inv_den_zeta,
            [self.trace_c.lde] + aux,
            [o.trace_gzeta] + ([o.z_gzeta] if self.z_c else []),
            self.inv_den_gzeta, beta, device,
        )

    def proof(self, fri_proof: FriProof) -> StarkProof:
        return StarkProof(
            degree_bits=self.n.bit_length() - 1,
            trace_cap=xnp.to_numpy(self.trace_c.tree.cap),
            z_cap=xnp.to_numpy(self.z_c.tree.cap) if self.z_c else None,
            quotient_cap=xnp.to_numpy(self.q_c.tree.cap),
            openings=self.openings,
            fri=fri_proof,
            public_inputs=self.public_inputs,
        )


def _aux_columns(air: Air, trace: torch.Tensor, gammas: list[int], tt, on_host: bool) -> torch.Tensor:
    """The aux block [Z | logUp | AIR-defined] of `trace` on its device or,
    `on_host`, in host memory (the Z columns copied off the card, the logUp
    columns streamed there row block by row block)."""
    pairs, tables, extra_w = air.permutation_pairs(), air.lookup_tables(), air.aux_extra_width()
    parts = []
    if pairs:
        z = compute_z_columns(trace, pairs, gammas)
        parts.append(z.cpu() if on_host else z)
        del z
    if tables:
        with tt.scope("logup"):
            build = compute_logup_columns_streamed if on_host else compute_logup_columns
            parts.append(build(trace, tables, gammas))
    if extra_w:
        # built on the host from one copy of the trace
        with tt.scope("rlc aux"):
            with tt.span("to host", rows=trace.shape[0]):
                host_trace = xnp.to_numpy(trace)
            with tt.span("generate"):
                extra = xnp.to_torch(air.generate_aux(host_trace, gammas))
            with tt.span("to device"):
                parts.append(extra if on_host else extra.to(trace.device))
            del host_trace, extra
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _prove_statement(air: Air, holder: list, public_inputs, cfg: StarkConfig, challenger: Challenger,
                     tt, dev: torch.device, shift: int = gl.GENERATOR, offload: bool = False,
                     prefix: str = "", mesh=None) -> _Statement:
    """One statement's commit, aux, composition, quotient and openings,
    in the transcript order PI, trace cap, gammas, aux cap, alphas,
    quotient cap, zeta, openings (prove's, and each statement's of a
    batch). holder: [the trace on dev], emptied here so that the trace is
    freed once the aux columns are built. shift: the LDE coset's shift.
    offload: keep every LDE in host memory. prefix: of the timing scopes.
    mesh: commit the trace and aux columns and compose over it (prove's
    mesh; dev is its first device)."""
    if mesh is None:
        def commit_matrix(values):
            return commit(values, cfg, offload=offload, shift=shift, device=dev)
    else:
        from ..parallel.sharded import sharded_commit_tree

        def commit_matrix(values):
            return sharded_commit_tree(mesh, values, cfg)

    trace = holder.pop()
    n, num_cols = trace.shape
    assert num_cols == air.num_columns, (num_cols, air.num_columns)
    assert n & (n - 1) == 0
    nc = cfg.num_challenges
    pi_arr = np.asarray(public_inputs, dtype=np.uint64)
    challenger.observe_elements(pi_arr)

    # 1. trace commitment
    with tt.scope(prefix + "trace commit"):
        trace_c = commit_matrix(trace)
    challenger.observe_cap(trace_c.tree.cap)

    # 2. auxiliary columns [Z | logUp | AIR-defined], committed together
    z_c = None
    gammas: list[int] = []
    if air.permutation_pairs() or air.lookup_tables() or air.aux_extra_width():
        gammas = challenger.get_n_challenges(nc)
        with tt.scope(prefix + "aux (Z/logup) commit"):
            with tt.scope("column build"):
                aux = [_aux_columns(air, trace, gammas, tt, offload)]
            with tt.scope("commit"):
                z_c = commit_matrix(aux)
        challenger.observe_cap(z_c.tree.cap)
    del trace  # composition reads trace_c.lde

    # 3. constraint composition -> quotient chunks
    alphas = challenger.get_n_challenges(nc)
    with tt.scope(prefix + "constraint composition"):
        if mesh is None:
            qvals = evaluate_composition(
                air, trace_c.lde, z_c.lde if z_c else None, pi_arr, alphas, gammas, n, cfg,
                shift=shift, device=dev,
            )  # [nc, N]
        else:
            qvals = evaluate_composition_sharded(
                mesh, air, trace_c.lde, z_c.lde if z_c else None, pi_arr, alphas, gammas, n, cfg,
                shift=shift,
            )
    with tt.scope(prefix + "quotient commit"):
        q_coeffs = ntt.interpolate_coset(qvals.T, shift)  # [N, nc]
        del qvals
        # degree < QUOTIENT_CHUNKS * n: split into degree-n chunks
        q_chunk_coeffs = torch.stack(
            [q_coeffs[j * n : (j + 1) * n, k] for k in range(nc) for j in range(QUOTIENT_CHUNKS)],
            dim=1,
        )  # [n, nc*chunks]
        q_lde = ntt.lde_from_coeffs(q_chunk_coeffs, cfg.fri.rate_bits, shift)
        cap_h = min(cfg.fri.cap_height, q_lde.shape[0].bit_length() - 1)
        q_c = Commitment(q_lde, merkle.build_merkle_tree(q_lde, cap_h, cfg.fri.merkle_hash))
        if offload:
            q_c.lde = xnp.host_buffer(q_lde.shape, dev).copy_(q_lde)
        del q_lde
    challenger.observe_cap(q_c.tree.cap)

    # 4. openings at zeta and g*zeta
    zeta = challenger.get_ext_challenge()
    w_n = gl.primitive_root_of_unity(n.bit_length() - 1)
    gzeta = (zeta[0] * w_n % gl.P, zeta[1] * w_n % gl.P)
    xs = xnp.device_table(("sel", "xs", n, cfg.fri.rate_bits, shift), dev,
                          lambda: _lde_selectors(n, cfg.fri.rate_bits, shift)["xs"])
    xs_ext = gl.ext_from_base(xs)
    inv_den_zeta = _ext_inv_x_minus(xs_ext, zeta)
    inv_den_gzeta = _ext_inv_x_minus(xs_ext, gzeta)

    def at(c: Commitment, point, inv_den):
        return ntt.eval_from_lde(c.lde, point, inv_den, shift, dev)

    with tt.scope(prefix + "openings"):
        trace_zeta = at(trace_c, zeta, inv_den_zeta)
        trace_gzeta = at(trace_c, gzeta, inv_den_gzeta)
        z_zeta = z_gzeta = None
        if z_c is not None:
            z_zeta = at(z_c, zeta, inv_den_zeta)
            z_gzeta = at(z_c, gzeta, inv_den_gzeta)
        quotient_zeta = at(q_c, zeta, inv_den_zeta)

    openings = StarkOpenings(
        trace_zeta=xnp.to_numpy(trace_zeta),
        trace_gzeta=xnp.to_numpy(trace_gzeta),
        z_zeta=None if z_zeta is None else xnp.to_numpy(z_zeta),
        z_gzeta=None if z_gzeta is None else xnp.to_numpy(z_gzeta),
        quotient_zeta=xnp.to_numpy(quotient_zeta),
    )
    challenger.observe_elements(openings.flat_elements())
    return _Statement(n, shift, pi_arr, trace_c, z_c, q_c, openings, inv_den_zeta, inv_den_gzeta)


def _ext_inv_x_minus(xs_ext: torch.Tensor, point: tuple[int, int]) -> torch.Tensor:
    """1/(x - point) over the LDE domain: [N, 2]."""
    pt = xnp.as_tensor_like(np.array(point, dtype=np.uint64), xs_ext)
    return gl.ext_inv(gl.ext_sub(xs_ext, pt))


def _ext_dot(w: np.ndarray, y: np.ndarray) -> np.ndarray:
    """sum_t w_t * y_t for extension vectors w, y: [k, 2] -> [2] (host)."""
    return gl.sum_mod(gl.ext_mul(w, y), axis=0)


def _batch_opening_poly(zeta_mats, zeta_ys, inv_den_zeta, gzeta_mats, gzeta_ys,
                        inv_den_gzeta, beta, device=None) -> torch.Tensor:
    """F(x) = G_zeta(x) + beta^{k0} * G_gzeta(x), where each G is the
    beta-combined sum of (p_i(x) - y_i) / (x - point).

    The beta-power weights and the y-side constant accumulate on the host;
    the [N, chunk] matvecs run column chunk by column chunk on `device`
    (default: inv_den_zeta's), each offloaded matrix read there row block
    by row block (sums are exact mod p, so the grouping changes no value)."""
    n_rows = zeta_mats[0].shape[0]
    dev = inv_den_zeta.device if device is None else torch.device(device)
    beta_np = np.array(beta, dtype=np.uint64)

    def group(mats, ys, inv_den):
        total = sum(m.shape[1] for m in mats)
        w = gl.ext_powers_vec(beta_np, total)  # [total, 2] host
        w_t = xnp.to_torch(w, dev)
        s0 = torch.zeros((n_rows,), dtype=torch.int64, device=dev)
        s1 = torch.zeros((n_rows,), dtype=torch.int64, device=dev)
        c_acc = np.zeros((2,), dtype=np.uint64)
        off = 0
        for m, y in zip(mats, ys):
            k = m.shape[1]
            for r0, rows in xnp.row_blocks(m, dev, ntt.OPEN_CHUNK_CELLS):
                r1 = r0 + rows.shape[0]
                chunk = max(ntt.OPEN_CHUNK_CELLS // rows.shape[0], 8)
                for c0 in range(0, k, chunk):
                    blk = rows[:, c0 : c0 + chunk]
                    wk = w_t[off + c0 : off + c0 + blk.shape[1]]
                    s0[r0:r1] = gl.add(s0[r0:r1], gl.sum_mod(gl.mul(blk, wk[None, :, 0]), axis=1))
                    s1[r0:r1] = gl.add(s1[r0:r1], gl.sum_mod(gl.mul(blk, wk[None, :, 1]), axis=1))
            c_acc = gl.ext_add(c_acc, _ext_dot(w[off : off + k], np.asarray(y)))
            off += k
        num = gl.ext_sub(torch.stack([s0, s1], dim=-1), c_acc)
        return gl.ext_mul(num, inv_den), total

    g0, k0 = group(zeta_mats, zeta_ys, inv_den_zeta)
    g1, _ = group(gzeta_mats, gzeta_ys, inv_den_gzeta)
    beta_k0 = gl.ext_pow_const(beta_np, k0)  # host
    return gl.ext_add(g0, gl.ext_mul(g1, beta_k0))
