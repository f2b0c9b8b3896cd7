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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import goldilocks as gl
from .. import merkle, ntt, xnp
from ..challenger import Challenger
from .air import Air
from .composition import evaluate_composition
from .config import StarkConfig
from .consumer import ConstraintConsumer
from .field_expr import RowView
from .fri import fri_prove
from .logup import compute_logup_columns
from .proof import StarkOpenings, StarkProof

QUOTIENT_CHUNKS = 2  # constraint degree 3 => quotient degree < 2n


@dataclass
class Commitment:
    lde: torch.Tensor  # [N, C]
    tree: merkle.MerkleTree


def commit(values: torch.Tensor, cfg: StarkConfig, shift: int = gl.GENERATOR) -> Commitment:
    """INTT, coset LDE, Merkle tree over the LDE rows. Neither the subgroup
    values nor the coefficients are kept: openings are evaluated
    barycentrically from the LDE (ntt.eval_from_lde)."""
    coeffs = ntt.interpolate_coeffs(values)
    lde = ntt.lde_from_coeffs(coeffs, cfg.fri.rate_bits, shift)
    del coeffs
    cap_h = min(cfg.fri.cap_height, lde.shape[0].bit_length() - 1)
    tree = merkle.build_merkle_tree(lde, cap_h, cfg.fri.merkle_hash)
    return Commitment(lde, tree)


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


def prove(air: Air, trace, public_inputs: np.ndarray, cfg: StarkConfig,
          timing=None, mesh=None, device=None) -> StarkProof:
    """Prove `air` on `trace` under `cfg`.

    trace: [n, C] field elements, a numpy uint64 array or an int64 tensor
    (xnp.to_torch), moved to `device`. device: where the prover runs; None
    is the current CUDA device, and raises when there is no card."""
    from ..utils.timing import TimingTree

    dev = _prove_device(device)
    if isinstance(trace, torch.Tensor):
        if trace.dtype != torch.int64:
            raise TypeError(f"prove: expected an int64 trace tensor, got {trace.dtype}")
        trace = trace.to(dev)
    else:
        trace = xnp.to_torch(trace, dev)
    if mesh is not None:
        raise NotImplementedError("sharded proving is not ported yet")
    if cfg.fri.parity:
        raise NotImplementedError("transcript-parity mode is not ported yet")

    tt = timing if timing is not None else TimingTree("prove", dev)
    n, num_cols = trace.shape
    assert num_cols == air.num_columns, (num_cols, air.num_columns)
    assert n & (n - 1) == 0
    degree_bits = n.bit_length() - 1
    nc = cfg.num_challenges

    with np.errstate(over="ignore"):
        challenger = Challenger(device=dev)
        pi_arr = np.asarray(public_inputs, dtype=np.uint64)
        challenger.observe_elements(pi_arr)

        # 1. trace commitment
        with tt.scope("trace commit"):
            trace_c = commit(trace, cfg)
        challenger.observe_cap(trace_c.tree.cap)

        # 2. auxiliary columns [Z | logUp | AIR-defined], committed together
        pairs = air.permutation_pairs()
        tables = air.lookup_tables()
        extra_w = air.aux_extra_width()
        z_c = None
        gammas: list[int] = []
        if pairs or tables or extra_w:
            gammas = challenger.get_n_challenges(nc)
            with tt.scope("aux (Z/logup) commit"):
                with tt.scope("column build"):
                    parts = []
                    if pairs:
                        parts.append(compute_z_columns(trace, pairs, gammas))
                    if tables:
                        with tt.scope("logup"):
                            parts.append(compute_logup_columns(trace, tables, gammas))
                    if extra_w:
                        # built on the host from one copy of the trace
                        with tt.scope("rlc aux"):
                            host_trace = xnp.to_numpy(trace)
                            parts.append(xnp.to_torch(air.generate_aux(host_trace, gammas), dev))
                            del host_trace
                    z_cols = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
                    del parts
                with tt.scope("commit"):
                    z_c = commit(z_cols, cfg)
                del z_cols
            challenger.observe_cap(z_c.tree.cap)
        del trace  # composition reads trace_c.lde

        # 3. constraint composition -> quotient chunks
        alphas = challenger.get_n_challenges(nc)
        with tt.scope("constraint composition"):
            qvals = evaluate_composition(
                air, trace_c.lde, z_c.lde if z_c else None, pi_arr, alphas, gammas, n, cfg
            )  # [nc, N]
        with tt.scope("quotient commit"):
            q_coeffs = ntt.interpolate_coset(qvals.T, gl.GENERATOR)  # [N, nc]
            del qvals
            # degree < QUOTIENT_CHUNKS * n: split into degree-n chunks
            q_chunk_coeffs = torch.stack(
                [q_coeffs[j * n : (j + 1) * n, k] for k in range(nc) for j in range(QUOTIENT_CHUNKS)],
                dim=1,
            )  # [n, nc*chunks]
            q_lde = ntt.lde_from_coeffs(q_chunk_coeffs, cfg.fri.rate_bits)
            cap_h = min(cfg.fri.cap_height, q_lde.shape[0].bit_length() - 1)
            q_tree = merkle.build_merkle_tree(q_lde, cap_h, cfg.fri.merkle_hash)
        challenger.observe_cap(q_tree.cap)

        # 4. openings at zeta and g*zeta
        zeta = challenger.get_ext_challenge()
        w_n = gl.primitive_root_of_unity(degree_bits)
        gzeta = (zeta[0] * w_n % gl.P, zeta[1] * w_n % gl.P)
        xs = xnp.device_table(("sel", "xs", n, cfg.fri.rate_bits, gl.GENERATOR), dev,
                          lambda: _lde_selectors(n, cfg.fri.rate_bits)["xs"])
        xs_ext = gl.ext_from_base(xs)
        inv_den_zeta = _ext_inv_x_minus(xs_ext, zeta)
        inv_den_gzeta = _ext_inv_x_minus(xs_ext, gzeta)

        with tt.scope("openings"):
            trace_zeta = ntt.eval_from_lde(trace_c.lde, zeta, inv_den_zeta)
            trace_gzeta = ntt.eval_from_lde(trace_c.lde, gzeta, inv_den_gzeta)
            z_zeta = z_gzeta = None
            if z_c is not None:
                z_zeta = ntt.eval_from_lde(z_c.lde, zeta, inv_den_zeta)
                z_gzeta = ntt.eval_from_lde(z_c.lde, gzeta, inv_den_gzeta)
            quotient_zeta = ntt.eval_from_lde(q_lde, zeta, inv_den_zeta)

        openings = StarkOpenings(
            trace_zeta=xnp.to_numpy(trace_zeta),
            trace_gzeta=xnp.to_numpy(trace_gzeta),
            z_zeta=None if z_zeta is None else xnp.to_numpy(z_zeta),
            z_gzeta=None if z_gzeta is None else xnp.to_numpy(z_gzeta),
            quotient_zeta=xnp.to_numpy(quotient_zeta),
        )
        challenger.observe_elements(openings.flat_elements())

        # 5. FRI batch opening proof
        beta = challenger.get_ext_challenge()
        zeta_mats = [trace_c.lde] + ([z_c.lde] if z_c else []) + [q_lde]
        zeta_ys = [openings.trace_zeta] + ([openings.z_zeta] if z_c else []) + [openings.quotient_zeta]
        gzeta_mats = [trace_c.lde] + ([z_c.lde] if z_c else [])
        gzeta_ys = [openings.trace_gzeta] + ([openings.z_gzeta] if z_c else [])
        with tt.scope("opening combine"):
            f_values = _batch_opening_poly(
                zeta_mats, zeta_ys, inv_den_zeta, gzeta_mats, gzeta_ys, inv_den_gzeta, beta
            )

        oracles = [(trace_c.tree, trace_c.lde)]
        if z_c is not None:
            oracles.append((z_c.tree, z_c.lde))
        oracles.append((q_tree, q_lde))

        with tt.scope("fri"):
            fri_proof = fri_prove(f_values, gl.GENERATOR, oracles, challenger, cfg.fri, timing=tt)
        tt.finish()

    return StarkProof(
        degree_bits=degree_bits,
        trace_cap=xnp.to_numpy(trace_c.tree.cap),
        z_cap=xnp.to_numpy(z_c.tree.cap) if z_c else None,
        quotient_cap=xnp.to_numpy(q_tree.cap),
        openings=openings,
        fri=fri_proof,
        public_inputs=pi_arr,
    )


def _ext_inv_x_minus(xs_ext: torch.Tensor, point: tuple[int, int]) -> torch.Tensor:
    """1/(x - point) over the LDE domain: [N, 2]."""
    pt = xnp.as_tensor_like(np.array(point, dtype=np.uint64), xs_ext)
    return gl.ext_inv(gl.ext_sub(xs_ext, pt))


def _ext_dot(w: np.ndarray, y: np.ndarray) -> np.ndarray:
    """sum_t w_t * y_t for extension vectors w, y: [k, 2] -> [2] (host)."""
    return gl.sum_mod(gl.ext_mul(w, y), axis=0)


def _batch_opening_poly(zeta_mats, zeta_ys, inv_den_zeta, gzeta_mats, gzeta_ys,
                        inv_den_gzeta, beta) -> torch.Tensor:
    """F(x) = G_zeta(x) + beta^{k0} * G_gzeta(x), where each G is the
    beta-combined sum of (p_i(x) - y_i) / (x - point).

    The beta-power weights and the y-side constant accumulate on the host;
    the [N, chunk] matvecs run column chunk by column chunk on the device
    (sums are exact mod p, so the grouping changes no value)."""
    n_rows = zeta_mats[0].shape[0]
    dev = zeta_mats[0].device
    chunk = max(ntt.OPEN_CHUNK_CELLS // n_rows, 8)
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
            for c0 in range(0, k, chunk):
                c1 = min(c0 + chunk, k)
                blk = m[:, c0:c1]
                wk = w_t[off + c0 : off + c1]
                s0 = gl.add(s0, gl.sum_mod(gl.mul(blk, wk[None, :, 0]), axis=1))
                s1 = gl.add(s1, gl.sum_mod(gl.mul(blk, wk[None, :, 1]), axis=1))
            c_acc = gl.ext_add(c_acc, _ext_dot(w[off : off + k], np.asarray(y)))
            off += k
        num = gl.ext_sub(torch.stack([s0, s1], dim=-1), c_acc)
        return gl.ext_mul(num, inv_den), total

    g0, k0 = group(zeta_mats, zeta_ys, inv_den_zeta)
    g1, _ = group(gzeta_mats, gzeta_ys, inv_den_gzeta)
    beta_k0 = gl.ext_pow_const(beta_np, k0)  # host
    return gl.ext_add(g0, gl.ext_mul(g1, beta_k0))
