"""Row-blocked constraint composition.

The prover evaluates the AIR's constraints (plus the framework's
permutation and logUp constraints and the AIR's aux constraints) over every
LDE point: `air.eval` runs eagerly on int64 tensors over row blocks of the
LDE, on the LDE's device, and the `ConstraintConsumer` folds the
constraints with the alpha-Horner recurrence acc = acc * alpha^k + term in
the same order and with the same lane arithmetic as the verifier's replay
at zeta (`evaluate_composition_at_zeta`, which runs the identical
`air.eval` on host numpy extension scalars).

Constraint evaluation is row-local (lv/nv only), so a block needs just
`blowup` halo rows. The block height is chosen from the device's free
memory: the eval of a wide AIR holds about five [B, width] int64 words
per committed cell at its peak (`_TEMPS_PER_CELL`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import goldilocks as gl
from .. import xnp
from .air import Air
from .config import StarkConfig
from .consumer import ConstraintConsumer
from .field_expr import PublicInputsView, RowView, Val

# live int64 words per committed cell of a row block at the eval's peak,
# used only to size row blocks: 1.5x the larger of two measurements on an
# NVIDIA H100 80GB HBM3 (700.00 W), chip_smoke.py's composition probe, peak
# device memory above the composition's start over 8 * rows * (trace + aux
# columns): G2ExpAir(128) 5.44 (2 blocks of 65536 x 1558), Fq12ExpAir(128)
# 4.41 (16 blocks of 8192 x 7084). The estimate it replaces, 24, cut
# Fq12ExpAir(128)'s composition into 16 blocks.
_TEMPS_PER_CELL = 9
# row-block budget on the CPU, bytes
CPU_BLOCK_BYTES = 1 << 28


def _block_rows(mat: torch.Tensor, r0: int, length: int, n: int) -> torch.Tensor:
    """Rows [r0, r0+length) of mat with cyclic wraparound."""
    end = r0 + length
    if end <= n:
        return mat[r0:end]
    return torch.cat([mat[r0:n], mat[: end - n]], dim=0)


def pick_block_rows(n_lde: int, width: int, device: torch.device) -> int:
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // 2
    else:
        budget = CPU_BLOCK_BYTES
    b = n_lde
    while b > 256 and b * width * 8 * _TEMPS_PER_CELL > budget:
        b //= 2
    return b


def _emit_constraints(air: Air, lv, nv, z_lv, z_nv, pi, gammas_v, cc, ext: bool):
    """AIR constraints, then over the aux block [Z | logUp | extra] the
    framework's permutation constraints, the logUp constraints and the
    AIR's own aux constraints: the one order shared by prover and verifier
    (the JAX package's composition.py:105-122)."""
    from .logup import logup_constraints, table_aux_width
    from .prover import permutation_constraints

    air.eval(lv, nv, pi, cc)
    if z_lv is None:
        return
    nc = len(gammas_v)
    pairs = air.permutation_pairs()
    tables = air.lookup_tables()
    if pairs:
        permutation_constraints(pairs, gammas_v, lv, nv, z_lv, z_nv, cc, ext)
    if tables:
        logup_constraints(tables, gammas_v, lv, nv, z_lv, z_nv, cc, aux_offset=nc * len(pairs))
    if air.aux_extra_width():
        air.eval_extra(lv, nv, z_lv, z_nv, gammas_v, pi, cc,
                       aux_offset=nc * (len(pairs) + table_aux_width(tables)))


def evaluate_composition(
    air: Air,
    trace_lde: torch.Tensor,
    z_lde: torch.Tensor | None,
    public_inputs: np.ndarray,
    alphas: list[int],
    gammas: list[int],
    n: int,
    cfg: StarkConfig,
    shift: int = gl.GENERATOR,
    block_rows: int | None = None,
) -> torch.Tensor:
    """Constraint composition over all LDE points: [nc, N] quotient values
    (already divided by Z_H)."""
    from .prover import _lde_selectors

    n_lde = trace_lde.shape[0]
    dev = trace_lde.device
    pad = cfg.fri.blowup
    width = air.num_columns + (z_lde.shape[1] if z_lde is not None else 0)
    B = block_rows or pick_block_rows(n_lde, width, dev)
    sels = {
        k: xnp.device_table(("sel", k, n, cfg.fri.rate_bits, shift), dev,
                            lambda k=k: _lde_selectors(n, cfg.fri.rate_bits, shift)[k])
        for k in ("z_last", "l_first", "l_last", "zh_inv")
    }
    pi = PublicInputsView(xnp.to_torch(public_inputs, dev), ext=False)
    ref = trace_lde
    alphas_t = [xnp.as_tensor_like(a % gl.P, ref) for a in alphas]
    gammas_v = [Val(xnp.as_tensor_like(g % gl.P, ref), False) for g in gammas]

    out_blocks = []
    for r0 in range(0, n_lde, B):
        tb = _block_rows(trace_lde, r0, B + pad, n_lde)
        lv = RowView(tb, ext=False, start=0, length=B)
        nv = RowView(tb, ext=False, start=pad, length=B)
        z_lv = z_nv = None
        if z_lde is not None:
            zb = _block_rows(z_lde, r0, B + pad, n_lde)
            z_lv = RowView(zb, ext=False, start=0, length=B)
            z_nv = RowView(zb, ext=False, start=pad, length=B)
        cc = ConstraintConsumer(
            [Val(a, False) for a in alphas_t],
            z_last=Val(sels["z_last"][r0 : r0 + B], False),
            l_first=Val(sels["l_first"][r0 : r0 + B], False),
            l_last=Val(sels["l_last"][r0 : r0 + B], False),
        )
        _emit_constraints(air, lv, nv, z_lv, z_nv, pi, gammas_v, cc, ext=False)
        zh_inv = sels["zh_inv"][r0 : r0 + B]
        out_blocks.append(torch.stack([gl.mul(acc.arr, zh_inv) for acc in cc.final_accs()]))
        del tb, lv, nv, z_lv, z_nv, cc
    return out_blocks[0] if len(out_blocks) == 1 else torch.cat(out_blocks, dim=1)


def evaluate_composition_at_zeta(
    air: Air,
    trace_zeta,
    trace_gzeta,
    z_zeta,
    z_gzeta,
    public_inputs,
    alphas: list[int],
    gammas: list[int],
    sel_z_last,
    sel_l_first,
    sel_l_last,
    cfg: StarkConfig,
) -> np.ndarray:
    """[nc, 2] alpha-combined constraint values at zeta (NOT divided by
    Z_H), on host numpy: the same constraints, in the same order, as the
    prover's row-block evaluation."""

    def ext_pair(x) -> np.ndarray:
        return np.array(x, dtype=np.uint64)

    lv = RowView(np.asarray(trace_zeta, dtype=np.uint64), ext=True)
    nv = RowView(np.asarray(trace_gzeta, dtype=np.uint64), ext=True)
    pi = PublicInputsView(np.asarray(public_inputs, dtype=np.uint64), ext=True)
    cc = ConstraintConsumer(
        [Val(ext_pair([a, 0]), True) for a in alphas],
        z_last=Val(ext_pair(sel_z_last), True),
        l_first=Val(ext_pair(sel_l_first), True),
        l_last=Val(ext_pair(sel_l_last), True),
    )
    z_lv = z_nv = None
    if z_zeta is not None:
        z_lv = RowView(np.asarray(z_zeta, dtype=np.uint64), ext=True)
        z_nv = RowView(np.asarray(z_gzeta, dtype=np.uint64), ext=True)
    gammas_v = [Val(ext_pair([g, 0]), True) for g in gammas]
    _emit_constraints(air, lv, nv, z_lv, z_nv, pi, gammas_v, cc, ext=True)
    return np.stack([np.asarray(a.arr, dtype=np.uint64) for a in cc.final_accs()])
