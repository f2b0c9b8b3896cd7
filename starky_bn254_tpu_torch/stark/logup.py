"""logUp: log-derivative lookup argument (Habock-style running sums).

Proves every cell of the checked columns appears in a table column:

    sum_{rows, checked j} 1/(gamma + c_j)  ==  sum_rows m/(gamma + T)

with a committed multiplicity column m (part of the main trace) and, per
challenge gamma, auxiliary columns committed in the same phase as the
permutation Z columns:

    g       = m/(gamma + T)                       [1 col]
    h_b     = 1/(gamma+c_{2b}) + 1/(gamma+c_{2b+1})   [ceil(k/2) cols]
    S       = running sum of (sum_b h_b - g), S[0] = 0    [1 col]

Constraints (degree <= 3, all cyclic every-row):
    g*(gamma+T) - m == 0
    h_b*(gamma+c1)*(gamma+c2) - (2*gamma + c1 + c2) == 0   (pair batch)
    h_b*(gamma+c) - 1 == 0                                  (single tail)
    S(gx) - S(x) - (sum_b h_b(x) - g(x)) == 0

The cyclic S-recurrence telescopes to sum(delta) == 0, which is the logUp
identity. The columns and constraints are the JAX package's
stark/logup.py, in the same order, so the aux commitment is the same.

Two routes compute 1/(gamma + c) for the checked cells, with the same
canonical residues (`gl.batch_inv(gl.add(c, gamma))`):
* "fermat": a Fermat chain per cell, column chunk by column chunk;
* "table": every lookup in this framework is a u16 range check, so the
  denominators take at most 2^16 values: one 2^16-entry inverse table per
  challenge, and each checked cell becomes a gather.
`pick_route` takes the table from GATHER_MIN_CELLS checked cells up, on
the CPU and on the card alike (the JAX package kept the Fermat chains on
the TPU, whose gathers were slow; chip_smoke.py times both routes on the
H100 at the G1 shape, PERF.md records the numbers).
"""

from __future__ import annotations

import torch

from .. import goldilocks as gl
from .. import xnp
from .consumer import ConstraintConsumer
from .field_expr import RowView, Val

U16 = 1 << 16
GATHER_MIN_CELLS = 1 << 18  # rows x checked columns from which "table" is taken
FERMAT_CHUNK = 128  # checked columns inverted at once on the "fermat" route (even)


def batches(checked: tuple[int, ...]) -> list[tuple[int, ...]]:
    return [tuple(checked[i : i + 2]) for i in range(0, len(checked), 2)]


def table_aux_width(tables) -> int:
    """Aux columns per challenge."""
    return sum(2 + len(batches(t[2])) for t in tables)


def pick_route(n_rows: int, tables) -> str:
    return "table" if n_rows * sum(len(t[2]) for t in tables) >= GATHER_MIN_CELLS else "fermat"


def _inv_shifted(vals: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """1/(vals + gamma) elementwise (a Fermat chain per cell)."""
    return gl.batch_inv(gl.add(vals, gamma))


def inverse_table(gamma: torch.Tensor) -> torch.Tensor:
    """[2^16]: entry v is 1/(v + gamma), the residue _inv_shifted gives."""
    return _inv_shifted(torch.arange(U16, dtype=torch.int64, device=gamma.device), gamma)


def _gather(table: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """table[vals] for u16 cells. A cell >= 2^16 (unsigned; only a forged
    trace has one) reads the last entry, as the JAX package's clamped
    gather does, so no index leaves the table; such a trace fails its
    h * (gamma + c) constraint and verification."""
    return table[torch.where(gl._TorchOps.ge(vals, U16), U16 - 1, vals)]


def _pair_sum(inv_c: torch.Tensor) -> torch.Tensor:
    """1/(g+c_{2b}) + 1/(g+c_{2b+1}) for consecutive pairs: [n, k] -> [n, ceil(k/2)]."""
    if inv_c.shape[1] % 2 == 1:
        inv_c = torch.nn.functional.pad(inv_c, (0, 1))
    return gl.add(inv_c[:, 0::2], inv_c[:, 1::2])


def compute_logup_columns(trace: torch.Tensor, tables, gammas: list[int],
                          route: str | None = None) -> torch.Tensor:
    """[n, nc * table_aux_width] aux columns, challenge-major then
    per-table [g | h... | S]. route: "fermat", "table", or None for
    pick_route's choice; both give the same columns."""
    route = route or pick_route(trace.shape[0], tables)
    if route not in ("fermat", "table"):
        raise ValueError(f"unknown logUp route {route!r}")
    dev = trace.device
    parts, deltas = [], []
    for g_int in gammas:
        gamma = xnp.as_tensor_like(g_int % gl.P, trace)
        inv_tab = inverse_table(gamma) if route == "table" else None
        for (t_col, m_col, checked) in tables:
            if route == "table":
                inv_t = _gather(inv_tab, trace[:, t_col])
                idx = torch.tensor(checked, dtype=torch.int64, device=dev)
                h_mat = _pair_sum(_gather(inv_tab, trace[:, idx]))
            else:
                inv_t = _inv_shifted(trace[:, t_col], gamma)
                h_chunks = []
                for off in range(0, len(checked), FERMAT_CHUNK):
                    idx = torch.tensor(checked[off : off + FERMAT_CHUNK], dtype=torch.int64,
                                       device=dev)
                    h_chunks.append(_pair_sum(_inv_shifted(trace[:, idx], gamma)))
                h_mat = torch.cat(h_chunks, dim=1)
            g = gl.mul(trace[:, m_col], inv_t)
            parts.append((g, h_mat))
            deltas.append(gl.sub(gl.sum_mod(h_mat, axis=1), g))
    # S: the row-shifted running sum, one column per (challenge, table)
    csum = gl.cumsum(torch.stack(deltas, dim=1))
    s_all = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]], dim=0)
    cols = []
    for i, (g, h_mat) in enumerate(parts):
        cols += [g[:, None], h_mat, s_all[:, i : i + 1]]
    return torch.cat(cols, dim=1)


def logup_constraints(
    tables,
    gammas: list[Val],
    lv: RowView,
    nv: RowView,
    aux_lv: RowView,
    aux_nv: RowView,
    cc: ConstraintConsumer,
    aux_offset: int,
):
    """Framework constraints; aux_offset = column where logup aux starts in
    the aux commitment (after permutation Z columns)."""
    w = table_aux_width(tables)
    for ci, gamma in enumerate(gammas):
        base = aux_offset + ci * w
        for (t_col, m_col, checked) in tables:
            bs = batches(checked)
            g_col = base
            h0 = base + 1
            s_col = base + 1 + len(bs)
            base += 2 + len(bs)

            g = aux_lv.col(g_col)
            t = lv.col(t_col)
            m = lv.col(m_col)
            cc.constraint(g * (t + gamma) - m)

            pair_i = [i for i, b in enumerate(bs) if len(b) == 2]
            if pair_i:
                h = aux_lv.cols_idx([h0 + i for i in pair_i])
                c1 = lv.cols_idx([bs[i][0] for i in pair_i])
                c2 = lv.cols_idx([bs[i][1] for i in pair_i])
                cc.constraint(
                    h * (c1 + gamma.lane()) * (c2 + gamma.lane())
                    - (c1 + c2 + gamma.lane() * 2)
                )
            single_i = [i for i, b in enumerate(bs) if len(b) == 1]
            if single_i:
                h = aux_lv.cols_idx([h0 + i for i in single_i])
                c1 = lv.cols_idx([bs[i][0] for i in single_i])
                cc.constraint(h * (c1 + gamma.lane()) - 1)

            all_h = aux_lv.cols(h0, h0 + len(bs))
            axis = -2 if all_h.ext else -1
            h_sum = Val(gl.sum_mod(all_h.arr, axis=axis), all_h.ext)
            s = aux_lv.col(s_col)
            s_next = aux_nv.col(s_col)
            cc.constraint(s_next - s - (h_sum - g))
