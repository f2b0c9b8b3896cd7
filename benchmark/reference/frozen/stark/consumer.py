# Frozen copy of starky_bn254_tpu_torch/stark/consumer.py at commit fb7d4c0.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Constraint consumer: alpha-Horner accumulation with row selectors.

Plays the role of starky's `ConstraintConsumer` (used by every reference
`eval_*`, e.g. src/modular/modular.rs:102-153) but vectorized: a constraint
may carry a whole lane-stack of limb constraints in one call, and the Horner
accumulation `acc = acc * alpha + c` is applied lane-by-lane in deterministic
order so prover (arrays over LDE rows) and verifier (extension scalars at
zeta) produce identical combinations.

Selector semantics (matching the reference's prover):
* constraint(v):            holds on every row, cyclically (next of last row
                            is the first row);
* constraint_transition(v): skipped on the last row — v is multiplied by
                            z_last(x) = x - g^{n-1};
* constraint_first_row(v):  multiplied by L_0(x);
* constraint_last_row(v):   multiplied by L_{n-1}(x).
"""

from __future__ import annotations

from .. import xnp

from .. import goldilocks as gl
from .field_expr import Val


def _one_like(alpha: Val) -> Val:
    if alpha.ext:
        return Val(xnp.at_set(xnp.zeros_like(alpha.arr), (..., 0), 1), True)
    return Val(xnp.ones_like(alpha.arr), False)


class ConstraintConsumer:
    def __init__(self, alphas: list[Val], z_last: Val, l_first: Val, l_last: Val):
        """alphas: challenge scalars; z_last/l_first/l_last: selector values
        (vectors over LDE rows in prover mode, extension scalars at zeta in
        verifier mode)."""
        self.alphas = alphas
        self.z_last = z_last
        self.l_first = l_first
        self.l_last = l_last
        self.ext = z_last.ext
        self.accs: list[Val | None] = [None] * len(alphas)
        self._pow_cache: dict[tuple[int, int], tuple[Val, Val]] = {}

    # -- internals -----------------------------------------------------------
    def _normalize(self, v: Val) -> tuple[Val, int]:
        """Squeeze a size-1 lane axis; return (val, num_lanes)."""
        axis = -2 if v.ext else -1
        base_ndim = 1  # [2] for ext, [N] (or scalar) for base
        if v.ext:
            if v.arr.ndim >= 2:
                k = v.arr.shape[axis]
                if k == 1:
                    return Val(v.arr.squeeze(axis), True), 1
                return v, k
            return v, 1
        if v.arr.ndim >= 2:
            k = v.arr.shape[axis]
            if k == 1:
                return Val(v.arr.squeeze(axis), False), 1
            return v, k
        return v, 1

    def _alpha_powers(self, idx: int, k: int) -> tuple[Val, Val]:
        """(alpha^k, lane-stacked weights[j] = alpha^{k-1-j}).

        Log-depth scan rather than an unrolled mul chain — with hundreds of
        lanes per constraint the chain was dominating the composition graph.
        """
        key = (idx, k)
        if key not in self._pow_cache:
            alpha = self.alphas[idx]
            if alpha.ext:
                pows = gl.ext_powers_vec(alpha.arr, k + 1)  # [k+1, 2]
                apow_k = Val(pows[k], True)
                weights = Val(xnp.flip(pows[:k], axis=0), True)
            else:
                pows = gl.powers_vec(alpha.arr, k + 1)
                apow_k = Val(pows[k], False)
                weights = Val(xnp.flip(pows[:k]), False)
            self._pow_cache[key] = (apow_k, weights)
        return self._pow_cache[key]

    def _accumulate(self, v: Val):
        v, k = self._normalize(v)
        for idx in range(len(self.alphas)):
            prev = self.accs[idx]
            if k == 1:
                step = self.alphas[idx]
                term = v
            else:
                step, weights = self._alpha_powers(idx, k)
                prod = v * weights
                axis = -2 if v.ext else -1
                term = Val(gl.sum_mod(prod.arr, axis=axis), v.ext)
            self.accs[idx] = term if prev is None else prev * step + term

    def _with_sel(self, v: Val, sel: Val) -> Val:
        v, k = self._normalize(v)
        return v * (sel.lane() if k > 1 else sel)

    # -- public API ----------------------------------------------------------
    def constraint(self, v: Val):
        self._accumulate(v)

    def constraint_transition(self, v: Val):
        self._accumulate(self._with_sel(v, self.z_last))

    def constraint_first_row(self, v: Val):
        self._accumulate(self._with_sel(v, self.l_first))

    def constraint_last_row(self, v: Val):
        self._accumulate(self._with_sel(v, self.l_last))

    def final_accs(self) -> list[Val]:
        assert all(a is not None for a in self.accs), "no constraints emitted"
        return self.accs  # type: ignore
