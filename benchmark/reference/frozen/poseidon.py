# Frozen copy of starky_bn254_tpu_torch/poseidon.py at commit fb7d4c0,
# cut to what the verifier reaches: the host (numpy) sponge, with no
# kernel path, no device tables and no proof-of-work batches.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Poseidon permutation over Goldilocks, width 12, batched over rows.

The same parameter set as the JAX package's poseidon.py: width 12, rate 8,
capacity 4, x^7 S-box, 4 full + 22 partial + 4 full rounds; round
constants by SHA-256 counter-mode rejection sampling from `_SEED` (a
parameter of the construction, not a name: it must not change); MDS =
circ(FAST_MDS_ROW) + diag(MDS_DIAG).

`permute`, `hash_no_pad`, `hash_or_noop` and `compress` take CPU tensors
and reduce to `_sponge_plain` on numpy.

All functions are batched: a state batch has shape [..., 12] int64.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np
import torch

from . import goldilocks as gl
from . import xnp

WIDTH = 12
RATE = 8
CAPACITY = 4
FULL_ROUNDS = 8  # 4 at the start, 4 at the end
PARTIAL_ROUNDS = 22
ALPHA = 7

_SEED = b"starky_bn254_tpu/poseidon/goldilocks-w12/v1"
_DEFAULT_SEED = _SEED


# Circulant MDS first row (all entries small powers of two); exhaustively
# verified MDS by the JAX package's native/mds_check.cpp.
FAST_MDS_ROW = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
DEFAULT_MDS_ROW = FAST_MDS_ROW
MDS_DIAG = (0,) * WIDTH
_RC_TABLE: np.ndarray | None = None  # raw [30, 12] override


def _sample_field_elements(count: int, label: bytes) -> np.ndarray:
    """Deterministic rejection sampling of canonical Goldilocks elements."""
    out = np.empty(count, dtype=np.uint64)
    i = 0
    ctr = 0
    while i < count:
        h = hashlib.sha256(_SEED + b"/" + label + b"/" + str(ctr).encode()).digest()
        ctr += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off : off + 8], "little")
            if v < gl.P and i < count:
                out[i] = v
                i += 1
    return out


@functools.lru_cache(maxsize=None)
def _constants():
    """(rc [30, 12], dense mds [12, 12]) as numpy uint64."""
    n_rounds = FULL_ROUNDS + PARTIAL_ROUNDS
    if _RC_TABLE is not None:
        rc = _RC_TABLE.copy()
    else:
        rc = _sample_field_elements(n_rounds * WIDTH, b"rc").reshape(n_rounds, WIDTH)
    mds = np.empty((WIDTH, WIDTH), dtype=np.uint64)
    for i in range(WIDTH):
        for j in range(WIDTH):
            mds[i, j] = FAST_MDS_ROW[(j - i) % WIDTH]
        mds[i, i] = (int(mds[i, i]) + MDS_DIAG[i]) % gl.P
    return rc, mds


@functools.lru_cache(maxsize=None)
def _int_constants() -> tuple[list[list[int]], list[list[int]]]:
    """(rc, dense mds) as lists of Python ints: the host permutation's
    tables (challenger._permute_host)."""
    rc, mds = _constants()
    return [[int(x) for x in row] for row in rc], [[int(x) for x in row] for row in mds]


_TABLES: dict[tuple, torch.Tensor] = {}


def _sbox(x):
    x2 = gl.square(x)
    x4 = gl.square(x2)
    x6 = gl.mul(x4, x2)
    return gl.mul(x6, x)


def _small_mds() -> bool:
    """Every MDS entry <= 2^16: the small-constant form applies (here and
    in kernel K3); otherwise both take the dense modmul matvec."""
    return max(FAST_MDS_ROW) <= 1 << 16 and max(MDS_DIAG) <= 1 << 16


def _mds_layer(state):
    """M = circ(row) + diag(diag) on numpy u64 rows. With every entry <=
    2^16 each term's 32-bit halves times the entry stay < 2^48 and 13 terms
    sum < 2^53, so the two half-sums are exact and one 128-bit reduction
    finishes; larger entries take the dense modmul matvec. Both give the
    canonical residue of the same sum."""
    (state,), E = gl._prep(state)
    if not _small_mds():
        return gl.sum_mod(gl.mul(state[..., None, :], _constants()[1]), axis=-1)
    # each circ is one float64 matrix product: every term (< 2^48) and
    # partial sum (< 2^53) is an integer that float64 holds exactly
    b = _host_circ(state & E.MASK)  # < 2^53
    a = _host_circ(E.shr(state, 32))
    v_lo_part = E.shl(a & E.MASK, 32)
    v_lo = v_lo_part + b
    carry = E.from_bool(E.lt(v_lo, v_lo_part))
    return gl._reduce128(E.shr(a, 32) + carry, v_lo)


def _host_circ(x: np.ndarray) -> np.ndarray:
    """circ(FAST_MDS_ROW) + diag(MDS_DIAG) applied to numpy u64 rows of
    words below 2^32 (the small-MDS form only), exact."""
    key = ("mds_f64", "host")
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_constants()[1].T.astype(np.float64))
    out = torch.from_numpy(x.astype(np.float64)) @ _TABLES[key]
    return out.numpy().astype(np.uint64)


def _permute_plain(state):
    """30-round permutation of numpy u64 states."""
    rc = _constants()[0]
    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        state = gl.add(state, rc[r])
        if r < half or r >= half + PARTIAL_ROUNDS:
            state = _sbox(state)
        else:
            state = xnp.concatenate([_sbox(state[..., :1]), state[..., 1:]], axis=-1)
        state = _mds_layer(state)
    return state


def _sponge_plain(state, block, out_words: int):
    """The sponge over numpy u64 rows."""
    (block,), E = gl._prep(block)
    n, width = block.shape
    st = E.zeros((n, WIDTH), block) if state is None else state
    for off in range(0, width, RATE):
        chunk = block[:, off : off + RATE]
        if chunk.shape[1] < RATE:  # zero-padded tail chunk
            chunk = xnp.pad(chunk, ((0, 0), (0, RATE - chunk.shape[1])))
        st = _permute_plain(xnp.concatenate([chunk, st[:, RATE:]], axis=1))
    return st[:, :out_words]


def _sponge(state, block, out_words: int):
    """Overwrite-absorb block [..., width] into state [..., 12] (None: zero
    state) in ceil(width / RATE) chunks, the last one zero-padded; returns
    the first `out_words` lanes."""
    batch = tuple(block.shape[:-1])
    block2 = block.reshape(math.prod(batch), block.shape[-1])
    state2 = None if state is None else state.reshape(-1, WIDTH)
    if block.device.type == "cpu":
        # numpy: faster than torch on one CPU thread, from 1 row to 8192
        out = xnp.to_torch(_sponge_plain(None if state2 is None else xnp.to_numpy(state2),
                                         xnp.to_numpy(block2), out_words))
    else:
        raise ValueError(f"poseidon: unsupported device {block.device}")
    return out.reshape(batch + (out_words,))


def permute(state: torch.Tensor) -> torch.Tensor:
    """[..., 12] -> [..., 12]: absorbing a state's own rate lanes is a raw
    permutation."""
    return _sponge(state, state[..., :RATE], WIDTH)


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Fixed-length overwrite-mode sponge: [..., n] -> [..., 4] digest (a
    sub-rate tail is zero-padded; no padding block when n % 8 == 0)."""
    return _sponge(None, inputs, 4)


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 4]: values <= 4 wide are zero-padded, not hashed."""
    n = inputs.shape[-1]
    if n <= 4:
        return torch.nn.functional.pad(inputs, (0, 4 - n))
    return hash_no_pad(inputs)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression: [..., 4] x [..., 4] -> [..., 4]."""
    return _sponge(None, torch.cat([left, right], dim=-1), 4)
