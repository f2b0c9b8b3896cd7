"""Poseidon permutation over Goldilocks, width 12, batched over rows.

The same parameter set as the JAX package's poseidon.py: width 12, rate 8,
capacity 4, x^7 S-box, 4 full + 22 partial + 4 full rounds; round
constants by SHA-256 counter-mode rejection sampling from `_SEED` (a
parameter of the construction, not a name: it must not change); MDS =
circ(FAST_MDS_ROW) + diag(MDS_DIAG). `set_params` swaps the whole set and
`params_from_jax` installs the JAX package's tables verbatim.

`permute`, `sponge_absorb`, `hash_no_pad` and `compress` reduce to
`_sponge`, the wrapper of kernel K3 (csrc/poseidon.cu): on a CUDA tensor it
launches the kernel with the current constants as device tables, in the
layout `_sponge_form` picks from the row count and the MDS form
`_small_mds` picks from the parameters; on a CPU tensor it runs
`_sponge_plain` on numpy. `grind_batch` is the fused proof-of-work batch (kernel
entry starky_poseidon_grind, plain twin `_grind_plain`).

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

LAUNCHES = 0  # K3 launches (sponge and grind entry points)

# Sponges of at most this many rows run one state per 16 lanes (K3's
# cooperative form: a permutation's latency is what such a batch waits
# for); larger ones one state per thread. chip_smoke.py's layout sweep on
# an H100 puts the crossover between 8192 rows (coop faster) and 12288
# (row faster); PERF.md has the times.
COOP_MAX_ROWS = 8192

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


def set_params(seed: bytes | None = None, mds_row: tuple | None = None,
               rc_table=None, mds_diag: tuple | None = None):
    """Swap in a different Poseidon parameter set for the whole package:
    `seed` re-derives the round constants, `rc_table` ingests a raw
    [30, 12] table, `mds_row` / `mds_diag` set M = circ(row) + diag(diag).
    Clears every dependent cache, including the kernel's device tables."""
    global _SEED, FAST_MDS_ROW, MDS_DIAG, _RC_TABLE
    if seed is not None:
        _SEED = bytes(seed)
        _RC_TABLE = None
    if rc_table is not None:
        tbl = np.asarray(rc_table, dtype=np.uint64)
        assert tbl.shape == (FULL_ROUNDS + PARTIAL_ROUNDS, WIDTH), tbl.shape
        assert int(tbl.max()) < gl.P, "round constants must be canonical"
        _RC_TABLE = tbl.copy()
    if mds_row is not None:
        row = tuple(int(v) for v in mds_row)
        assert len(row) == WIDTH and all(0 <= v < gl.P for v in row)
        FAST_MDS_ROW = row
    if mds_diag is not None:
        diag = tuple(int(v) for v in mds_diag)
        assert len(diag) == WIDTH and all(0 <= v < gl.P for v in diag)
        MDS_DIAG = diag
    _constants.cache_clear()
    _TABLES.clear()


def params_from_jax(rc, mds_row, mds_diag) -> None:
    """Install the JAX package's parameter set, given as numpy arrays
    (its poseidon._constants()[0], FAST_MDS_ROW and MDS_DIAG)."""
    set_params(
        rc_table=np.asarray(rc, dtype=np.uint64),
        mds_row=tuple(int(v) for v in np.asarray(mds_row).reshape(-1)),
        mds_diag=tuple(int(v) for v in np.asarray(mds_diag).reshape(-1)),
    )


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


_TABLES: dict[tuple, torch.Tensor] = {}


def _table(name: str, device) -> torch.Tensor:
    """The current constants as int64 tensors on `device` (cleared by
    set_params)."""
    key = (name, str(device))
    if key not in _TABLES:
        rc, mds = _constants()
        if name == "rc":
            arr = rc
        elif name == "mds":
            arr = mds
        elif name == "row":
            arr = np.array(FAST_MDS_ROW, dtype=np.uint64)
        else:
            arr = np.array(MDS_DIAG, dtype=np.uint64)
        _TABLES[key] = xnp.to_torch(np.ascontiguousarray(arr), device)
    return _TABLES[key]


def _sbox(x):
    x2 = gl.square(x)
    x4 = gl.square(x2)
    x6 = gl.mul(x4, x2)
    return gl.mul(x6, x)


def _small_mds() -> bool:
    """Every MDS entry <= 2^16: the small-constant form applies (here and
    in kernel K3); otherwise both take the dense modmul matvec."""
    return max(FAST_MDS_ROW) <= 1 << 16 and max(MDS_DIAG) <= 1 << 16


def _sponge_form(n_rows: int) -> str:
    """K3's state layout for a sponge over n_rows rows: "coop" (one state
    per 16 lanes) up to COOP_MAX_ROWS, else "row" (one state per thread)."""
    return "coop" if n_rows <= COOP_MAX_ROWS else "row"


def _mds_layer(state):
    """M = circ(row) + diag(diag). With every entry <= 2^16 each term's
    32-bit halves times the entry stay < 2^48 and 13 terms sum < 2^53, so
    the two half-sums are exact and one 128-bit reduction finishes (the JAX
    package's shift/mul16 forms); larger entries take the dense modmul
    matvec. Both give the canonical residue of the same sum. Runs on either
    engine (int64 tensors or numpy uint64)."""
    (state,), E = gl._prep(state)
    host = E is gl._NumpyOps
    if not _small_mds():
        mds = _constants()[1] if host else _table("mds", state.device)
        return gl.sum_mod(gl.mul(state[..., None, :], mds), axis=-1)
    diag = None if host else _table("diag", state.device)

    def circ(x):
        if host:
            # one float64 matrix product: every term (< 2^48) and partial
            # sum (< 2^53) is an integer that float64 holds exactly, in any
            # order of summation
            return _host_circ(x)
        # out[i] = sum_d row[d] * x[(i + d) % 12], over views of [x | x]
        xx = xnp.concatenate([x, x], axis=-1)
        acc = x * diag
        for d, c in enumerate(FAST_MDS_ROW):
            acc = acc + xx[..., d : d + WIDTH] * c
        return acc

    b = circ(state & E.MASK)  # < 2^53
    a = circ(E.shr(state, 32))
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
    """30-round permutation in plain array ops: torch (any device) or numpy."""
    rc = _constants()[0] if isinstance(state, np.ndarray) else _table("rc", state.device)
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
    """The sponge in plain array ops, on block's engine (an int64 tensor on
    any device, or a numpy uint64 array)."""
    (block,), E = gl._prep(block)
    n, width = block.shape
    st = E.zeros((n, WIDTH), block) if state is None else state
    for off in range(0, width, RATE):
        chunk = block[:, off : off + RATE]
        if chunk.shape[1] < RATE:  # zero-padded tail chunk
            chunk = xnp.pad(chunk, ((0, 0), (0, RATE - chunk.shape[1])))
        st = _permute_plain(xnp.concatenate([chunk, st[:, RATE:]], axis=1))
    return st[:, :out_words]


def _sponge_cuda(state, block, out_words: int, form: str | None = None):
    """K3 over [n, width] rows; `form` ("coop" or "row") overrides
    `_sponge_form(n)`."""
    global LAUNCHES
    from . import cuda_lib

    if block.stride(-1) != 1:
        block = block.contiguous()
    st = None if state is None else state.contiguous()
    cuda_lib.require_cuda_u64("poseidon", *((block,) if st is None else (block, st)))
    n, width = block.shape
    if st is not None and tuple(st.shape) != (n, WIDTH):
        raise ValueError(f"poseidon: state shape {tuple(st.shape)} != {(n, WIDTH)}")
    form = _sponge_form(n) if form is None else form
    if form not in ("coop", "row"):
        raise ValueError(f"poseidon: unknown sponge form {form!r}")
    out = torch.empty((n, out_words), dtype=torch.int64, device=block.device)
    rc, row, diag = (_table(k, block.device) for k in ("rc", "row", "diag"))
    with torch.cuda.device(block.device):
        err = cuda_lib.lib().starky_poseidon_sponge(
            None if st is None else st.data_ptr(), block.data_ptr(), n, width,
            block.stride(0), rc.data_ptr(), row.data_ptr(), diag.data_ptr(), out.data_ptr(),
            out_words, int(_small_mds()), int(form == "coop"), cuda_lib.stream_of(block),
        )
    cuda_lib.check(err, "poseidon")
    LAUNCHES += 1
    return out


def _sponge(state, block, out_words: int):
    """Overwrite-absorb block [..., width] into state [..., 12] (None: zero
    state) in ceil(width / RATE) chunks, the last one zero-padded; returns
    the first `out_words` lanes."""
    batch = tuple(block.shape[:-1])
    block2 = block.reshape(math.prod(batch), block.shape[-1])
    state2 = None if state is None else state.reshape(-1, WIDTH)
    if block.device.type == "cuda":
        out = _sponge_cuda(state2, block2, out_words)
    elif block.device.type == "cpu":
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


def sponge_absorb(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Absorb a column block (width a multiple of RATE) into running sponge
    states; chaining blocks equals hash_no_pad over the concatenated row."""
    n = block.shape[-1]
    assert n % RATE == 0 and n > 0
    return _sponge(state, block, WIDTH)


def finalize(state: torch.Tensor, tail: torch.Tensor | None = None) -> torch.Tensor:
    """End an overwrite-mode absorb stream: absorb the zero-padded sub-rate
    tail (if any) and return the [..., 4] digests."""
    if tail is not None and tail.shape[-1]:
        state = _sponge(state, tail, WIDTH)
    return state[..., :4]


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 4]: values <= 4 wide are zero-padded, not hashed."""
    n = inputs.shape[-1]
    if n <= 4:
        return torch.nn.functional.pad(inputs, (0, 4 - n))
    return hash_no_pad(inputs)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression: [..., 4] x [..., 4] -> [..., 4]."""
    return _sponge(None, torch.cat([left, right], dim=-1), 4)


# ----------------------------------------------------------------------------
# Proof-of-work batch: lowest i in [0, batch) with
# permute([seed, start + i, 0, ...])[0] < threshold, or batch when none.


def _grind_plain(seed: int, start: int, batch: int, threshold: int, device) -> int:
    state = torch.zeros((batch, WIDTH), dtype=torch.int64, device=device)
    state[:, 0] = xnp.as_tensor_like(seed, state)
    state[:, 1] = xnp.as_tensor_like(start, state) + torch.arange(batch, device=device)
    out = _permute_plain(state)[:, 0]
    hits = gl._TorchOps.lt(out, xnp.as_tensor_like(threshold, out))
    if not bool(hits.any()):
        return batch
    return int(torch.argmax(hits.to(torch.int8)))


def _grind_cuda(seed: int, start: int, batch: int, threshold: int, device) -> int:
    global LAUNCHES
    from . import cuda_lib

    result = torch.full((1,), batch, dtype=torch.int64, device=device)
    rc, row, diag = (_table(k, result.device) for k in ("rc", "row", "diag"))
    with torch.cuda.device(result.device):
        err = cuda_lib.lib().starky_poseidon_grind(
            seed, start, batch, threshold, rc.data_ptr(), row.data_ptr(), diag.data_ptr(),
            int(_small_mds()), result.data_ptr(), cuda_lib.stream_of(result),
        )
    cuda_lib.check(err, "poseidon_grind")
    LAUNCHES += 1
    return int(result.item())


def grind_batch(seed: int, start: int, batch: int, threshold: int, device) -> int:
    """First hit index of one proof-of-work batch (batch if none)."""
    device = torch.device(device)
    if device.type == "cuda":
        return _grind_cuda(seed, start, batch, threshold, device)
    if device.type != "cpu":
        raise ValueError(f"poseidon: unsupported device {device}")
    return _grind_plain(seed, start, batch, threshold, device)
