"""Keccak-f[1600] Merkle hasher (FriConfig(merkle_hash="keccak")).

The same sponge as the JAX package's keccak.py: capacity 8 lanes (rate 17),
word-granular 10*1 padding, digest = the first 4 lanes. Round constants and
rotation offsets are DERIVED here from the Keccak reference definition
(LFSR x^8+x^6+x^5+x^4+1 and the (t+1)(t+2)/2 pi-walk), and `sha3_256`
builds FIPS 202 SHA3-256 on the permutation so tests can pin it against
hashlib.

Every sponge entry point (hash_no_pad, sponge_absorb, finalize, compress)
reduces to `_sponge`, the wrapper of kernel K2 (csrc/keccak.cu): on a CUDA
tensor it launches the kernel, which absorbs all chunks of a row in one
launch; on a CPU tensor it runs `_sponge_plain`, the same chunk sequence in
torch ops. Lanes are u64 words held as int64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import xnp

WIDTH = 25  # lanes (u64 words) of state
RATE = 17  # absorbed lanes per permutation (1088-bit rate / 512-bit capacity)
CAPACITY = 8
ROUNDS = 24
DIGEST = 4

LAUNCHES = 0  # K2 launches


@functools.lru_cache(maxsize=None)
def _round_constants() -> tuple[int, ...]:
    """RC[i] from the degree-8 LFSR of the Keccak reference (FIPS 202 B.2)."""

    def rc_bit(t: int) -> int:
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171  # x^8 + x^6 + x^5 + x^4 + 1
        return r & 1

    out = []
    for i in range(ROUNDS):
        rc = 0
        for j in range(7):
            if rc_bit(7 * i + j):
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _rho_offsets() -> tuple[int, ...]:
    """Rotation offset per lane index x + 5*y, from the pi-walk recurrence."""
    r = [0] * 25
    x, y = 1, 0
    for t in range(24):
        r[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return tuple(r)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@functools.lru_cache(maxsize=None)
def _plain_tables():
    """Index tables of the vectorized round over a [..., 25] state."""
    rho = _rho_offsets()
    pi_src = [0] * 25  # b[dst] = rol(a[src], rho[src])
    for x in range(5):
        for y in range(5):
            pi_src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    chi1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
    chi2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
    return (
        np.array(rho, dtype=np.int64),
        np.array(pi_src, dtype=np.int64),
        np.array(chi1, dtype=np.int64),
        np.array(chi2, dtype=np.int64),
        [_signed(rc) for rc in _round_constants()],
    )


def _shr(v, k):
    """Logical right shift of int64 words by k (int or per-lane tensor)."""
    mask = (torch.ones_like(v) << (64 - k)) - 1 if isinstance(k, torch.Tensor) else (1 << (64 - k)) - 1
    return (v >> k) & mask


def permute(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on [..., 25] int64 lanes (torch ops, any device)."""
    rho, pi_src, chi1, chi2, rcs = _plain_tables()
    dev = state.device
    rho_t = torch.from_numpy(rho).to(dev)
    back_t = (64 - rho_t) % 64  # rho = 0 rotates by nothing: shr by 0 keeps a
    pi_t = torch.from_numpy(pi_src).to(dev)
    chi1_t = torch.from_numpy(chi1).to(dev)
    chi2_t = torch.from_numpy(chi2).to(dev)
    d_prev = torch.tensor([4, 0, 1, 2, 3], device=dev)
    d_next = torch.tensor([1, 2, 3, 4, 0], device=dev)
    tile = torch.arange(25, device=dev) % 5
    a = state
    for rc in rcs:
        c = a[..., 0:5] ^ a[..., 5:10] ^ a[..., 10:15] ^ a[..., 15:20] ^ a[..., 20:25]
        cn = c[..., d_next]
        d = c[..., d_prev] ^ ((cn << 1) | _shr(cn, 63))
        a = a ^ d[..., tile]
        r = (a << rho_t) | _shr(a, back_t)
        b = r[..., pi_t]
        a = b ^ (~b[..., chi1_t] & b[..., chi2_t])
        a[..., 0] ^= rc
    return a


def _sponge_plain(state, block, pad: bool, out_words: int):
    n, width = block.shape
    a = (
        torch.zeros((n, WIDTH), dtype=torch.int64, device=block.device)
        if state is None else state.clone()
    )
    full = width // RATE
    for ch in range(full):
        a[:, :RATE] ^= block[:, ch * RATE : (ch + 1) * RATE]
        a = permute(a)
    if pad:
        a[:, :RATE] ^= _pad_tail(block[:, full * RATE :])
        a = permute(a)
    return a[:, :out_words]


def _sponge_cuda(state, block, pad: bool, out_words: int):
    global LAUNCHES
    from . import cuda_lib

    if block.stride(-1) != 1:
        block = block.contiguous()
    tensors = (block,) if state is None else (block, state.contiguous())
    cuda_lib.require_cuda_u64("keccak", *tensors)
    n, width = block.shape
    if state is not None and tuple(state.shape) != (n, WIDTH):
        raise ValueError(f"keccak: state shape {tuple(state.shape)} != {(n, WIDTH)}")
    if not pad and width % RATE:
        raise ValueError("keccak: unpadded absorb needs a width multiple of RATE")
    st = None if state is None else tensors[1]
    out = torch.empty((n, out_words), dtype=torch.int64, device=block.device)
    with torch.cuda.device(block.device):
        err = cuda_lib.lib().starky_keccak_sponge(
            None if st is None else st.data_ptr(), block.data_ptr(), n, width,
            block.stride(0), int(pad), out.data_ptr(), out_words,
            cuda_lib.stream_of(block),
        )
    cuda_lib.check(err, "keccak")
    LAUNCHES += 1
    return out


def _sponge(state, block, pad: bool, out_words: int):
    """Absorb block [..., width] into state [..., 25] (None: zero state):
    floor(width / RATE) full chunks, then with `pad` the 10*1-padded tail
    block. Returns the first `out_words` lanes."""
    batch = tuple(block.shape[:-1])
    block2 = block.reshape(math.prod(batch), block.shape[-1])
    state2 = None if state is None else state.reshape(-1, WIDTH)
    if block.device.type == "cuda":
        out = _sponge_cuda(state2, block2, pad, out_words)
    elif block.device.type == "cpu":
        out = _sponge_plain(state2, block2, pad, out_words)
    else:
        raise ValueError(f"keccak: unsupported device {block.device}")
    return out.reshape(batch + (out_words,))


def _pad_tail(tail: torch.Tensor) -> torch.Tensor:
    """10*1 multi-rate padding at word granularity: tail [..., r], r < RATE
    -> one [..., RATE] final block (pad word 0x01, zeros, MSB of the last
    word set). Injective over word streams of any length."""
    *batch, r = tail.shape
    assert r < RATE
    block = torch.zeros((*batch, RATE), dtype=torch.int64, device=tail.device)
    block[..., :r] = tail
    block[..., r] ^= 1
    block[..., RATE - 1] ^= _signed(1 << 63)
    return block


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 4] digest (final-block 10*1 padding included)."""
    return _sponge(None, inputs, pad=True, out_words=DIGEST)


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 4]: values <= 4 wide are zero-padded, not hashed
    (the same leaf rule as poseidon.hash_or_noop; merkle.py relies on it)."""
    n = inputs.shape[-1]
    if n <= 4:
        return torch.nn.functional.pad(inputs, (0, 4 - n))
    return hash_no_pad(inputs)


def sponge_absorb(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Absorb a column block (width a multiple of RATE) into running sponge
    states: state [..., 25], block [..., k*RATE] -> new state. Chaining
    sponge_absorb over blocks + finalize(tail) equals hash_no_pad over the
    concatenated row (same XOR-chunk sequence)."""
    n = block.shape[-1]
    assert n % RATE == 0 and n > 0
    return _sponge(state, block, pad=False, out_words=WIDTH)


def finalize(state: torch.Tensor, tail: torch.Tensor | None = None) -> torch.Tensor:
    """Absorb the sub-rate tail (possibly zero-width) with padding and return
    the [..., 4] digests. Every hash_no_pad stream ends here."""
    if tail is None:
        tail = torch.zeros((*state.shape[:-1], 0), dtype=torch.int64, device=state.device)
    return _sponge(state, tail, pad=True, out_words=DIGEST)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one digest compression: [..., 4] x [..., 4] -> [..., 4]
    (8 words + padding fit one rate block: one permutation)."""
    return hash_no_pad(torch.cat([left, right], dim=-1))


# ---------------------------------------------------------------------------
# SHA3-256 on top of the permutation — exists ONLY so tests can pin the
# permutation against hashlib.


def sha3_256(data: bytes) -> bytes:
    rate_bytes = 136
    padded = bytearray(data)
    pad_len = rate_bytes - (len(padded) % rate_bytes)
    if pad_len == 1:
        padded += b"\x86"
    else:
        padded += b"\x06" + b"\x00" * (pad_len - 2) + b"\x80"
    state = torch.zeros((WIDTH,), dtype=torch.int64)
    for off in range(0, len(padded), rate_bytes):
        words = np.frombuffer(bytes(padded[off : off + rate_bytes]), dtype="<u8")
        state[: rate_bytes // 8] ^= xnp.to_torch(words)
        state = permute(state)
    return xnp.to_numpy(state[:4]).astype("<u8").tobytes()[:32]
