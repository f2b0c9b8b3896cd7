"""Duplex Fiat-Shamir challenger over the Poseidon sponge, on the host.

Overwrite-mode duplex: observed elements fill the rate portion and trigger
permutations; challenges pop from the end of the squeezed rate window. The
duplex runs with exact Python-int Poseidon; vectors of at least
VECTOR_OBSERVE_MIN elements are observed as their length plus a batched
Poseidon tree digest, exactly as the JAX package's challenger does. The
tree digest runs through poseidon.py on the challenger's `device` (the
prover passes its own, so on a card it is kernel K3; the verifier hashes on
the CPU): the digest is the same word for word on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon, xnp

VECTOR_OBSERVE_MIN = 128
_LEAF_WIDTH = 128  # elements per tree leaf (16 sponge chunks)


def _permute_host(state: list[int]) -> list[int]:
    """Pure-Python Poseidon permutation (matches poseidon.permute)."""
    rc, mds = poseidon._constants()
    p = gl.P
    w = poseidon.WIDTH
    half = poseidon.FULL_ROUNDS // 2
    mds_i = [[int(mds[i, j]) for j in range(w)] for i in range(w)]

    def sbox(x):
        x2 = x * x % p
        x4 = x2 * x2 % p
        return x4 * x2 % p * x % p

    def mds_layer(s):
        return [sum(mds_i[i][j] * s[j] for j in range(w)) % p for i in range(w)]

    r = 0
    s = list(state)
    for _ in range(half):
        s = [(x + int(rc[r][i])) % p for i, x in enumerate(s)]
        s = [sbox(x) for x in s]
        s = mds_layer(s)
        r += 1
    for _ in range(poseidon.PARTIAL_ROUNDS):
        s = [(x + int(rc[r][i])) % p for i, x in enumerate(s)]
        s[0] = sbox(s[0])
        s = mds_layer(s)
        r += 1
    for _ in range(half):
        s = [(x + int(rc[r][i])) % p for i, x in enumerate(s)]
        s = [sbox(x) for x in s]
        s = mds_layer(s)
        r += 1
    return s


def _hash_vector_tree(xs: np.ndarray, device=None) -> np.ndarray:
    """[n] u64 -> [4] digest: leaf sponges over 128-element rows, then a
    binary compress tree (an odd level gets one zero digest appended)."""
    n = xs.size
    m = -(-n // _LEAF_WIDTH)
    mat = np.zeros((m, _LEAF_WIDTH), dtype=np.uint64)
    mat.reshape(-1)[:n] = xs
    d = poseidon.hash_no_pad(xnp.to_torch(mat, device))  # [m, 4]
    while d.shape[0] > 1:
        if d.shape[0] % 2:
            d = torch.cat([d, torch.zeros((1, 4), dtype=torch.int64, device=d.device)])
        d = poseidon.compress(d[0::2], d[1::2])
    return xnp.to_numpy(d[0])


class Challenger:
    """device: where vector tree digests are hashed (None: the CPU)."""

    def __init__(self, device=None):
        self.device = device
        self.state = [0] * poseidon.WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing ----------------------------------------------------------
    def observe_element(self, x: int):
        assert 0 <= x < gl.P
        self.output_buffer = []
        self.input_buffer.append(int(x))
        if len(self.input_buffer) == poseidon.RATE:
            self._duplex()

    def observe_elements(self, xs):
        xs = xnp.to_numpy(xs).reshape(-1)
        if xs.size >= VECTOR_OBSERVE_MIN:
            # the length first (vectors of different lengths never alias),
            # then the 4-element tree digest
            self.observe_element(xs.size % gl.P)
            for d in _hash_vector_tree(xs, self.device):
                self.observe_element(int(d))
            return
        for x in xs:
            self.observe_element(int(x))

    def observe_cap(self, cap):
        # digest words are reduced mod p before observing: a no-op for
        # Poseidon caps and the (lossy) embedding of Keccak words >= p; the
        # JAX package's challenger does the same, and transcripts must match
        self.observe_elements(xnp.to_numpy(cap) % np.uint64(gl.P))

    # -- squeezing ----------------------------------------------------------
    def _duplex(self):
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.state = _permute_host(self.state)
        self.input_buffer = []
        self.output_buffer = list(self.state[: poseidon.RATE])

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self) -> tuple[int, int]:
        return (self.get_challenge(), self.get_challenge())

    def get_indices(self, n_queries: int, domain_size: int) -> list[int]:
        assert domain_size & (domain_size - 1) == 0
        return [self.get_challenge() & (domain_size - 1) for _ in range(n_queries)]
