"""Merkle tree with cap and batched leaf hashing.

Leaves are the rows of a [n_leaves, width] matrix (one leaf per LDE-domain
point, all committed columns at that point), hashed with the configured
hasher (hashing.py); internal levels are batched two-to-one compressions.
The tree stops `cap_height` levels early, leaving 2^cap_height digests (the
commitment). Every level stays on the leaves' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import xnp
from .hashing import get_hasher


@dataclass
class MerkleTree:
    """levels[0]: leaf digests [n, 4]; levels[-1]: cap [2^cap_height, 4]."""

    levels: list[torch.Tensor]
    cap_height: int

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    def prove_batch(self, indices) -> torch.Tensor:
        """Sibling paths of many leaves: [Q, depth, 4] (depth stops at the cap)."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.cap.device)
        return sibling_paths(idx, self.levels[:-1])


def sibling_paths(idx: torch.Tensor, levels) -> torch.Tensor:
    """[Q, len(levels), 4] sibling digests of leaves `idx` over `levels`."""
    if not levels:
        return torch.zeros((idx.shape[0], 0, 4), dtype=torch.int64, device=idx.device)
    sibs = []
    for level in levels:
        sibs.append(level[idx ^ 1])
        idx = idx >> 1
    return torch.stack(sibs, dim=1)


def _upper_levels(digests: torch.Tensor, cap_height: int, hasher: str = "poseidon"):
    h = get_hasher(hasher)
    levels = [digests]
    while levels[-1].shape[0] > (1 << cap_height):
        cur = levels[-1]
        levels.append(h.compress(cur[0::2], cur[1::2]))
    return levels[1:]


def build_merkle_tree(leaves: torch.Tensor, cap_height: int, hasher: str = "poseidon") -> MerkleTree:
    """leaves: [n, width]; n a power of two >= 2^cap_height."""
    n = leaves.shape[0]
    assert n & (n - 1) == 0
    assert 1 << cap_height <= n
    digests = get_hasher(hasher).hash_or_noop(leaves)
    return MerkleTree(levels=[digests] + _upper_levels(digests, cap_height, hasher),
                      cap_height=cap_height)


def verify_merkle_proof(leaf_data, index: int, path, cap, hasher: str = "poseidon") -> bool:
    """Check one leaf (raw row values) against a cap, on the host."""
    h = get_hasher(hasher)
    digest = h.hash_or_noop(xnp.to_torch(leaf_data))
    path = xnp.to_torch(path)
    idx = index
    for i in range(path.shape[0]):
        sib = path[i]
        digest = h.compress(sib, digest) if idx & 1 else h.compress(digest, sib)
        idx >>= 1
    return bool((xnp.to_numpy(digest) == xnp.to_numpy(cap)[idx]).all())
