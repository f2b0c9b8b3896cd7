"""Sharded proving over a mesh of devices, driven by one process.

A `Mesh` is a tuple of torch devices, one per shard: the first d cards of a
host, one card d times (its shards then run one after another there), or
the CPU d times (the tests). As under `jax.shard_map`, one controller
places each shard's tensors on its device, runs each shard's step there and
moves data between shards itself. The collectives are plain functions over
the per-shard tensor list; each delivery is a `.to(device)` copy,
non-blocking between cards (a peer copy between two cards, no copy at all
between two shards of one device) and blocking to the host.

The trace's two parallel axes are its columns (independent polynomials for
the NTTs) and its rows (leaves, constraint evaluation, fold outputs):

  1. column-sharded INTT + coset LDE (K1 on each shard);
  2. all_to_all: column shards -> row blocks;
  3. row-sharded leaf hashing (K2 under keccak, K3 under Poseidon), the
     digests gathered to the first shard for the upper tree levels;
  4. row-sharded constraint composition: each block's `next` rows from the
     right neighbour by one cyclic ppermute (stark/composition.py);
  5. row-sharded arity-4 FRI folds (stark/fri.py).

Counters, module level like the kernels' LAUNCHES:
  CALLS[kind]        collective calls, by kind;
  BYTES[kind]        bytes delivered from one shard to another (all_to_all,
                     all_gather, ppermute: a shard's own block is not
                     counted) or between the shards and one device (scatter,
                     gather: every block); what a mesh of d cards would move;
  COPY_BYTES[kind]   the part of BYTES copied between two distinct devices
                     (0 on a one-card mesh);
  SHARD_LAUNCHES     one record per sharded commit: the K1 launches and the
                     leaf hasher's launches of each shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import ntt, poseidon
from ..hashing import get_hasher

AXIS = "shard"
KINDS = ("all_to_all", "all_gather", "ppermute", "scatter", "gather")
CALLS = dict.fromkeys(KINDS, 0)
BYTES = dict.fromkeys(KINDS, 0)
COPY_BYTES = dict.fromkeys(KINDS, 0)
SHARD_LAUNCHES: list[dict] = []


def reset_counters() -> None:
    for kind in KINDS:
        CALLS[kind] = BYTES[kind] = COPY_BYTES[kind] = 0
    SHARD_LAUNCHES.clear()


def canonical_device(device) -> torch.device:
    """torch.device(device), a CUDA device without an index made the
    current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = AXIS, device=None) -> Mesh:
    """A mesh of n_devices shards. Without `device`: the first n_devices CUDA
    cards (default: every card), raising when the host has fewer. With
    `device` (e.g. "cpu", or "cuda:0"): every shard on that one device."""
    if device is not None:
        return Mesh((canonical_device(device),) * (1 if n_devices is None else n_devices), axis)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = cards if n_devices is None else n_devices
    if n < 1 or n > cards:
        raise RuntimeError(f"make_mesh({n_devices}): {cards} CUDA card(s) on this host; name a "
                           f"device (make_mesh(n, device='cuda:0') or device='cpu') to put "
                           f"several shards on one")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def _deliver(kind: str, x: torch.Tensor, device: torch.device, counted: bool) -> torch.Tensor:
    nbytes = x.numel() * x.element_size()
    if counted:
        BYTES[kind] += nbytes
        if x.device != device:
            COPY_BYTES[kind] += nbytes
    # to the host a blocking copy: a non-blocking one returns a pinned
    # buffer before the card has filled it, and the host reads it at once
    return x.to(device, non_blocking=device.type != "cpu")


def all_to_all(mesh: Mesh, blocks: list[list]) -> list[list]:
    """blocks[i][j]: what shard i sends shard j (None: nothing). Returns
    recv with recv[j][i] = blocks[i][j] on shard j's device."""
    CALLS["all_to_all"] += 1
    d = mesh.size
    return [[None if blocks[i][j] is None else
             _deliver("all_to_all", blocks[i][j], mesh.devices[j], i != j) for i in range(d)]
            for j in range(d)]


def all_gather(mesh: Mesh, parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's part, concatenated along rows in shard order, on every
    shard's device."""
    CALLS["all_gather"] += 1
    return [torch.cat([_deliver("all_gather", p, dev, i != j) for i, p in enumerate(parts)])
            for j, dev in enumerate(mesh.devices)]


def ppermute(mesh: Mesh, parts: list[torch.Tensor], perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """perm: (source, destination) pairs, each shard at most once on either
    side. Shard j receives its source's part on its device; a shard that is
    no destination receives zeros."""
    CALLS["ppermute"] += 1
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in perm:
        out[dst] = _deliver("ppermute", parts[src], mesh.devices[dst], src != dst)
    return out


def scatter_rows(mesh: Mesh, x: torch.Tensor) -> "RowShards":
    """x's rows in mesh.size equal contiguous blocks, block k on shard k."""
    CALLS["scatter"] += 1
    d = mesh.size
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not split into {d} shards")
    local = x.shape[0] // d
    return RowShards(mesh, [_deliver("scatter", x[k * local : (k + 1) * local], dev, True)
                            for k, dev in enumerate(mesh.devices)])


def scatter_cols(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """x's columns in mesh.size equal contiguous blocks, block k on shard k
    (column views where the shard shares x's device)."""
    CALLS["scatter"] += 1
    w = x.shape[1] // mesh.size
    return [_deliver("scatter", x[:, k * w : (k + 1) * w], dev, True)
            for k, dev in enumerate(mesh.devices)]


def gather(mesh: Mesh, parts: list[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards' parts concatenated along `dim` on `device` (one part: no
    copy where it lies there)."""
    CALLS["gather"] += 1
    device = canonical_device(device)
    moved = [_deliver("gather", p, device, True) for p in parts]
    return moved[0] if len(moved) == 1 else torch.cat(moved, dim=dim)


class RowShards:
    """A matrix held as contiguous row blocks, block k on mesh.devices[k]:
    the LDE of a sharded commit. Its readers (xnp.on_device, xnp.row_blocks,
    xnp.take_rows) copy blocks from their shards to the reading device
    (counted as gathers) and compute there."""

    def __init__(self, mesh: Mesh, blocks: list[torch.Tensor]):
        self.mesh = mesh
        self.blocks = list(blocks)
        self.offsets = [0]
        for b in self.blocks:
            self.offsets.append(self.offsets[-1] + b.shape[0])
        self.shape = (self.offsets[-1],) + tuple(self.blocks[0].shape[1:])

    def rows(self, r0: int, r1: int, device) -> torch.Tensor:
        """Rows [r0, r1) on `device`."""
        parts = [b[max(r0 - o, 0) : min(r1 - o, b.shape[0])]
                 for b, o in zip(self.blocks, self.offsets) if o < r1 and o + b.shape[0] > r0]
        return gather(self.mesh, parts, device)

    def row_blocks(self, device, cells: int):
        """(r0, rows from r0 on `device`): each shard's block whole where it
        lies on `device`, else in pieces of about `cells` cells."""
        device = canonical_device(device)
        step = max(cells // max(self.blocks[0][0].numel(), 1), 1)  # rows of about `cells` cells
        for b, o in zip(self.blocks, self.offsets):
            if b.device == device:
                yield o, self.rows(o, o + b.shape[0], device)
                continue
            for r in range(0, b.shape[0], step):
                yield o + r, self.rows(o + r, o + min(r + step, b.shape[0]), device)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows idx (global indices, a CPU int64 tensor) on the host: each
        shard gives up the rows it holds."""
        CALLS["gather"] += 1
        out = torch.empty((idx.shape[0],) + self.shape[1:], dtype=self.blocks[0].dtype)
        for b, o in zip(self.blocks, self.offsets):
            mine = ((idx >= o) & (idx < o + b.shape[0])).nonzero().flatten()
            if mine.numel():
                out[mine] = _deliver("gather", b[(idx[mine] - o).to(b.device)], out.device, True)
        return out


def pad_cols(x: torch.Tensor, d: int) -> torch.Tensor:
    """x with zero columns appended up to a multiple of d."""
    pad = (-x.shape[1]) % d
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _row_shards_of_lde(mesh: Mesh, values: torch.Tensor, rate_bits: int) -> tuple[list, list]:
    """Steps 1-2: the coset LDE of `values` (columns padded to a multiple of
    the mesh size) as row blocks, block k on shard k, and each shard's K1
    launches."""
    d = mesh.size
    cols = scatter_cols(mesh, pad_cols(values, d))
    del values
    big_n = cols[0].shape[0] << rate_bits
    if big_n % d:
        raise ValueError(f"{big_n} LDE rows do not split into {d} shards")
    local = big_n // d
    blocks, k1 = [], []
    for j in range(d):
        before = ntt.LAUNCHES
        lde = ntt.lde_from_coeffs(ntt.interpolate_coeffs(cols[j]), rate_bits)
        cols[j] = None
        k1.append(ntt.LAUNCHES - before)
        blocks.append([lde[k * local : (k + 1) * local] for k in range(d)])
        del lde
    recv = all_to_all(mesh, blocks)
    del blocks
    return [torch.cat(recv[k], dim=1) for k in range(d)], k1


def _hash_rows(h, rows: list[torch.Tensor]) -> tuple[list, list]:
    """Step 3's leaf hashing, each shard on its device: digests and the
    hasher's launches per shard."""
    digests, launches = [], []
    for r in rows:
        before = h.LAUNCHES
        digests.append(h.hash_or_noop(r))
        launches.append(h.LAUNCHES - before)
    return digests, launches


def sharded_commit(mesh: Mesh, values: torch.Tensor, rate_bits: int, cap_height: int):
    """Distributed trace commitment of the dry run (the JAX package's
    sharded_commit): column shards, K1 INTT + LDE per shard, all_to_all to
    row shards, Poseidon leaves per row shard (hardwired, as there), a
    subtree per shard down to its root, an all_gather of the roots and the
    replicated top levels down to the cap.

    values: [n, C] (C padded to a multiple of the mesh size). Returns
    (lde RowShards [N, C_pad], {"leaf_digests": RowShards [N, 4],
    "subtree_roots": [d, 4], "cap": [<= 2^cap_height, 4]}), the last two on
    shard 0's device."""
    d = mesh.size
    big_n = values.shape[0] << rate_bits
    if big_n % d or big_n // d < (1 << cap_height) // d:
        raise ValueError(f"sharded_commit: {big_n} LDE rows, {d} shards, cap height {cap_height}")
    rows, k1 = _row_shards_of_lde(mesh, values, rate_bits)
    digests, leaf = _hash_rows(poseidon, rows)
    SHARD_LAUNCHES.append(dict(fn="sharded_commit", hasher="poseidon", k1=k1, leaf=leaf))
    roots = []
    for cur in digests:  # each shard's subtree down to its root
        while cur.shape[0] > 1:
            cur = poseidon.compress(cur[0::2], cur[1::2])
        roots.append(cur)
    gathered = all_gather(mesh, roots)
    tops = []
    for cur in gathered:  # the top levels, replicated
        while cur.shape[0] > (1 << cap_height):
            cur = poseidon.compress(cur[0::2], cur[1::2])
        tops.append(cur)
    return RowShards(mesh, rows), {"leaf_digests": RowShards(mesh, digests),
                                   "subtree_roots": gathered[0], "cap": tops[0]}


def sharded_commit_tree(mesh: Mesh, values, cfg):
    """The prove's commit over a mesh (the JAX package's
    sharded_commit_tree): a drop-in for `stark.prover.commit` whose LDE is a
    RowShards. Leaves are hashed by cfg.fri.merkle_hash (K2 under keccak, K3
    under Poseidon) on each row shard, after the NTT-only zero columns are
    sliced off, so every digest is the single-device commit's; the digests
    are gathered to shard 0's device, where the upper levels are built.

    values: [n, C] int64 tensor, or a 1-element list holding it, which this
    empties (the ownership form of `commit`)."""
    from ..merkle import MerkleTree, _upper_levels
    from ..stark.prover import Commitment

    if isinstance(values, list):
        if len(values) != 1:
            raise ValueError("sharded_commit_tree: the ownership form is a list of one matrix")
        values = values.pop()
    c = values.shape[1]
    big_n = values.shape[0] << cfg.fri.rate_bits
    rows, k1 = _row_shards_of_lde(mesh, values, cfg.fri.rate_bits)
    del values
    rows = [r[:, :c] for r in rows]  # drop the NTT-only zero padding before hashing
    h = get_hasher(cfg.fri.merkle_hash)
    digests, leaf = _hash_rows(h, rows)
    SHARD_LAUNCHES.append(dict(fn="sharded_commit_tree", hasher=cfg.fri.merkle_hash, k1=k1,
                               leaf=leaf))
    leaves = gather(mesh, digests, mesh.devices[0])
    cap_h = min(cfg.fri.cap_height, big_n.bit_length() - 1)
    levels = [leaves] + _upper_levels(leaves, cap_h, cfg.fri.merkle_hash)
    return Commitment(RowShards(mesh, rows), MerkleTree(levels=levels, cap_height=cap_h))


def with_halo(mesh: Mesh, blocks: list[torch.Tensor], pad: int) -> list[torch.Tensor]:
    """Each block followed by the first `pad` rows of its right neighbour
    (cyclic), received by one ppermute: the `next` rows of its last rows."""
    d = mesh.size
    heads = ppermute(mesh, [b[:pad] for b in blocks], [(i, (i - 1) % d) for i in range(d)])
    return [torch.cat([b, h]) for b, h in zip(blocks, heads)]


def sharded_composition(mesh: Mesh, eval_rows_fn, lde_rows, blowup: int) -> RowShards:
    """Row-sharded evaluation (the JAX package's sharded_composition): each
    shard calls eval_rows_fn(rows, next_rows) on its block, where next_rows
    is the block shifted by `blowup` rows, its tail from the right
    neighbour. lde_rows: a RowShards or a tensor (split into row shards)."""
    if isinstance(lde_rows, torch.Tensor):
        lde_rows = scatter_rows(mesh, lde_rows)
    haloed = with_halo(mesh, lde_rows.blocks, blowup)
    return RowShards(mesh, [eval_rows_fn(h[:-blowup], h[blowup:]) for h in haloed])


def sharded_fri_fold(mesh: Mesh, values, beta, w_m_inv: int, s_inv: int) -> RowShards:
    """Distributed arity-4 FRI fold (the JAX package's sharded_fri_fold):
    values [m, 2] (a RowShards, or a tensor split into row shards first).
    Shard k folds output rows j in [k q/d, (k+1) q/d), q = m/4: it receives
    v[j + t q], t = 0..3, by one all_to_all (each quarter's slice lies in one
    source shard) and takes its twiddles at its global j. Returns the [q, 2]
    output as a RowShards, equal to fri._fold_step4's."""
    from ..stark.fri import ARITY, _fold_quads

    if isinstance(values, torch.Tensor):
        values = scatter_rows(mesh, values)
    d = mesh.size
    m = values.shape[0]
    q = m // ARITY
    if q % d or [b.shape[0] for b in values.blocks] != [m // d] * d:
        raise ValueError(f"sharded_fri_fold: {m} rows in blocks "
                         f"{[b.shape[0] for b in values.blocks]} over {d} shards")
    qd = q // d
    blocks: list[list] = [[None] * d for _ in range(d)]
    for k in range(d):
        for t in range(ARITY):
            s = (t * d + k) // ARITY  # the shard holding rows t q + k qd ...
            o = t * q + k * qd - s * (m // d)
            piece = values.blocks[s][o : o + qd]
            blocks[s][k] = piece if blocks[s][k] is None else torch.cat([blocks[s][k], piece])
    recv = all_to_all(mesh, blocks)
    out = []
    for k in range(d):
        quads = torch.cat([p for p in recv[k] if p is not None])  # t order
        out.append(_fold_quads(*(quads[t * qd : (t + 1) * qd] for t in range(ARITY)), beta,
                               w_m_inv, s_inv, j0=k * qd, q=q))
    return RowShards(mesh, out)
