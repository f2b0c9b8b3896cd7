"""The port's sharded pieces (starky_bn254_tpu_torch/parallel/sharded.py) on
the CPU: the collectives against hand-built expectations, make_mesh's
refusal of a host with too few cards, and sharded_commit,
sharded_commit_tree, sharded_composition and sharded_fri_fold against the
JAX package's on its 8-device CPU mesh (tests/conftest.py) and against the
port's single-device functions. All arithmetic is exact mod p: every
comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starky_bn254_tpu import goldilocks as jgl
from starky_bn254_tpu.parallel import sharded as jsharded
from starky_bn254_tpu_torch import ntt, xnp
from starky_bn254_tpu_torch.parallel import sharded
from starky_bn254_tpu_torch.stark import FriConfig, StarkConfig
from starky_bn254_tpu_torch.stark.fri import _fold_step4
from starky_bn254_tpu_torch.stark.prover import commit

torch.set_num_threads(1)

SIZES = [1, 2, 4, 8]


def host(x) -> np.ndarray:
    """A tensor or RowShards as a numpy uint64 array."""
    return xnp.to_numpy(xnp.on_device(x, "cpu"))


@pytest.mark.parametrize("d", SIZES)
def test_collectives_match_hand_built_expectations(d):
    mesh = sharded.make_mesh(d, device="cpu")
    assert mesh.size == d and mesh.devices == (torch.device("cpu"),) * d
    sharded.reset_counters()
    blocks = [[torch.full((2, 3), 100 * i + j) for j in range(d)] for i in range(d)]
    recv = sharded.all_to_all(mesh, blocks)
    assert all(torch.equal(recv[j][i], torch.full((2, 3), 100 * i + j))
               for i in range(d) for j in range(d))
    parts = [torch.arange(3) + 10 * i for i in range(d)]
    gathered = sharded.all_gather(mesh, parts)
    assert len(gathered) == d
    assert all(torch.equal(g, torch.tensor([10 * i + k for i in range(d) for k in range(3)]))
               for g in gathered)
    left = sharded.ppermute(mesh, parts, [(i, (i - 1) % d) for i in range(d)])
    assert all(torch.equal(left[(i - 1) % d], parts[i]) for i in range(d))
    if d > 1:  # a shard that is no destination receives zeros
        one = sharded.ppermute(mesh, parts, [(0, 1)])
        assert torch.equal(one[1], parts[0])
        assert all(not one[j].any() for j in range(d) if j != 1)
    assert torch.equal(sharded.gather(mesh, parts, "cpu"), torch.cat(parts))
    word = 8  # int64
    assert sharded.CALLS == dict(all_to_all=1, all_gather=1, ppermute=1 + (d > 1), scatter=0,
                                 gather=1)
    assert sharded.BYTES == dict(all_to_all=(d * d - d) * 6 * word,
                                 all_gather=d * (d - 1) * 3 * word,
                                 ppermute=(d + 1) * 3 * word if d > 1 else 0, scatter=0,
                                 gather=d * 3 * word)
    assert sharded.COPY_BYTES == dict.fromkeys(sharded.KINDS, 0)  # one device: no copies

    # a matrix in row shards and its readers
    x = torch.arange(8 * d * 3, dtype=torch.int64).reshape(8 * d, 3)
    rs = sharded.scatter_rows(mesh, x)
    assert rs.shape == (8 * d, 3) and [b.shape[0] for b in rs.blocks] == [8] * d
    assert torch.equal(xnp.on_device(rs, "cpu"), x)
    assert torch.equal(rs.rows(3, 8 * d - 2, "cpu"), x[3 : 8 * d - 2])
    pieces = list(xnp.row_blocks(rs, "cpu", 6))
    assert [r0 for r0, _ in pieces] == [8 * k for k in range(d)]  # whole blocks: they lie there
    assert torch.equal(torch.cat([p for _, p in pieces]), x)
    idx = torch.tensor([8 * d - 1, 0, 5, 8 * d // 2, 5])
    assert torch.equal(xnp.take_rows(rs, idx), x[idx])


def test_make_mesh_without_enough_cards_raises(monkeypatch):
    """Without a device named, the shards are cards; a host with fewer cards
    refuses (never a quiet fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 CUDA card"):
        sharded.make_mesh(2)
    with pytest.raises(RuntimeError, match="0 CUDA card"):
        sharded.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="2 CUDA card"):
        sharded.make_mesh(4)
    assert sharded.make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3


def test_shapes_that_do_not_split_over_the_mesh_are_refused():
    mesh = sharded.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="do not split into 4 shards"):
        sharded.scatter_rows(mesh, torch.zeros((6, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="sharded_commit:"):  # 8 LDE rows under a cap of 16
        sharded.sharded_commit(mesh, torch.zeros((4, 4), dtype=torch.int64), 1, 4)
    with pytest.raises(ValueError, match="sharded_fri_fold:"):  # q = 8 does not split 16 ways
        sharded.sharded_fri_fold(sharded.make_mesh(16, device="cpu"),
                                 torch.zeros((32, 2), dtype=torch.int64), (1, 1), 1, 1)
    with pytest.raises(ValueError, match="sharded_fri_fold:"):  # blocks of unequal height
        sharded.sharded_fri_fold(mesh, sharded.RowShards(mesh, [torch.zeros((r, 2), dtype=torch.int64)
                                                                for r in (8, 8, 8, 40)]),
                                 (1, 1), 1, 1)


def test_sharded_commit_matches_jax():
    """tests/test_parallel.py's statement: a [64, 16] trace from
    default_rng(21), rate bits 1, cap height 1, over 8 shards."""
    rng = np.random.default_rng(21)
    trace = rng.integers(0, 1 << 16, size=(64, 16), dtype=np.uint64)
    j_lde, j_tree = jsharded.sharded_commit(jsharded.make_mesh(8), jnp.asarray(trace), 1, 1)
    lde, tree = sharded.sharded_commit(sharded.make_mesh(8, device="cpu"), xnp.to_torch(trace), 1, 1)
    assert np.array_equal(host(lde), np.asarray(j_lde))
    assert np.array_equal(host(lde), xnp.to_numpy(ntt.coset_lde(xnp.to_torch(trace), 1)))
    assert np.array_equal(host(tree["leaf_digests"]), np.asarray(j_tree["leaf_digests"]))
    assert np.array_equal(xnp.to_numpy(tree["subtree_roots"]), np.asarray(j_tree["subtree_roots"]))
    assert np.array_equal(xnp.to_numpy(tree["cap"]), np.asarray(j_tree["cap"]))


@pytest.mark.parametrize("hasher", ["keccak", "poseidon"])
def test_sharded_commit_tree_equals_the_single_commit(hasher):
    """13 columns over 4 shards: padded to 16 for the NTTs, the padding
    sliced off before the leaves are hashed, so every level is the single
    commit's; the ownership form is emptied."""
    base = StarkConfig.test_config().fri
    cfg = StarkConfig(num_challenges=2, fri=FriConfig(
        rate_bits=base.rate_bits, cap_height=2, proof_of_work_bits=base.proof_of_work_bits,
        num_query_rounds=base.num_query_rounds, final_poly_bits=base.final_poly_bits,
        merkle_hash=hasher))
    values = xnp.to_torch(np.random.default_rng(3).integers(0, 1 << 63, size=(128, 13),
                                                            dtype=np.uint64))
    want = commit(values.clone(), cfg)
    sharded.reset_counters()
    holder = [values]
    got = sharded.sharded_commit_tree(sharded.make_mesh(4, device="cpu"), holder, cfg)
    assert holder == []
    (rec,) = sharded.SHARD_LAUNCHES
    assert rec["hasher"] == hasher and len(rec["k1"]) == len(rec["leaf"]) == 4
    assert sharded.CALLS["all_to_all"] == 1 and sharded.CALLS["gather"] == 1
    assert sharded.BYTES["all_to_all"] == 256 * 16 * 8 * 3 // 4  # 12 of 16 blocks change shard
    assert isinstance(got.lde, sharded.RowShards) and got.lde.shape == (256, 13)
    assert [b.shape for b in got.lde.blocks] == [(64, 13)] * 4
    assert torch.equal(xnp.on_device(got.lde, "cpu"), want.lde)
    assert got.tree.cap_height == want.tree.cap_height
    assert len(got.tree.levels) == len(want.tree.levels)
    assert all(torch.equal(a, b) for a, b in zip(got.tree.levels, want.tree.levels))


def test_sharded_composition_matches_jax():
    """tests/test_parallel.py's boundary rows: the next-row difference over
    8 shards, the last rows wrapping to the first."""
    n, blowup = 64, 2
    rows = np.arange(n, dtype=np.uint64)[:, None] * np.ones((1, 3), dtype=np.uint64)

    def eval_rows(lv, nv):
        return nv[:, 0] - lv[:, 0]

    want = np.asarray(jsharded.sharded_composition(jsharded.make_mesh(8), eval_rows,
                                                   jnp.asarray(rows), blowup))
    got = sharded.sharded_composition(sharded.make_mesh(8, device="cpu"), eval_rows,
                                      xnp.to_torch(rows), blowup)
    assert np.array_equal(host(got), want)
    with np.errstate(over="ignore"):
        assert np.array_equal(want, np.roll(np.arange(n, dtype=np.uint64), -blowup)
                              - np.arange(n, dtype=np.uint64))


@pytest.mark.parametrize("d", SIZES)
def test_sharded_fri_fold_matches_jax_and_the_single_fold(d):
    """tests/test_parallel.py's fold: m = 1024 values from default_rng(6);
    each shard folds its output rows at its global offset."""
    m = 1 << 10
    values = np.random.default_rng(6).integers(0, 2**63, size=(m, 2)).astype(np.uint64)
    beta = (12345, 67890)
    w_m_inv = pow(jgl.primitive_root_of_unity(10), jgl.P - 2, jgl.P)
    s_inv = pow(jgl.GENERATOR, jgl.P - 2, jgl.P)
    want = np.asarray(jsharded.sharded_fri_fold(jsharded.make_mesh(d), jnp.asarray(values), beta,
                                                w_m_inv, s_inv))
    got = sharded.sharded_fri_fold(sharded.make_mesh(d, device="cpu"), xnp.to_torch(values), beta,
                                   w_m_inv, s_inv)
    assert got.shape == (m // 4, 2) and len(got.blocks) == d
    assert np.array_equal(host(got), want)
    assert np.array_equal(want, xnp.to_numpy(_fold_step4(xnp.to_torch(values), beta, w_m_inv,
                                                         s_inv)))


@pytest.mark.cuda
def test_shard_rows_read_on_the_host_are_the_tensors():
    """Rows of shards on the card brought to the host (xnp.on_device, and
    xnp.take_rows, FRI's query rows) are read there at once, so each copy
    must have landed first. Each read follows a sleep of ~10 ms queued on
    the card: a copy that did not wait for it would leave its host buffer
    unfilled when the blocks are concatenated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the shards lie on it")
    dev = torch.device("cuda", 0)
    mesh = sharded.make_mesh(4, device=dev)
    rng = np.random.default_rng(11)
    base = xnp.to_torch(rng.integers(0, 1 << 62, size=(1 << 12, 64), dtype=np.uint64), dev)
    for r in range(10):
        x = base + r
        want = x.cpu()
        rs = sharded.scatter_rows(mesh, x)
        torch.cuda._sleep(20_000_000)
        assert torch.equal(xnp.on_device(rs, "cpu"), want), f"round {r}"
        idx = torch.from_numpy(rng.integers(0, x.shape[0], size=84))
        torch.cuda._sleep(20_000_000)
        assert torch.equal(xnp.take_rows(rs, idx), want[idx]), f"round {r}"
