"""The port's Keccak (kernel K2's module) and Poseidon (kernel K3's module)
hashers against the JAX package, on the same numpy inputs, on the CPU.

The port runs its plain torch paths; the JAX side runs its XLA path and
its Pallas kernels in interpret mode. Tolerance: exact equality (digests
are bit strings). The CUDA kernels are held against the plain paths by the
`cuda`-marked tests, which skip without a card.
"""

import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starky_bn254_tpu import keccak as jkeccak
from starky_bn254_tpu import poseidon as jposeidon
from starky_bn254_tpu.pallas import keccak_kernel as jkk
from starky_bn254_tpu.pallas import poseidon_kernel as jpk
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch import keccak, merkle, poseidon, xnp

P = gl.P
CSRC = os.path.join(os.path.dirname(__file__), "..", "starky_bn254_tpu_torch", "csrc")

# one intra-op thread: test files run side by side in parallel workers, and
# torch's thread pool oversubscribes the cores (small ops get slower, not faster)
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _words(seed, shape, field=False):
    rng = np.random.default_rng(seed)
    hi = P if field else None
    if hi is None:
        return rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    return rng.integers(0, hi, shape, dtype=np.uint64)


def _t(a):
    return xnp.to_torch(a)


def _n(t):
    return xnp.to_numpy(t)


# -- Keccak ------------------------------------------------------------------


def test_keccak_kernel_tables_are_the_derived_constants():
    src = open(os.path.join(CSRC, "keccak.cu")).read()
    rc_block = src[src.index("KECCAK_RC[24] = {"): src.index("};", src.index("KECCAK_RC[24]"))]
    rcs = [int(h, 16) for h in re.findall(r"0x([0-9a-fA-F]+)ULL", rc_block)]
    assert tuple(rcs) == keccak._round_constants() == jkeccak._round_constants()
    rho = re.search(r"#define KECCAK_RHO \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in rho.split(",")) == keccak._rho_offsets()


@pytest.mark.parametrize("msg_len", [0, 3, 135, 136, 137, 300])
def test_sha3_256_matches_hashlib(msg_len):
    msg = bytes((7 * i + 1) % 256 for i in range(msg_len))
    assert keccak.sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_keccak_permute_matches_jax():
    st = _words(1, (37, 25))
    assert (_n(keccak.permute(_t(st))) == jkeccak.permute(st)).all()


@pytest.mark.parametrize("width", [5, 16, 17, 40, 55], ids=lambda w: f"w{w}")
def test_keccak_hash_no_pad_matches_jax(width):
    x = _words(2, (512, width))
    got = _n(keccak.hash_no_pad(_t(x)))
    assert (got == np.asarray(jkeccak._hash_no_pad_xla(jnp.asarray(x)))).all()
    assert (got == jkeccak.hash_no_pad(x)).all()  # the JAX numpy path


def test_keccak_sponge_absorb_matches_jax_and_pallas():
    st, blk = _words(3, (512, 25)), _words(4, (512, 3 * 17))
    got = _n(keccak.sponge_absorb(_t(st), _t(blk)))
    assert (got == np.asarray(jkeccak._sponge_absorb_xla(jnp.asarray(st), jnp.asarray(blk)))).all()
    pallas = jkk.sponge_absorb(jnp.asarray(st), jnp.asarray(blk), tile=512, interpret=True)
    assert (got == np.asarray(pallas)).all()


def test_keccak_stream_chains_to_hash_no_pad():
    x = _words(5, (512, 55))
    state = torch.zeros((512, 25), dtype=torch.int64)
    state = keccak.sponge_absorb(state, _t(x[:, :34]))
    got = _n(keccak.finalize(state, _t(x[:, 34:51])[:, :0]))  # zero-width tail
    assert (got == jkeccak.hash_no_pad(x[:, :34])).all()
    state = keccak.sponge_absorb(torch.zeros((512, 25), dtype=torch.int64), _t(x[:, :51]))
    assert (_n(keccak.finalize(state, _t(x[:, 51:]))) == jkeccak.hash_no_pad(x)).all()


def test_keccak_compress_matches_jax():
    left, right = _words(6, (64, 4)), _words(7, (64, 4))
    want = np.asarray(jkeccak.compress(jnp.asarray(left), jnp.asarray(right)))
    assert (_n(keccak.compress(_t(left), _t(right))) == want).all()
    assert (want == jkeccak.compress(left, right)).all()


# -- Poseidon ------------------------------------------------------------------


def test_poseidon_default_constants_pinned_and_equal():
    rc, mds = poseidon._constants()
    digest = hashlib.sha256(np.ascontiguousarray(rc).tobytes()).hexdigest()[:16]
    assert digest == "b670a8af60a7c56b"
    assert poseidon.FAST_MDS_ROW == (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
    jrc, jmds = jposeidon._constants()
    assert (rc == jrc).all() and (mds == jmds).all()
    assert poseidon._SEED == jposeidon._SEED


def test_poseidon_permute_matches_jax():
    st = _words(8, (100, 12), field=True)
    want = np.asarray(jposeidon.permute(jnp.asarray(st)))
    assert (_n(poseidon.permute(_t(st))) == want).all()


@pytest.mark.parametrize("width", [5, 8, 13, 40], ids=lambda w: f"w{w}")
def test_poseidon_hash_no_pad_matches_jax(width):
    x = _words(9, (512, width), field=True)
    got = _n(poseidon.hash_no_pad(_t(x)))
    assert (got == np.asarray(jposeidon._hash_no_pad_xla(jnp.asarray(x)))).all()


def test_poseidon_sponge_absorb_matches_jax_and_pallas():
    st, blk = _words(10, (512, 12), field=True), _words(11, (512, 24), field=True)
    got = _n(poseidon.sponge_absorb(_t(st), _t(blk)))
    assert (got == np.asarray(jposeidon._sponge_absorb_xla(jnp.asarray(st), jnp.asarray(blk)))).all()
    pallas = jpk.sponge_absorb(jnp.asarray(st), jnp.asarray(blk), tile=512, interpret=True)
    assert (got == np.asarray(pallas)).all()


def test_poseidon_compress_and_finalize_match_jax():
    left, right = _words(12, (64, 4), field=True), _words(13, (64, 4), field=True)
    want = np.asarray(jposeidon.compress(jnp.asarray(left), jnp.asarray(right)))
    assert (_n(poseidon.compress(_t(left), _t(right))) == want).all()
    st, tail = _words(14, (64, 12), field=True), _words(15, (64, 5), field=True)
    want = np.asarray(jposeidon.finalize(jnp.asarray(st), jnp.asarray(tail)))
    assert (_n(poseidon.finalize(_t(st), _t(tail))) == want).all()


@pytest.mark.parametrize(
    "mds_row,mds_diag",
    [((17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20), (8,) + (0,) * 11),
     ((1 << 40, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37), (0,) * 11 + (1 << 33,))],
    ids=["circ_diag_small", "dense"],
)
def test_params_from_jax_swap(mds_row, mds_diag):
    """A swapped parameter set installed in the JAX package carries over
    through params_from_jax: both packages then hash alike (including the
    host challenger permutation)."""
    from starky_bn254_tpu_torch.challenger import _permute_host

    n_rounds = jposeidon.FULL_ROUNDS + jposeidon.PARTIAL_ROUNDS
    rc = _words(16, (n_rounds, 12), field=True)
    try:
        jposeidon.set_params(rc_table=rc, mds_row=mds_row, mds_diag=mds_diag)
        jrc, _ = jposeidon._constants()
        poseidon.params_from_jax(jrc, jposeidon.FAST_MDS_ROW, jposeidon.MDS_DIAG)
        x = _words(17, (512, 20), field=True)
        want = np.asarray(jposeidon._hash_no_pad_xla(jnp.asarray(x)))
        assert (_n(poseidon.hash_no_pad(_t(x))) == want).all()
        st = [int(v) for v in x[0, :12]]
        assert _permute_host(st) == [int(v) for v in _n(poseidon.permute(_t(x[:1, :12])))[0]]
    finally:
        jposeidon.set_params(seed=jposeidon._DEFAULT_SEED, mds_row=poseidon.DEFAULT_MDS_ROW,
                             mds_diag=(0,) * 12)
        poseidon.set_params(seed=poseidon._DEFAULT_SEED, mds_row=poseidon.DEFAULT_MDS_ROW,
                            mds_diag=(0,) * 12)
    assert (poseidon._constants()[0] == jposeidon._constants()[0]).all()


DENSE_PARAMS = dict(mds_row=(1 << 40, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37),
                    mds_diag=(0,) * 11 + (1 << 33,))


def _restore_default_params():
    poseidon.set_params(seed=poseidon._DEFAULT_SEED, mds_row=poseidon.DEFAULT_MDS_ROW,
                        mds_diag=(0,) * 12)


@pytest.mark.parametrize(
    "mds_row,mds_diag,small",
    [(poseidon.DEFAULT_MDS_ROW, (0,) * 12, True),
     ((1 << 16,) * 12, (1 << 16,) * 12, True),
     (((1 << 16) + 1,) + (1,) * 11, (0,) * 12, False),
     (poseidon.DEFAULT_MDS_ROW, (0,) * 11 + ((1 << 16) + 1,), False),
     (DENSE_PARAMS["mds_row"], DENSE_PARAMS["mds_diag"], False)],
    ids=["default", "all_2^16", "row_above_2^16", "diag_above_2^16", "dense"],
)
def test_poseidon_kernel_mds_form_follows_mds_layer(mds_row, mds_diag, small, monkeypatch):
    """K3 takes the small-constant MDS exactly when _mds_layer does: the
    wrapper's flag is _small_mds(), and _mds_layer takes its dense matvec
    (the only path reading the "mds" table) exactly when it is False."""
    try:
        poseidon.set_params(mds_row=mds_row, mds_diag=mds_diag)
        assert poseidon._small_mds() is small
        read = []
        table = poseidon._table
        monkeypatch.setattr(poseidon, "_table", lambda name, dev: read.append(name) or table(name, dev))
        poseidon._mds_layer(_t(_words(23, (4, 12), field=True)))
        assert ("mds" in read) is (not small)
    finally:
        monkeypatch.undo()
        _restore_default_params()


@pytest.mark.parametrize("rows", [1, 27, poseidon.COOP_MAX_ROWS, poseidon.COOP_MAX_ROWS + 1, 131072])
def test_poseidon_sponge_form_by_rows(rows):
    """The challenger's digests (1 to 27 rows) and the compress levels run
    one state per 16 lanes; batches above COOP_MAX_ROWS one per thread."""
    want = "coop" if rows <= poseidon.COOP_MAX_ROWS else "row"
    assert poseidon._sponge_form(rows) == want
    assert 27 <= poseidon.COOP_MAX_ROWS


# -- Merkle ------------------------------------------------------------------


@pytest.mark.parametrize("hasher", ["poseidon", "keccak"])
def test_merkle_tree_matches_jax(hasher):
    from starky_bn254_tpu import merkle as jmerkle

    leaves = _words(18, (256, 21), field=True)
    tree = merkle.build_merkle_tree(_t(leaves), 2, hasher)
    jtree = jmerkle.build_merkle_tree(jnp.asarray(leaves), 2, hasher)
    assert len(tree.levels) == len(jtree.levels)
    for a, b in zip(tree.levels, jtree.levels):
        assert (_n(a) == np.asarray(b)).all()
    idx = [0, 5, 77, 255]
    paths = tree.prove_batch(idx)
    assert (_n(paths) == np.asarray(jtree.prove_batch(idx))).all()
    for q, i in enumerate(idx):
        assert merkle.verify_merkle_proof(leaves[i], i, _n(paths[q]), _n(tree.cap), hasher)
    assert not merkle.verify_merkle_proof(leaves[1], 0, _n(paths[0]), _n(tree.cap), hasher)


# -- the kernels against their plain versions (need a card) ------------------


@pytest.mark.cuda
def test_keccak_kernel_matches_plain(cuda_device):
    for width in (1, 5, 17, 34, 812):
        x = _t(_words(19, (1000, width)))
        assert torch.equal(keccak.hash_no_pad(x.to(cuda_device)).cpu(), keccak.hash_no_pad(x))
    st, blk = _t(_words(20, (700, 25))), _t(_words(21, (700, 51)))
    got = keccak.sponge_absorb(st.to(cuda_device), blk.to(cuda_device)).cpu()
    assert torch.equal(got, keccak.sponge_absorb(st, blk))


@pytest.mark.cuda
def test_poseidon_kernel_matches_plain(cuda_device, monkeypatch):
    """Both K3 layouts against the plain version, on the card: the public
    hash_no_pad at 300 rows of widths 5 (one partial chunk), 8, 40 and 812
    against the CPU path; the grind at 6 and 10 bits (the 1024-row batch
    floor, many hits) against the CPU; rows 1, 27, 4096 and 131072, widths
    8, 64, 128 and 812, out_words 4 and 12, with and without an input
    state, under the default and a dense-MDS parameter set against
    _sponge_plain; and the grind at 16 bits from two seeds against
    _grind_plain."""
    for coop_max in (poseidon.COOP_MAX_ROWS, 0):  # 300 rows: coop layout, then row
        monkeypatch.setattr(poseidon, "COOP_MAX_ROWS", coop_max)
        for width in (5, 8, 40, 812):
            x = _t(_words(22, (300, width), field=True))
            got = poseidon.hash_no_pad(x.to(cuda_device)).cpu()
            assert torch.equal(got, poseidon.hash_no_pad(x)), (coop_max, width)
    monkeypatch.undo()
    for bits in (6, 10):
        seed = 0xABCDEF123
        batch, thr, start = 1 << max(bits + 2, 10), 1 << (64 - bits), (seed >> 24) & 0xFFFFFFFF
        assert (poseidon.grind_batch(seed, start, batch, thr, cuda_device)
                == poseidon.grind_batch(seed, start, batch, thr, "cpu"))
    try:
        for params in ("default", "dense"):
            if params == "dense":
                poseidon.set_params(**DENSE_PARAMS)
            for rows, widths in ((1, (8, 64, 128, 812)), (27, (8, 64, 128, 812)),
                                 (4096, (8, 128)), (131072, (64,))):
                for width in widths:
                    blk = _t(_words(22, (rows, width), field=True)).to(cuda_device)
                    st = _t(_words(24, (rows, 12), field=True)).to(cuda_device)
                    for state, out_words in ((None, 4), (st, 12), (st, 4)):
                        want = poseidon._sponge_plain(state, blk, out_words)
                        for form in ("coop", "row"):
                            got = poseidon._sponge_cuda(state, blk, out_words, form)
                            assert torch.equal(got, want), (params, rows, width, out_words, form)
            for seed in (0x1234_5678_9ABC, 0x0F0F_F0F0_1234_5678):
                batch, thr, start = 1 << 18, 1 << 48, (seed >> 24) & 0xFFFFFFFF
                assert (poseidon.grind_batch(seed, start, batch, thr, cuda_device)
                        == poseidon._grind_plain(seed, start, batch, thr, cuda_device))
    finally:
        _restore_default_params()
